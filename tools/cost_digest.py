#!/usr/bin/env python3
"""Compare the sampling kernels' outputs of two checkouts bit for bit on one card.

    python3 tools/cost_digest.py TREE_A TREE_B

For each TREE (the root of a checkout of this repository), in a process of its
own, imports that tree's ``quadruped_pympc_tamols_torch``, runs kernels K1a, K1b,
K1c and K1e (each method) once at N = 10 000 on the card, on numpy noise from a
seed and on Philox noise, and keeps every output; K1b and K1c also at temperature
1e6 (every weight nonzero) and on a NaN state (every cost tied at 1e6); for
each parametrization, K1a and K1e's random sampling on Philox noise and three
chained iterations of each method through ``sampling_chain`` (K1d); and K1f,
each method in both layouts, for 4 scenarios of 1000 samples on numpy noise and
on Philox noise. Every configuration has the sampling knobs' defaults (no
ZMP-band cost, 10 CEM elites). Then prints, for each output, whether the two
trees' bits are equal, and where they are not, how many elements differ and the
largest absolute difference. Exits 1 if any output differs.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

N = 10_000


def run_tree(path: str) -> None:
    """Child: this tree's outputs into the .npz named by argv[3]."""
    import torch
    from quadruped_pympc_tamols_torch import make_config
    from quadruped_pympc_tamols_torch.controllers.sampling import group_operators
    from quadruped_pympc_tamols_torch.controllers.sampling.rollout import gravity_share
    from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    dev = torch.device("cuda:0")
    base = {"sim.visual_foothold_adaptation": "blind"}
    cfg = make_config("aliengo", mpc_type="sampling", **base)
    H = cfg.mpc.horizon
    state12 = np.zeros(12, np.float32)
    state12[2], state12[3] = cfg.sim.ref_z - 0.03, 0.1
    ref12 = np.zeros(12, np.float32)
    ref12[2], ref12[3] = cfg.sim.ref_z, 0.2
    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]],
                    np.float32)
    seq = np.ones((4, H), np.float32)
    seq[1, 6:] = seq[2, 6:] = 0.0
    share = gravity_share(torch.from_numpy(seq), cfg.robot.mass)[:, None].expand(H, 4).numpy()
    tick = sk.TickInputs(state12, feet, ref12, seq, np.ascontiguousarray(share))

    plan = sk.make_rs_plan(cfg, N, dev)
    P = plan.num_parameters
    rng = np.random.default_rng(0)
    inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
    sigma = torch.as_tensor(rng.uniform(0.3, 4.0, P).astype(np.float32), device=dev)
    noise = torch.as_tensor((rng.standard_normal((P, N)) * 3.0).astype(np.float32), device=dev)
    noise[:, 0] = 0.0
    res = {}

    def keep(name, tensors):
        for j, x in enumerate(tensors):
            if x is not None:
                res[f"{name}[{j}]"] = x.detach().cpu().numpy()

    nan_tick = tick._replace(state12=np.full(12, np.nan, np.float32))
    for label, kw in (("numpy noise", {"noise_in": noise}), ("philox", {})):
        keep(f"K1a {label}", sk.sampling_rs(plan, tick, inc, 3, 1, **kw))
        for method in ("mppi", "cem_mppi"):
            knobs = sm.make_knobs(cfg, method)
            keep(f"{method} {label}",
                 sm.softmax_iteration(plan, knobs, tick, inc, sigma, 3, 1, **kw))
            hot = dataclasses.replace(knobs, temperature=1e6)
            keep(f"{method} T=1e6 {label}",
                 sm.softmax_iteration(plan, hot, tick, inc, sigma, 3, 1, **kw))
            keep(f"{method} NaN state {label}",
                 sm.softmax_iteration(plan, knobs, nan_tick, inc, sigma, 3, 1, **kw))
    gcfg = make_config("aliengo", mpc_type="sampling",
                       **{**base, "mpc.optimize_step_freq": True,
                          "mpc.step_freq_available": (2.4, 1.3, 2.0)})
    gplan = sg.make_group_plan(gcfg, N, dev)
    groups = group_operators(gcfg, np.array([0.3, 0.8, 0.8, 0.3], np.float32),
                             np.asarray(gcfg.mpc.step_freq_available, np.float32))
    gnoise = noise[:, :gplan.num_used].contiguous()
    for label, kw in (("numpy noise", {"noise_in": gnoise}), ("philox", {})):
        for method in ("random_sampling", "mppi", "cem_mppi"):
            knobs = sm.make_knobs(gcfg, method)
            keep(f"K1e {method} {label}",
                 sg.sampling_groups(gplan, knobs, tick, groups, inc, sigma, 3, 1, **kw))
    for par in ("cubic_spline", "linear_spline", "zero_order"):
        over = {**base, "mpc.sampling.parametrization": par}
        pcfg = make_config("aliengo", mpc_type="sampling", **over)
        pplan = sk.make_rs_plan(pcfg, N, dev)
        prng = np.random.default_rng(1)
        pinc = torch.as_tensor(prng.standard_normal(pplan.num_parameters).astype(np.float32),
                               device=dev)
        psigma = torch.as_tensor(prng.uniform(0.3, 4.0, pplan.num_parameters).astype(np.float32),
                                 device=dev)
        keep(f"K1a {par} philox", sk.sampling_rs(pplan, tick, pinc, 3, 1))
        for method in ("random_sampling", "mppi", "cem_mppi"):
            knobs = sm.make_knobs(pcfg, method)
            keep(f"K1d {method} x 3 {par}",
                 [x for r in sm.sampling_chain(pplan, knobs, tick, pinc, psigma, 3, 1, 3)
                  for x in r])
        pgcfg = make_config("aliengo", mpc_type="sampling",
                            **{**over, "mpc.optimize_step_freq": True,
                               "mpc.step_freq_available": (2.4, 1.3, 2.0)})
        pgplan = sg.make_group_plan(pgcfg, N, dev)
        pgroups = group_operators(pgcfg, np.array([0.3, 0.8, 0.8, 0.3], np.float32),
                                  np.asarray(pgcfg.mpc.step_freq_available, np.float32))
        keep(f"K1e random_sampling {par} philox",
             sg.sampling_groups(pgplan, sm.make_knobs(pgcfg, "random_sampling"), tick, pgroups,
                                pinc, psigma, 3, 1))
    fleet_outputs(cfg, tick, keep, dev)
    torch.cuda.synchronize()
    np.savez(sys.argv[3], **res)


def fleet_outputs(cfg, tick, keep, dev, S=4, n=1000) -> None:
    """K1f's outputs, each method in both layouts, on numpy noise and on Philox."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    plan = sk.make_rs_plan(cfg, n, dev)
    P = plan.num_parameters
    rng = np.random.default_rng(2)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    def rows(x):
        return np.repeat(x[None], S, 0)

    ftick = fl.FleetTick(t(rows(tick.state12) + 0.01 * rng.standard_normal((S, 12))),
                         t(rows(tick.feet)), t(rows(tick.ref12)), t(rows(tick.contact_seq)),
                         t(rows(tick.share)))
    inc = t(rng.standard_normal((S, P)))
    sigma = t(rng.uniform(0.3, 4.0, (S, P)))
    noise = t(rng.standard_normal((S, P, n)) * 3.0)
    noise[:, :, 0] = 0.0
    seeds = torch.arange(S, dtype=torch.int64, device=dev) + 3
    offsets = torch.arange(S, dtype=torch.int64, device=dev)
    for method in sm.METHODS:
        knobs = sm.make_knobs(cfg, method)
        for layout in (fl.FOUR_LANE, fl.LARGE_BATCH):
            keep(f"K1f {method} layout {layout} numpy noise",
                 fl.fleet_iteration(plan, knobs, ftick, inc, sigma, seeds, offsets,
                                    noise_in=noise, layout=layout))
            keep(f"K1f {method} layout {layout} philox",
                 fl.fleet_iteration(plan, knobs, ftick, inc, sigma, seeds, offsets,
                                    layout=layout))


def run_child(tree: str, out: str) -> dict:
    subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree, out], check=True)
    return dict(np.load(out))


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        run_tree(sys.argv[2])
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for k, tree in enumerate(sys.argv[1:]):
            outs.append(run_child(tree, os.path.join(tmp, f"{k}.npz")))
    a, b = outs
    if a.keys() != b.keys():
        print(f"the trees return different outputs: {sorted(a)} vs {sorted(b)}")
        return 1
    same = True
    for name in a:
        x, y = a[name], b[name]
        equal = x.shape == y.shape and x.tobytes() == y.tobytes()
        same &= equal
        if equal:
            print(f"{name}: bit-equal ({x.size} elements)")
        else:
            d = np.abs(x.astype(np.float64) - y.astype(np.float64))
            print(f"{name}: {int((x != y).sum())} of {x.size} elements differ, largest "
                  f"{float(np.nanmax(d))}")
    print(json.dumps({"bit_equal": bool(same)}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
