#!/usr/bin/env python3
"""Device time of every kernel of the MPPI and CEM rows (K1b, K1c, K1e-mppi,
K1e-cem) on one card, for one or more checkouts, each in a process of its own.

    python3 tools/pass_times.py TREE [TREE ...]

For each TREE (the root of a checkout of this repository), in the order given (a
tree may repeat: A B B A), imports that tree's ``quadruped_pympc_tamols_torch``
and, for each row at N = 10 000 (K1e: K = 3 groups, 9999 samples) on the
flagship tick, launches one iteration through the C entry with its argument
block built once: 50 launches under torch.profiler, after 50 of warm-up, give
each kernel's mean device us a launch and its launches an iteration as recorded
(memsets and copies too; the profiler can miss a launch), and 100 more the
median CUDA-event ms of one iteration (the host's enqueue where it is longer
than the card's work), with how many of the iteration's softmax weights are
not 0. Prints one JSON line per tree and row,
then one with the registers, shared memory, stack and spills of each kernel of
the tree's K1b/K1c library (its ``-Xptxas -v`` log), and exits 0.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np

N = 10_000
PROFILED, TIMED = 50, 100


def profile(fn) -> dict:
    """{kernel name: (launches a call, mean device us a launch)} over PROFILED calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    for _ in range(PROFILED):
        fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if dev_us > 0 and not e.key.startswith(("aten::", "cuda", "ProfilerStep")):
            out[e.key.split("(")[0]] = (e.count / PROFILED, dev_us / e.count)
    return out


def load(module, plan):
    """The tree's library for ``plan``: one per (horizon, parameters per leg) pair,
    or, in a tree from before the pairs, its one library."""
    import inspect
    if inspect.signature(module.load_library).parameters:
        return module.load_library(plan.horizon, plan.params_per_leg)
    return module.load_library()


def event_ms(fn) -> float:
    import torch
    pairs = []
    for _ in range(TIMED):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def weights(costs, knobs) -> dict:
    """How many of the iteration's softmax weights exp(-(c - beta)/T) are not 0
    (torch.exp on the kernel's costs), and of how many."""
    import torch
    w = torch.exp(-(costs - costs.min()) / knobs.temperature)
    return {"nonzero_weights": int((w != 0).sum()), "samples": int(costs.numel())}


def ptxas(log_path) -> dict:
    """{kernel (mangled name): its registers, shared memory, stack and spills}."""
    out, name = {}, None
    for line in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and "spill" in line:
            stack, stores, loads = map(int, re.findall(r"(\d+) bytes", line))
            out[name].update(stack_bytes=stack, spill_store_bytes=stores, spill_load_bytes=loads)
        elif name and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(m.group(1)) if m else 0
    return out


def run_tree(tree: str) -> None:
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
    rng = np.random.default_rng(0)
    plan = sk.make_rs_plan(cfg, N, dev)
    P = plan.num_parameters
    inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
    sig = torch.full((P,), cfg.mpc.sampling.sigma_cem_mppi, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    card = torch.cuda.get_device_name(0)

    lib = load(sm, plan)
    args = sk.kernel_args(plan, tick, 5, 0)
    for row, method in (("K1b", "mppi"), ("K1c", "cem_mppi")):
        knobs = sm.make_knobs(cfg, method)
        kn = knobs.struct()
        ws = sm.workspace(plan, knobs, dev)

        def one():
            sm.launch(lib, args, kn, plan, ws, inc, sig, stream=stream)

        print(json.dumps({"tree": tree, "row": row, "card": card, "kernels": profile(one),
                          "event_ms": event_ms(one), **weights(ws.costs, knobs)}), flush=True)

    gcfg = make_config("aliengo", mpc_type="sampling", **{**base, "mpc.optimize_step_freq": True})
    gplan = sg.make_group_plan(gcfg, N, dev)
    groups = group_operators(gcfg, np.array([0.3, 0.8, 0.8, 0.3], np.float32),
                             np.asarray(gcfg.mpc.step_freq_available, np.float32))
    buf = torch.as_tensor(sg.pack_groups(groups), device=dev)
    glib = load(sg, gplan.base)
    gargs = sk.kernel_args(gplan.base, tick, 5, 0)
    gargs.num_samples = gplan.num_used
    for row, method in (("K1e-mppi", "mppi"), ("K1e-cem", "cem_mppi")):
        knobs = sm.make_knobs(gcfg, method)
        ws = sm.workspace(dataclasses.replace(gplan.base, num_samples=gplan.num_used), knobs, dev)

        def one():
            sg.launch(glib, gargs, knobs, gplan, ws, buf, inc, sig, stream=stream)

        print(json.dumps({"tree": tree, "row": row, "card": card, "kernels": profile(one),
                          "event_ms": event_ms(one), **weights(ws.costs, knobs)}), flush=True)
    from quadruped_pympc_tamols_torch.ops import build
    libs = build.build_all()
    log = libs.get(("sampling_softmax", H, plan.params_per_leg), libs.get("sampling_softmax"))
    log = log.with_suffix(".log")
    print(json.dumps({"tree": tree, "ptxas": ptxas(log)}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        run_tree(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
