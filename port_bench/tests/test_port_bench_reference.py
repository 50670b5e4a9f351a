"""The benchmark's plain references against the port's CPU path at tiny sizes: the
fleet's tick (with the Philox noise the card's kernel draws), the gradient call's QP
as the port assembles it, and its solve."""
from __future__ import annotations

import copy
import itertools
import types

import numpy as np
import torch

from port_bench import harness
from port_bench.drivers import fleet, solve_stream
from port_bench.generate import FleetEpisodes, trot_stream
from port_bench.reference.fleet import STATE_KEYS, FleetReference, judge_tick
from port_bench.reference.frozen.config import make_config
from port_bench.reference.gradient import GradientReference, judge_calls

SEED = 2 ** 31 + 4242


def test_fleet_reference_follows_the_ports_tick():
    cell = harness.resolve("fleet_perlin_s64")
    mc = dict(cell.config["make_config"], **{"mpc.sampling.num_samples": 40})
    traffic = dict(cell.traffic, scenarios=3)
    cfg = make_config(**mc)
    ctx = types.SimpleNamespace(cfg=cfg, device=torch.device("cpu"), traffic=traffic,
                                config={"make_config": mc})
    system = fleet.make_system(ctx)
    system.load(FleetEpisodes(mc, traffic, SEED, "cpu").draw())
    ref = FleetReference(mc, 40, traffic["terrain"], True, "cpu")
    cmd = torch.tensor(traffic["command"], dtype=torch.float32)
    for _ in range(4):
        pre = {k: t.clone() for k, t in zip(STATE_KEYS, system.tensors())}
        m = system.tick(cmd)
        post = {k: t.clone() for k, t in zip(STATE_KEYS, system.tensors())}
        got = judge_tick(ref, pre, post, m, cmd)
        assert got["cost_gaps"].max() <= 1e-6
        assert got["grf_gap_N"] <= 1e-4 and got["state_gap"] <= 1e-6


def _calls(n):
    cell = harness.resolve("nominal_trot_stream")
    return cell, list(itertools.islice(trot_stream(cell.config["make_config"], cell.traffic,
                                                   SEED), n))


def test_gradient_reference_assembles_the_ports_qp():
    from quadruped_pympc_tamols_torch.controllers.gradient.sqp import make_rti_solver_split

    cell, calls = _calls(3)
    mc = cell.config["make_config"]
    ref = GradientReference(mc, cell.config["mehrotra_iterations"])
    *_, assemble = make_rti_solver_split(make_config(**mc), return_assembler=True, device="cpu")
    rng = np.random.default_rng(0)
    for i, (state, reference, seq) in enumerate(calls):
        x0, feet, sq, Xref, Uref = ref.inputs(state, reference, seq)
        U_warm = Uref + (rng.normal(0.0, 5.0, Uref.shape).astype(np.float32) if i else 0.0)
        ours = ref.qp(x0, feet, sq, Xref, Uref, U_warm)[:4]
        theirs = assemble(*(torch.as_tensor(a)[None] for a in (x0, feet, sq, Xref, Uref, U_warm)))
        for a, b in zip(ours, theirs):
            b = b[0].double()
            assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max()) + 1e-6


def test_gradient_reference_follows_the_ports_solve():
    """The port's controller on the CPU against the float64 reference at the
    iteration budget the port runs there."""
    from quadruped_pympc_tamols_torch.controllers.gradient.sqp import qp_solver_for

    cell, calls = _calls(9)
    mc = copy.deepcopy(cell.config["make_config"])
    iters = qp_solver_for(make_config(**mc).mpc.gradient, "cpu")[1]
    ctx = types.SimpleNamespace(config={"make_config": mc}, device=torch.device("cpu"))
    system = solve_stream.make_system(ctx)
    records = []
    for state, reference, seq in calls:
        before = system.U_warm.copy()
        grfs, status = system.call(state, reference, seq)
        records.append(dict(state=state, reference=reference, seq=seq, U_warm=before,
                            U_warm_next=system.U_warm.copy(), grfs=np.array(grfs),
                            status=int(status)))
    got = judge_calls(GradientReference(mc, iters), records)
    assert all(r["status"] == 0 for r in records)
    assert got["grf_gap_med_N"] <= 0.05 and got["plan_gap_med_N"] <= 0.05
