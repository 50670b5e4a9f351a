"""The nominal gradient MPC on the card: each phase a replay of a captured CUDA
graph, bit-equal to the eager function on the card, held against the CPU port
and the float64 reference on the golden QPs, the RTI split exact, the fallback
reached by a NaN factor, the batched gait candidates, reruns, two controllers on
one device and a capture that fails.

Runs only where CUDA is present (it skips elsewhere): on the H100, run
``python -m pytest --noconftest tests/test_torch_cuda_gradient.py -m cuda``. It
imports only the port."""
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_torch import make_config, replace_config
from quadruped_pympc_tamols_torch.controllers.gradient import BatchedGradientMPC, GradientMPC, sqp
from quadruped_pympc_tamols_torch.gait.periodic import contact_sequence, make_timer_dts
from quadruped_pympc_tamols_torch.utils.graphs import GraphedFunction
from quadruped_pympc_tamols_torch.utils.verification import (golden_nominal_scenarios,
                                                             pdip_solve_np_f64)

pytestmark = pytest.mark.cuda
F64_FLOOR = 0.01  # N: the floor of the first-stage GRF bound against float64


@pytest.fixture(scope="module")
def cfg():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the solve runs as a captured CUDA graph)")
    assert not torch.backends.cuda.matmul.allow_tf32
    return make_config("aliengo", mpc_type="nominal")


def _tick_inputs(mpc, name, cfg):
    state, ref, seq = golden_nominal_scenarios(cfg)[name]
    seq = np.asarray(seq, np.float32)
    x0, feet = mpc._build_inputs(state, ref, seq)
    Xref, Uref = mpc._build_refs(state, ref, seq)
    return x0, feet, seq, Xref, Uref


def _eager(mpc):
    """The same controller with every phase run eagerly on the card."""
    for name in ("_solve_dev", "_prepare_dev", "_feedback_dev"):
        setattr(mpc, name, getattr(mpc, name).fn)
    return mpc


def test_graph_equals_eager_and_reruns_bit_for_bit(cfg):
    graphed, eager = GradientMPC(cfg), _eager(GradientMPC(cfg))
    for name in golden_nominal_scenarios(cfg):
        x0, feet, seq, Xref, Uref = _tick_inputs(graphed, name, cfg)
        a = graphed.solve(x0, feet, seq, Xref, Uref, Uref)
        b = eager.solve(x0, feet, seq, Xref, Uref, Uref)
        c = graphed.solve(x0, feet, seq, Xref, Uref, Uref)
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y, err_msg=name)
            np.testing.assert_array_equal(x, z, err_msg=name)
    assert graphed._solve_dev.captures == 1 and graphed._solve_dev.replays == 10


def test_card_within_the_f64_bound_of_the_cpu_port(cfg):
    """On the five golden scenarios, each device's assembled QP solved at the
    card's budget (10 iterations): the card's first-stage GRFs within max(2 x the
    CPU port's gap at that budget, 0.01 N) of the float64 solution of the card's
    QP, and within 0.01 N of the CPU port's."""
    from quadruped_pympc_tamols_torch.controllers.gradient import make_rti_solver_split
    from quadruped_pympc_tamols_torch.controllers.gradient.sqp import qp_solver_for

    fn, iters = qp_solver_for(cfg.mpc.gradient, "cuda")
    mpc = GradientMPC(cfg, device="cpu")
    z, gaps = {}, {}
    for device in ("cuda", "cpu"):
        *_, assemble = make_rti_solver_split(cfg, return_assembler=True, device=device)
        for name in golden_nominal_scenarios(cfg):
            ins = _tick_inputs(mpc, name, cfg)  # warm start: the gravity share, Uref
            q = assemble(*(torch.as_tensor(a, device=device)[None] for a in (*ins, ins[4])))
            z[device, name] = fn(*q, iters=iters).z[0, :12].cpu().numpy()
            z64 = pdip_solve_np_f64(*(a[0].cpu().numpy() for a in q))[0]
            gaps[device, name] = float(np.abs(z[device, name] - z64[:12]).max())
    for name in golden_nominal_scenarios(cfg):
        assert gaps["cuda", name] <= max(2 * gaps["cpu", name], F64_FLOOR), (name, gaps)
        assert np.abs(z["cuda", name] - z["cpu", name]).max() <= F64_FLOOR, name


def test_rti_split_is_exact_on_the_card(cfg):
    mpc = GradientMPC(cfg)
    x0, feet, seq, Xref, Uref = _tick_inputs(mpc, "trot_nominal", cfg)
    one = mpc.solve(x0, feet, seq, Xref, Uref, Uref)
    split = mpc.feedback(mpc.prepare(x0, feet, seq, Xref, Uref, Uref), x0, feet, seq, Xref, Uref)
    for a, b in zip(one, split):
        np.testing.assert_array_equal(a, b)
    assert mpc._prepare_dev.replays == mpc._feedback_dev.replays == 1


def test_nan_factor_reaches_the_fallback_on_the_card(cfg):
    """A Newton matrix that is not positive definite (finite inputs, a negative
    Levenberg-Marquardt term): cholesky_ex's info > 0 becomes a NaN factor inside
    the graph, and the controller returns the previous GRFs with status 1."""
    state, ref, seq = golden_nominal_scenarios(cfg)["trot_nominal"]
    good = GradientMPC(cfg)
    g0 = good.compute_control(state, ref, seq)[0]
    bad = GradientMPC(replace_config(cfg, **{"mpc.gradient.levenberg_marquardt": -1e4}))
    bad.previous_grfs = g0.copy()
    grfs, _, _, status, _ = bad.compute_control(state, ref, seq)
    assert status == 1 and not np.any(bad.U_warm)
    np.testing.assert_array_equal(grfs, g0)
    assert bad._solve_dev.replays == 1


def test_batched_gait_graph_matches_the_cpu(cfg):
    """K = 3 candidates as one captured batched solve: costs within 1e-3 of the
    CPU port's at the same QP budget, and the same best frequency."""
    gcfg = replace_config(cfg, **{"mpc.optimize_step_freq": True})
    state, ref, _ = golden_nominal_scenarios(gcfg)["trot_nominal"]
    freqs = np.asarray(gcfg.mpc.step_freq_available, np.float32)
    seqs = contact_sequence(np.tile(np.float32([0.1, 0.6, 0.6, 0.1]), (len(freqs), 1)), freqs,
                            0.65, make_timer_dts(gcfg.mpc))
    card = BatchedGradientMPC(gcfg)
    costs, best = card.optimize_gait(state, ref, seqs)
    budget = sqp.qp_solver_for
    sqp.qp_solver_for = lambda gp, device="cuda": budget(gp, "cuda")
    try:  # the CPU at the card's QP budget: its candidates start from a zero warm start
        cpu = BatchedGradientMPC(gcfg, device="cpu")
    finally:
        sqp.qp_solver_for = budget
    cpu_costs, cpu_best = cpu.optimize_gait(state, ref, seqs)
    np.testing.assert_allclose(costs, cpu_costs, rtol=1e-3)
    assert best == cpu_best
    assert card.inner._solve_dev.captures == 1


def test_two_controllers_share_nothing_stale(cfg):
    """A second controller on the same device (another iteration budget) captures
    its own graph; the first keeps returning its own eager results."""
    first = GradientMPC(cfg)
    x0, feet, seq, Xref, Uref = _tick_inputs(first, "three_stance_nominal", cfg)
    a = first.solve(x0, feet, seq, Xref, Uref, Uref)
    second = GradientMPC(replace_config(cfg, **{"mpc.gradient.solver_mode": "crazy_speed"}))
    b = second.solve(x0, feet, seq, Xref, Uref, Uref)
    a2 = first.solve(x0, feet, seq, Xref, Uref, Uref)
    want_b = _eager(GradientMPC(replace_config(
        cfg, **{"mpc.gradient.solver_mode": "crazy_speed"}))).solve(x0, feet, seq, Xref, Uref,
                                                                    Uref)
    for x, y in zip(a, a2):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(b, want_b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.U, b.U)


def test_failed_capture_raises_and_never_runs_eagerly(cfg):
    def syncs(x):
        return x * float(x.sum().item())  # a host read cannot be captured

    fn = GraphedFunction(syncs, "cuda")
    x = torch.ones(4)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            fn(x)
    assert fn.captures == 0 and fn.replays == 0
    # The failed capture leaves the device's random generator usable.
    assert torch.randn(4, device="cuda").isfinite().all()
