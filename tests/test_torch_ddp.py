"""The port's DDP solver and its Riccati passes against the JAX package on the
CPU: the sequential and the parallel-in-time (hand-written up-sweep/down-sweep
scan) backward passes, the DDP solve on the golden nominal ticks with either
pass, "auto" at a long horizon, and GradientMPC / BatchedGradientMPC with
mpc.gradient.use_DDP. Inputs are seeded numpy arrays or the golden scenarios;
the JAX side runs on the CPU as its own tests do: live for the Riccati passes,
recorded by ``jax_ddp_references`` (``tests/jax_references.py``,
``tools/record_jax_references.py``) for the DDP solves and controllers.

Tolerances: the Riccati passes at atol 2e-3, rtol 1e-3 (tests/test_parallel_riccati.py:
31-41), closed-loop LQR trajectories at atol 1e-3; the DDP solve's inputs at
DDP_ATOL (float32 Riccati solves and rollouts in two libraries) and its cost at
rtol 1e-4. The line search takes the argmin of four costs, where a tie within
float32 rounding could send the two packages to different step sizes; on these
inputs none does (U agrees within DDP_ATOL throughout), and a parting U fails."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu.controllers.gradient import BatchedGradientMPC as JaxBatched
from quadruped_pympc_tamols_tpu.controllers.gradient import GradientMPC as JaxMPC
from quadruped_pympc_tamols_tpu.controllers.gradient import ddp as jddp
from quadruped_pympc_tamols_tpu.controllers.gradient import parallel_riccati as jpr
from quadruped_pympc_tamols_tpu.gait.periodic import contact_sequence as jax_contact_sequence
from quadruped_pympc_tamols_tpu.gait.periodic import make_timer_dts as jax_timer_dts
from quadruped_pympc_tamols_torch.controllers.gradient import (BatchedGradientMPC, GradientMPC,
                                                               ddp, parallel_riccati)
from quadruped_pympc_tamols_torch.interop import config_from_dict
from jax_references import check_inputs, digest
from jax_references import load as load_jax
from test_golden_traces import _scenarios, _state, _ref, _trot_seq

torch.set_num_threads(1)
# One BLAS thread for the float64 references: the suite runs files side by side.
threadpool_limits(1)
RICCATI = dict(atol=2e-3, rtol=1e-3)  # tests/test_parallel_riccati.py:31-41
JAX_SEQUENTIAL = jax.jit(jpr.lqr_backward_sequential)
JAX_ASSOCIATIVE = jax.jit(jpr.lqr_backward_associative)
SHAPES = ((16, 4, 2), (12, 12, 12), (64, 6, 3))
DDP_ATOL = 0.05  # N on U, O(100 N) forces
COST_RTOL = 1e-4
NOMINAL = [name for name, case in _scenarios().items() if case[0] == "nominal"]


def _cfgs(**over):
    jc = jax_make_config("aliengo", mpc_type="nominal", **over)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _random_ltv(H, n, m, seed=0):
    """The random LTV problem of tests/test_parallel_riccati.py:13-28, as numpy."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(H, n, n)) * 0.3 + np.eye(n)
    c = rng.normal(size=(H, n)) * 0.1
    G = rng.normal(size=(H, n, m))
    Q = np.stack([A @ A.T * 0.1 + 0.5 * np.eye(n) for A in rng.normal(size=(H, n, n))])
    q = rng.normal(size=(H, n))
    R = np.tile(np.eye(m), (H, 1, 1))
    A = rng.normal(size=(n, n))
    QN = A @ A.T * 0.1 + np.eye(n)
    qN = rng.normal(size=n)
    return [np.asarray(a, np.float32) for a in (F, c, G, Q, q, R, QN, qN)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_lqr_backward_sequential_matches_jax():
    for seed, (H, n, m) in enumerate(SHAPES):
        args = _random_ltv(H, n, m, seed)
        want = JAX_SEQUENTIAL(*(jnp.asarray(a) for a in args))
        got = parallel_riccati.lqr_backward_sequential(*_t(args))
        for name, a, b in zip(("K", "kff", "S", "s"), got, want):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"{(H, n, m)} {name}",
                                       **RICCATI)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_associative_matches_sequential(shape):
    """The port's scan against its sequential pass, against the JAX package's
    associative pass, and batched: two problems under one leading dimension give
    each problem's result."""
    H, n, m = shape
    seed = SHAPES.index(shape)
    args = _random_ltv(H, n, m, seed)
    seq = parallel_riccati.lqr_backward_sequential(*_t(args))
    assoc = parallel_riccati.lqr_backward_associative(*_t(args))
    jassoc = JAX_ASSOCIATIVE(*(jnp.asarray(a) for a in args))
    for name, a, b, c in zip(("K", "kff", "S", "s"), assoc, seq, jassoc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **RICCATI)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), err_msg=name, **RICCATI)
    other = _random_ltv(H, n, m, seed + 10)
    both = parallel_riccati.lqr_backward_associative(
        *(torch.stack([x, y]) for x, y in zip(_t(args), _t(other))))
    alone = parallel_riccati.lqr_backward_associative(*_t(other))
    for a, b, c in zip(both, assoc, alone):
        np.testing.assert_allclose(a[0].numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a[1].numpy(), c.numpy(), rtol=1e-5, atol=1e-5)


def test_closed_loop_trajectories_identical():
    """Rolling the LTV system forward under both gain sets gives the same
    trajectory (tests/test_parallel_riccati.py:44-68), at H = 24."""
    H, n, m = 24, 6, 3
    F, c, G, *_ = args = _random_ltv(H, n, m, seed=7)
    x0 = np.random.default_rng(1).normal(size=n).astype(np.float32)

    def rollout(K, kff):
        x, xs, us = torch.from_numpy(x0), [], []
        for k in range(H):
            u = -K[k] @ x + kff[k]
            xs.append(x)
            us.append(u)
            x = torch.from_numpy(F[k]) @ x + torch.from_numpy(c[k]) + torch.from_numpy(G[k]) @ u
        return torch.stack(xs).numpy(), torch.stack(us).numpy()

    K1, k1, *_ = parallel_riccati.lqr_backward_sequential(*_t(args))
    K2, k2, *_ = parallel_riccati.lqr_backward_associative(*_t(args))
    for a, b in zip(rollout(K2, k2), rollout(K1, k1)):
        np.testing.assert_allclose(a, b, atol=1e-3)


def test_project_cone_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        u = rng.normal([0, 0, 60] * 4, [60, 60, 120] * 4).astype(np.float32)
        c = (rng.uniform(size=4) < 0.6).astype(np.float32)
        want = jddp.project_cone(jnp.asarray(u), jnp.asarray(c), 0.5, 0.0, 400.0)
        got = ddp.project_cone(torch.from_numpy(u), torch.from_numpy(c), 0.5, 0.0, 400.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ddp_inputs(jc, name):
    """A golden scenario's first-tick solve inputs, built by the JAX controller."""
    _, state, ref, seq = _scenarios()[name]
    mpc = JaxMPC(jc)
    seq = np.asarray(seq, np.float32)
    x0, feet = mpc._build_inputs(state, ref, seq)
    Xref, Uref = mpc._build_refs(state, ref, seq)
    return x0, feet, seq, Xref, Uref, Uref  # the first tick's warm start: Uref


def _assert_ddp_close(got, want, label):
    """U within DDP_ATOL and the cost within COST_RTOL."""
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=COST_RTOL, err_msg=label)
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(want.U), rtol=0, atol=DDP_ATOL,
                               err_msg=label)


BACKWARDS = ("sequential", "associative")


def _h24_inputs(tc):
    """The H = 24 tick of test_auto_takes_the_associative_pass_at_h24."""
    H = tc.mpc.horizon
    x0 = np.zeros(12, np.float32)
    x0[2], x0[3] = 0.30, 0.1
    feet = np.tile(np.float32([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0],
                               [-0.25, -0.15, 0]]), (H, 1, 1))
    seq = np.ones((4, H), np.float32)
    seq[1, : H // 2] = seq[2, : H // 2] = 0.0
    Xref = np.zeros((H, 12), np.float32)
    Xref[:, 2] = 0.35
    Uref = np.zeros((H, 12), np.float32)
    Uref[:, 2::3] = tc.robot.mass * 9.81 / 4
    return (x0, feet, seq, Xref, Uref, Uref)


H24 = {"mpc.gradient.use_DDP": True, "mpc.horizon": 24, "mpc.horizon_fine_grained": 2}
MPC_TICKS = 5
GAIT_PHASES = ([0.1, 0.6, 0.6, 0.1], [0.45, 0.95, 0.95, 0.45])


def _mpc_ticks(jc):
    """The 5 trot ticks with a drifting state of test_gradient_mpc_with_ddp_matches_jax."""
    rng = np.random.default_rng(3)
    seq0 = _trot_seq(jc.mpc.horizon)
    return [(_state(pos=(0.01 * k, 0.0, 0.31 + 0.005 * k), vel=rng.normal([0.2, 0, 0], 0.05)),
             _ref(jc, vel=(0.3, 0, 0)), np.roll(seq0, -k, axis=1)) for k in range(MPC_TICKS)]


def jax_ddp_references() -> dict:
    """The JAX package's side of this module's DDP tests (tests/jax_references.py):
    the golden ticks' solve inputs and solves with either backward pass, the
    H = 24 "auto" solve, GradientMPC(use_DDP) over MPC_TICKS ticks and the batched
    gait candidates."""
    out = {}
    for backward in BACKWARDS:
        jc, _ = _cfgs(**{"mpc.gradient.use_DDP": True, "mpc.gradient.riccati_backward": backward})
        jsolve, _ = jddp.make_ddp_solver(jc)
        out[f"digest/solve/{backward}"] = digest(jc)
        for name in NOMINAL:
            ins = _ddp_inputs(jc, name)
            out.update({f"inputs/{name}/{i}": np.asarray(a, np.float32) for i, a in enumerate(ins)})
            want = jsolve(*(jnp.asarray(a) for a in ins))
            out[f"solve/{backward}/{name}/U"] = np.asarray(want.U)
            out[f"solve/{backward}/{name}/cost"] = np.asarray(want.cost)
    jc, tc = _cfgs(**H24)
    want = jddp.make_ddp_solver(jc)[0](*(jnp.asarray(a) for a in _h24_inputs(tc)))
    out["auto_h24/U"], out["auto_h24/cost"] = np.asarray(want.U), np.asarray(want.cost)
    out["digest/auto_h24"] = digest(jc, _h24_inputs(tc))
    jc, _ = _cfgs(**{"mpc.gradient.use_DDP": True, "mpc.gradient.use_RTI": True})
    jaxm = JaxMPC(jc)
    out["digest/mpc"] = digest(jc, _mpc_ticks(jc))
    for k, tick in enumerate(_mpc_ticks(jc)):
        for key, v in zip(("grfs", "footholds", "pred", "status", "cost"),
                          jaxm.compute_control(*tick)):
            out[f"mpc/{k}/{key}"] = np.asarray(v)
        assert jaxm.compute_rti_prepare() is None
    jc, _ = _cfgs(**{"mpc.gradient.use_DDP": True, "mpc.optimize_step_freq": True})
    _, state, ref, _ = _scenarios()["trot_nominal"]
    out["digest/gait"] = digest(jc, state, ref)
    freqs = np.asarray(jc.mpc.step_freq_available, np.float32)
    for i, phase in enumerate(GAIT_PHASES):
        ph = np.tile(np.asarray(phase, np.float32), (len(freqs), 1))
        seqs = np.asarray(jax_contact_sequence(jnp.asarray(ph), jnp.asarray(freqs), 0.65,
                                               jnp.asarray(jax_timer_dts(jc.mpc))))
        jcosts, jbest = JaxBatched(jc).optimize_gait(state, ref, seqs)
        out[f"gait/{i}/seqs"], out[f"gait/{i}/costs"] = seqs, np.asarray(jcosts)
        out[f"gait/{i}/best"] = np.asarray(jbest)
    return out


class _Want:
    """A recorded DDP result: U and cost."""

    def __init__(self, ref, key):
        self.U, self.cost = ref[f"{key}/U"], ref[f"{key}/cost"]


@pytest.mark.parametrize("backward", ["sequential", "associative"])
def test_ddp_solve_matches_jax(backward):
    """make_ddp_solver on the five golden nominal ticks (B = 1) against the JAX
    package's (recorded: tests/jax_references.py), with the given backward pass."""
    ref = load_jax("ddp")
    jc, tc = _cfgs(**{"mpc.gradient.use_DDP": True, "mpc.gradient.riccati_backward": backward})
    check_inputs(ref, f"solve/{backward}", jc)
    tsolve, _ = ddp.make_ddp_solver(tc, device="cpu")
    for name in NOMINAL:
        ins = [ref[f"inputs/{name}/{i}"] for i in range(6)]
        got = tsolve(*(torch.from_numpy(np.asarray(a, np.float32))[None] for a in ins))
        got = type(got)(*(x[0].numpy() for x in got))
        _assert_ddp_close(got, _Want(ref, f"solve/{backward}/{name}"), f"{backward} {name}")


def test_auto_takes_the_associative_pass_at_h24():
    """riccati_backward="auto" at H = 24 runs the associative pass: the port's
    solve equals its explicit associative solve bit for bit and matches the JAX
    package's (recorded; tests/test_parallel_riccati.py:107-125 runs H = 48)."""
    jc, tc = _cfgs(**H24)
    assert tc.mpc.gradient.riccati_backward == "auto"
    _, tc_assoc = _cfgs(**H24, **{"mpc.gradient.riccati_backward": "associative"})
    _, tc_seq = _cfgs(**H24, **{"mpc.gradient.riccati_backward": "sequential"})
    ins = _h24_inputs(tc)
    ref = load_jax("ddp")
    check_inputs(ref, "auto_h24", jc, ins)
    outs = {}
    for label, cfg in (("auto", tc), ("associative", tc_assoc), ("sequential", tc_seq)):
        solve, _ = ddp.make_ddp_solver(cfg, device="cpu")
        outs[label] = solve(*(torch.from_numpy(a)[None] for a in ins))
    for a, b in zip(outs["auto"], outs["associative"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    scale = max(1.0, float(outs["sequential"].U.abs().max()))
    np.testing.assert_allclose(outs["auto"].U.numpy(), outs["sequential"].U.numpy(),
                               atol=2e-3 * scale)
    got = type(outs["auto"])(*(x[0].numpy() for x in outs["auto"]))
    _assert_ddp_close(got, _Want(ref, "auto_h24"), "auto H=24")


def test_gradient_mpc_with_ddp_matches_jax():
    """GradientMPC(use_DDP) against the JAX package's (recorded) over 5 trot ticks
    with a drifting state, each carrying its own warm start: the same status, GRFs
    within DDP_ATOL, the cost within COST_RTOL; no RTI split under DDP."""
    jc, tc = _cfgs(**{"mpc.gradient.use_DDP": True, "mpc.gradient.use_RTI": True})
    ref = load_jax("ddp")
    check_inputs(ref, "mpc", jc, _mpc_ticks(jc))
    port = GradientMPC(tc, device="cpu")
    for k, (state, rf, seq) in enumerate(_mpc_ticks(jc)):
        g, fh, pred, status, cost = port.compute_control(state, rf, seq)
        jg, jfh, jpred, jstatus, jcost = (ref[f"mpc/{k}/{key}"] for key in (
            "grfs", "footholds", "pred", "status", "cost"))
        assert status == jstatus == 0
        np.testing.assert_allclose(g, jg, atol=DDP_ATOL, err_msg=f"tick {k}")
        np.testing.assert_allclose(cost, jcost, rtol=COST_RTOL, err_msg=f"tick {k}")
        np.testing.assert_array_equal(fh, jfh)
        np.testing.assert_allclose(pred, jpred, atol=1e-4)
        assert port.compute_rti_prepare() is None
    assert port._prepare_dev is None


def test_batched_gait_candidates_with_ddp_match_jax():
    """BatchedGradientMPC(use_DDP): the K candidates as one batched DDP solve,
    costs within 1e-3 relative of the JAX package's vmapped DDP (recorded) and the
    same best frequency."""
    jc, tc = _cfgs(**{"mpc.gradient.use_DDP": True, "mpc.optimize_step_freq": True})
    _, state, rf, _ = _scenarios()["trot_nominal"]
    ref = load_jax("ddp")
    check_inputs(ref, "gait", jc, state, rf)
    for i in range(len(GAIT_PHASES)):
        costs, best = BatchedGradientMPC(tc, device="cpu").optimize_gait(state, rf,
                                                                        ref[f"gait/{i}/seqs"])
        np.testing.assert_allclose(costs, ref[f"gait/{i}/costs"], rtol=1e-3)
        assert best == ref[f"gait/{i}/best"].item()
