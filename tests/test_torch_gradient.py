"""The port's nominal gradient MPC (condensed OCP + dense Mehrotra QP, RTI-SQP)
against the JAX package on the CPU: the OCP operators, the assembled QPs and
their solutions against the float64 reference, the controller against the
golden traces, the RTI split, the failure fallback and the batched gait
candidates. Inputs come from numpy seeds or the golden scenarios; the JAX side
runs on the CPU as its own tests do.

``python tests/test_torch_gradient.py [row ...]`` prints the JAX package's nominal
walks for PERF.md's closed-loop table (rows of ``WALKS``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu.controllers.gradient import (BatchedGradientMPC as JaxBatched,
                                                              GradientMPC as JaxMPC)
from quadruped_pympc_tamols_tpu.controllers.gradient import ocp as jocp
from quadruped_pympc_tamols_tpu.controllers.gradient import qp as jqp
from quadruped_pympc_tamols_tpu.controllers.gradient.sqp import make_rti_solver_split as jax_split
from quadruped_pympc_tamols_tpu.dynamics.srbd import make_params as jax_params
from quadruped_pympc_tamols_tpu.gait.periodic import contact_sequence as jax_contact_sequence
from quadruped_pympc_tamols_tpu.gait.periodic import make_timer_dts as jax_timer_dts
from quadruped_pympc_tamols_tpu.utils.verification import pdip_solve_np_f64 as jax_f64
from quadruped_pympc_tamols_torch.controllers.gradient import (BatchedGradientMPC, GradientMPC,
                                                               make_rti_solver_split, ocp, qp)
from quadruped_pympc_tamols_torch.dynamics.srbd import make_params
from quadruped_pympc_tamols_torch.interop import config_from_dict
from quadruped_pympc_tamols_torch.utils.verification import (golden_nominal_scenarios,
                                                             pdip_solve_np_f64)
from test_golden_traces import FIXTURE, _scenarios

torch.set_num_threads(1)
NOMINAL = [name for name, case in _scenarios().items() if case[0] == "nominal"]
OCP_RTOL = 1e-5  # of the largest entry: float32 rounding through 12 stages
QP_RTOL = 1e-4  # assembled Hm, g, C, d: float32 matmuls summed in other orders
F64_FLOOR = 0.01  # N: the floor of the first-stage GRF bound against float64


def _cfgs(**over):
    jc = jax_make_config("aliengo", mpc_type="nominal", **over)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _t(*arrays):
    """numpy -> CPU float32 tensors with a batch of one."""
    return [torch.from_numpy(np.array(a, np.float32))[None] for a in arrays]


def _scenario_inputs(jc, name):
    """Host inputs of a golden scenario's tick, built by the JAX controller."""
    _, state, ref, seq = _scenarios()[name]
    mpc = JaxMPC(jc)
    seq = np.asarray(seq, np.float32)
    x0, feet = mpc._build_inputs(state, ref, seq)
    Xref, Uref = mpc._build_refs(state, ref, seq)
    return x0, feet, seq, Xref, Uref


@pytest.fixture(scope="module")
def golden_qps():
    """Each golden scenario's QP, assembled by both packages from the same inputs
    (warm start: the gravity share, as the first tick has)."""
    jc, tc = _cfgs()
    *_, jasm = jax_split(jc, return_assembler=True)
    *_, tasm = make_rti_solver_split(tc, return_assembler=True, device="cpu")
    out = {}
    for name in NOMINAL:
        x0, feet, seq, Xref, Uref = _scenario_inputs(jc, name)
        jq = [np.asarray(a) for a in jasm(x0, feet, seq, Xref, Uref, Uref)]
        tq = [a[0].numpy() for a in tasm(*_t(x0, feet, seq, Xref, Uref, Uref))]
        out[name] = (jq, tq)
    return out


@pytest.mark.parametrize("integrator", ["euler", "rk4"])
@pytest.mark.parametrize("wrench", [False, True], ids=["no_wrench", "wrench"])
def test_ocp_operators_match_jax(integrator, wrench):
    """rollout_nominal, linearize_dynamics (A, B), condense (F, G) and
    condensed_cost (Hm, g) on seeded random inputs, with and without a per-stage
    external wrench."""
    jc, tc = _cfgs()
    H = jc.mpc.horizon
    rng = np.random.default_rng(3)
    x0 = np.concatenate([[0.02, -0.01, 0.33], rng.normal(0, 0.2, 3), rng.normal(0, 0.1, 3),
                         rng.normal(0, 0.3, 3)]).astype(np.float32)
    U = rng.uniform(-20, 120, (H, 12)).astype(np.float32)
    feet = (np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]])
            + rng.normal(0, 0.03, (H, 4, 3))).astype(np.float32)
    seq = (rng.uniform(size=(4, H)) < 0.7).astype(np.float32)
    w = rng.normal(0, [20, 20, 30, 3, 3, 2], (H, 6)).astype(np.float32) if wrench else None
    dims = jocp.OCPDims(horizon=H)
    jp, dts = jax_params(jc), jc.mpc.dts()
    jx = jocp.rollout_nominal(jnp.asarray(x0), jnp.asarray(U), jnp.asarray(feet), jnp.asarray(seq),
                              jp, dts, integrator, None if w is None else jnp.asarray(w))
    jlin = jocp.linearize_dynamics(jx, jnp.asarray(U), jnp.asarray(feet), jnp.asarray(seq), jp,
                                   dts, integrator, None if w is None else jnp.asarray(w))
    jF, jG = jocp.condense(jlin, dims)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    tp = make_params(tc)
    tx = ocp.rollout_nominal(t(x0), t(U), t(feet), t(seq), tp, t(dts), integrator,
                             None if w is None else t(w))
    tlin = ocp.linearize_dynamics(tx, t(U), t(feet), t(seq), tp, t(dts), integrator,
                                  None if w is None else t(w))
    tF, tG = ocp.condense(tlin, ocp.OCPDims(horizon=H))
    x0b = x0 + rng.normal(0, 0.01, 12).astype(np.float32)
    Xref, Uref = rng.normal(0, 0.3, (H, 12)).astype(np.float32), U + 5.0
    jq = jocp.condensed_cost(jF, jG, jx, jnp.asarray(x0b), jnp.asarray(Xref), jnp.asarray(Uref),
                             jnp.asarray(U), jocp.q_diag_gradient(), jocp.r_diag_gradient(),
                             dims)
    tq = ocp.condensed_cost(tF, tG, tx, t(x0b), t(Xref), t(Uref), t(U),
                            t(ocp.q_diag_gradient()), t(ocp.r_diag_gradient()),
                            ocp.OCPDims(horizon=H))
    for name, a, b in (("xbar", tx, jx), ("A", tlin.A, jlin.A), ("B", tlin.B, jlin.B),
                       ("F", tF, jF), ("G", tG, jG), ("Hm", tq[0], jq[0]), ("g", tq[1], jq[1])):
        assert a.shape == b.shape, name
        assert _rel(a.numpy(), b) <= OCP_RTOL, (name, _rel(a.numpy(), b))


def test_friction_cone_rows_and_feet_trajectory_exact():
    jc, tc = _cfgs()
    H = jc.mpc.horizon
    rng = np.random.default_rng(4)
    dims = jocp.OCPDims(horizon=H)
    for k in range(5):
        seq = (rng.uniform(size=(4, H)) < 0.6).astype(np.float32)
        smf = float(rng.uniform(0, 20)) * (k % 2)
        jC, jd = jocp.friction_cone_rows(0.5, 0.0, 400.0, jnp.asarray(seq), dims, smf)
        tC, td = ocp.friction_cone_rows(0.5, 0.0, 400.0, torch.from_numpy(seq),
                                        ocp.OCPDims(horizon=H), smf)
        np.testing.assert_array_equal(tC.numpy(), np.asarray(jC))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        feet = rng.normal(0, 0.2, (4, 3))
        ref = rng.normal(0, 0.2, (4, 2, 3))
        np.testing.assert_array_equal(ocp.build_feet_trajectory(feet, ref, seq, H),
                                      jocp.build_feet_trajectory(feet, ref, seq, H))
    # The port's float64 reference is the JAX package's, bit for bit.
    Hm, g, C, d = _random_qp()
    for a, b in zip(pdip_solve_np_f64(Hm, g, C, d), jax_f64(Hm, g, C, d)):
        np.testing.assert_array_equal(a, b)


def test_assemble_qp_matches_jax(golden_qps):
    """The dense QP (Hm, g, C, d) the feedback phase solves, on the five golden
    nominal scenarios."""
    for name, (jq, tq) in golden_qps.items():
        for label, a, b in zip("Hm g C d".split(), tq, jq):
            assert _rel(a, b) <= QP_RTOL, (name, label, _rel(a, b))


def _random_qp():
    """The random strictly convex QP of tests/test_gradient_mpc.py:29."""
    rng = np.random.default_rng(0)
    n, m = 20, 30
    A = rng.normal(size=(n, n))
    Hm = (A @ A.T + np.eye(n)).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    C = rng.normal(size=(m, n)).astype(np.float32)
    d = rng.uniform(0.5, 2.0, size=m).astype(np.float32)
    return Hm, g, C, d


@pytest.mark.parametrize("solver, iters", [("pdip_solve", 30), ("pdip_solve_mehrotra", 14)])
def test_qp_solvers_match_jax(solver, iters):
    """z to 1e-4 of JAX's on the random QP, and the KKT conditions of
    tests/test_gradient_mpc.py:37-42."""
    Hm, g, C, d = _random_qp()
    jz = np.asarray(getattr(jqp, solver)(*(jnp.asarray(a) for a in (Hm, g, C, d)),
                                         iters=iters).z)
    sol = getattr(qp, solver)(*_t(Hm, g, C, d), iters=iters)
    z, lam = sol.z[0].numpy(), sol.lam[0].numpy()
    np.testing.assert_allclose(z, jz, rtol=0, atol=1e-4)
    assert np.max(np.abs(Hm @ z + g + C.T @ lam)) < 1e-2
    assert float(sol.primal_res[0]) < 1e-4 and float(sol.gap[0]) < 1e-4


def _first_stage_gap(z, z64):
    return float(np.abs(np.asarray(z)[:12] - z64[:12]).max())


def _solve_cpu(tq):
    return qp.pdip_solve_mehrotra(*(torch.from_numpy(a.copy())[None] for a in tq),
                                  iters=14).z[0].numpy()


def test_golden_qps_within_f64_bound(golden_qps):
    """First-stage GRFs of the port's solve (14 Mehrotra iterations, the CPU
    budget) within max(2 x JAX's own gap, 0.01 N) of the float64 reference, on
    each package's own assembled QP. JAX's push iterate is itself ~2 N off
    (tests/test_golden_traces.py:13-16)."""
    jmeh = jax.jit(lambda *a: jqp.pdip_solve_mehrotra(*a, iters=14).z)
    for name, (jq, tq) in golden_qps.items():
        jax_gap = _first_stage_gap(jmeh(*jq), jax_f64(*jq)[0])
        port_gap = _first_stage_gap(_solve_cpu(tq), pdip_solve_np_f64(*tq)[0])
        assert port_gap <= max(2 * jax_gap, F64_FLOOR), (name, port_gap, jax_gap)


def test_push_follows_jax_only_with_symmetrization(golden_qps, monkeypatch):
    """jnp.linalg.cholesky symmetrizes its input. On the push QP the iterate is
    chaotic at 14 iterations (JAX and the port both land ~2 N off float64): with
    the symmetrization the port's first-stage GRFs stay within 0.5 N of JAX's,
    without it they leave JAX's by more than 1 N."""
    jq, _ = golden_qps["push_nominal"]
    jz = np.asarray(jax.jit(lambda *a: jqp.pdip_solve_mehrotra(*a, iters=14).z)(*jq))
    z64 = jax_f64(*jq)[0]
    sym = _solve_cpu(jq)

    def unsymmetrized(K):
        L, info = torch.linalg.cholesky_ex(K, check_errors=False)
        return torch.where((info > 0)[:, None, None], torch.nan, L)

    monkeypatch.setattr(qp, "cholesky", unsymmetrized)
    raw = _solve_cpu(jq)
    assert _first_stage_gap(jz, z64) > 1.0 and _first_stage_gap(sym, z64) > 1.0
    assert _first_stage_gap(sym, jz) < 0.5
    assert _first_stage_gap(raw, jz) > 1.0


def test_compute_control_matches_golden_traces(golden_qps):
    """GradientMPC.compute_control on the golden scenarios: stand, trot,
    three-stance and slope at the golden test's tolerance (rtol 1e-3, atol 1e-3 x
    scale); push through the float64 route, since the fixture's push is itself
    ~2 N off float64."""
    golden = dict(np.load(FIXTURE))
    _, tc = _cfgs()
    # The port's copy of the scenarios (chip_smoke.py and the card's tests use it).
    ours = golden_nominal_scenarios(tc)
    assert list(ours) == NOMINAL
    for name in NOMINAL:
        for a, b in zip(ours[name], _scenarios()[name][1:]):
            np.testing.assert_equal(a, b)
        _, state, ref, seq = _scenarios()[name]
        grfs, fh, pred, status, cost = GradientMPC(tc, device="cpu").compute_control(state, ref,
                                                                                    seq)
        assert status == 0, name
        got = {"grfs": grfs, "footholds": fh, "predicted": pred, "cost": np.float32(cost)}
        if name == "push_nominal":
            jq, tq = golden_qps[name]
            fixture_gap = float(np.abs(golden[name + "/grfs"].reshape(12) - _u0_f64(jq)).max())
            port_gap = float(np.abs(grfs.reshape(12) - _u0_f64(tq)).max())
            assert fixture_gap > 1.0
            assert port_gap <= max(2 * fixture_gap, F64_FLOOR), (port_gap, fixture_gap)
            continue
        for key, want in ((k[len(name) + 1:], v) for k, v in golden.items()
                          if k.startswith(name + "/")):
            scale = max(1.0, float(np.max(np.abs(want))))
            np.testing.assert_allclose(got[key], want, rtol=1e-3, atol=1e-3 * scale,
                                       err_msg=f"{name}/{key}")


def _u0_f64(q):
    """First-stage GRFs of the float64 solution of push's QP: the warm start of a
    first tick (the gravity share, four legs in stance) plus the first stage of z."""
    _, tc = _cfgs()
    share = np.zeros(12)
    share[2::3] = np.float32(tc.robot.mass * tc.gravity / 4)
    return share + pdip_solve_np_f64(*q)[0][:12]


def test_rti_split_exact_and_tracks_the_measurement():
    """feedback(prepare(x0), x0) equals solve(x0) bit for bit (the same ops in the
    same order), and the dx0 correction moves the feedback toward a fresh solve at
    a perturbed measurement (tests/test_rti_split.py:30-61)."""
    _, tc = _cfgs()
    H = tc.mpc.horizon
    solve, prepare, feedback, _ = make_rti_solver_split(tc, device="cpu")
    x0 = np.zeros(12, np.float32)
    x0[2] = tc.sim.ref_z - 0.02
    feet = np.tile(np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0],
                             [-0.25, -0.15, 0]], np.float32), (H, 1, 1))
    seq = np.ones((4, H), np.float32)
    Xref = np.zeros((H, 12), np.float32)
    Xref[:, 2] = tc.sim.ref_z
    Uref = np.zeros((H, 12), np.float32)
    Uref[:, 2::3] = tc.robot.mass * 9.81 / 4
    x0_t, feet_t, seq_t, Xref_t, Uref_t = _t(x0, feet, seq, Xref, Uref)
    ref = solve(x0_t, feet_t, seq_t, Xref_t, Uref_t, Uref_t)
    out = feedback(prepare(x0_t, feet_t, seq_t, Xref_t, Uref_t, Uref_t), x0_t, feet_t, seq_t,
                   Xref_t, Uref_t)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    x_meas = x0.copy()
    x_meas[2] -= 0.015
    x_meas[3] += 0.08
    (xm,) = _t(x_meas)
    prep = prepare(x0_t, feet_t, seq_t, Xref_t, Uref_t, Uref_t)
    fresh = solve(xm, feet_t, seq_t, Xref_t, Uref_t, Uref_t).U.numpy()
    stale = feedback(prep, x0_t, feet_t, seq_t, Xref_t, Uref_t).U.numpy()
    fb = feedback(prep, xm, feet_t, seq_t, Xref_t, Uref_t).U.numpy()
    assert np.abs(fb - fresh).max() < 0.35 * np.abs(stale - fresh).max()


def test_nan_state_takes_the_fallback():
    """A NaN state: status 1, the previous tick's GRFs, the warm start zeroed; as
    in the JAX package. A matrix that is not positive definite factors to NaN
    (JAX's convention) instead of raising."""
    jc, tc = _cfgs()
    _, state, ref, seq = _scenarios()["trot_nominal"]
    port, jaxm = GradientMPC(tc, device="cpu"), JaxMPC(jc)
    g0 = port.compute_control(state, ref, seq)[0]
    jaxm.compute_control(state, ref, seq)
    assert np.any(port.U_warm)
    bad = dict(state, position=np.array([np.nan, 0.0, 0.32]))
    grfs, _, pred, status, _ = port.compute_control(bad, ref, seq)
    jgrfs, _, _, jstatus, _ = jaxm.compute_control(bad, ref, seq)
    assert status == jstatus == 1
    np.testing.assert_array_equal(grfs, g0)
    assert not np.any(port.U_warm) and port._last is None
    np.testing.assert_allclose(grfs, jgrfs, rtol=0, atol=0.05)
    L = qp.cholesky(-torch.eye(4)[None])
    assert torch.isnan(L).all()
    # Finite inputs, a Newton matrix that is not positive definite (a negative
    # Levenberg-Marquardt term): the NaN factor reaches the same fallback.
    _, bad_cfg = _cfgs(**{"mpc.gradient.levenberg_marquardt": -1e4})
    broken = GradientMPC(bad_cfg, device="cpu")
    broken.previous_grfs = g0.copy()
    grfs, _, _, status, _ = broken.compute_control(state, ref, seq)
    assert status == 1
    np.testing.assert_array_equal(grfs, g0)


def test_batched_gait_candidates_match_jax():
    """BatchedGradientMPC.optimize_gait: the K candidate solves as one batch of K:
    the penalized costs to 1e-3 relative of JAX's vmapped solve, and the same best
    frequency."""
    jc, tc = _cfgs(**{"mpc.optimize_step_freq": True})
    _, state, ref, _ = _scenarios()["trot_nominal"]
    freqs = np.asarray(jc.mpc.step_freq_available, np.float32)
    for phase in ([0.1, 0.6, 0.6, 0.1], [0.45, 0.95, 0.95, 0.45]):
        ph = np.tile(np.asarray(phase, np.float32), (len(freqs), 1))
        seqs = np.asarray(jax_contact_sequence(jnp.asarray(ph), jnp.asarray(freqs), 0.65,
                                               jnp.asarray(jax_timer_dts(jc.mpc))))
        jcosts, jbest = JaxBatched(jc).optimize_gait(state, ref, seqs)
        costs, best = BatchedGradientMPC(tc, device="cpu").optimize_gait(state, ref, seqs)
        assert costs.shape == (len(freqs),)
        np.testing.assert_allclose(costs, jcosts, rtol=1e-3)
        assert best == jbest


# The JAX package's nominal walks that PERF.md's closed-loop table quotes beside
# the port's on the card (chip_smoke.py phase 21): 3 s at 0.3 m/s.
WALKS = ("blind", "rti", "tamols_step")


def reference_walks(rows=WALKS, duration=3.0, vel=(0.3, 0.0, 0.0)):
    """(row, walked m, min z m, max |roll|,|pitch| rad, apex calls, mean z of the
    second half - ref_z m) of the JAX package's SRB harness with the nominal
    gradient MPC: "blind"; "rti" (use_RTI, the preparation dispatched after each
    solve, as the wrapper does; chip_smoke.py drives the port's harness so too);
    "tamols_step" (the default configuration, TAMOLS footholds, onto a 5 cm step at
    x > 0.6 m, sensed as tests/test_torch_tamols.py's reference walks sense)."""
    from test_torch_tamols import JaxHarness, _count_calls, _sense_jax, step_up

    out = []
    for row in rows:
        over = {} if row == "tamols_step" else {"sim.visual_foothold_adaptation": "blind"}
        if row == "rti":
            over["mpc.gradient.use_RTI"] = True
        cfg = jax_make_config("aliengo", mpc_type="nominal", **over)
        fn = step_up if row == "tamols_step" else None
        h = JaxHarness(cfg, seed=0, terrain_fn=fn)
        calls = [0] if h.wb.vfa is None else _count_calls(h.wb.vfa)
        if row == "rti":
            solve = h.ctrl.compute_control

            def compute_control(*a, **kw):
                result = solve(*a, **kw)
                h.ctrl.compute_rti()
                return result

            h.ctrl.compute_control = compute_control
        n = int(round(duration / cfg.sim.dt))
        hist = np.zeros((n, 12))
        for i in range(n):
            hms = None if fn is None else _sense_jax(h.wb, fn, h.x[8], cfg.tamols)
            hist[i] = h.step(np.asarray(vel), heightmaps=hms)
        z = hist[:, 2]
        out.append((row, hist[-1, 0] - hist[0, 0], z.min(), np.abs(hist[:, 6:8]).max(),
                    calls[0], np.mean(z[n // 2:]) - cfg.sim.ref_z))
    return out


if __name__ == "__main__":
    import sys

    import conftest  # noqa: F401

    for r in reference_walks([WALKS[int(a)] for a in sys.argv[1:]] or WALKS):
        print("%s: walked %.4f m, min z %.4f m, max |roll|,|pitch| %.4f rad, %d apex calls, "
              "mean z - ref_z %+.4f m" % r, flush=True)
