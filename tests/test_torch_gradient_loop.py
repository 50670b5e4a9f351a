"""The port's nominal gradient MPC in its loops, against the JAX package on the
CPU: the controller's knob sets over a few ticks, the SRB closed loop, the
wrapper on the recorded MuJoCo trace, the soft-constrained QP and the QP-based
IK. Both sides get the same inputs, made from numpy seeds or the recorded trace;
the JAX side runs on the CPU as its own tests do."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu.controllers.gradient import GradientMPC as JaxMPC
from quadruped_pympc_tamols_tpu.controllers.gradient import qp as jqp
from quadruped_pympc_tamols_tpu.controllers.gradient.sqp import make_rti_solver_split as jax_split
from quadruped_pympc_tamols_tpu.controllers.gradient.sqp import qp_solver_for as jax_solver_for
from quadruped_pympc_tamols_tpu.interfaces import QuadrupedPyMPCWrapper as JaxWrapper
from quadruped_pympc_tamols_tpu.kinematics.ik_solvers import QPIK as JaxQPIK
from quadruped_pympc_tamols_tpu.planner.heightmap import GridHeightMap as JaxGrid
from quadruped_pympc_tamols_tpu.sim import SRBClosedLoopHarness as JaxHarness
from quadruped_pympc_tamols_tpu.utils.legs import Legs as JaxLegs
from quadruped_pympc_tamols_tpu.utils.verification import soft_qp_augment_np
from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.controllers.gradient import (GradientMPC, make_rti_solver_split,
                                                               qp, qp_solver_for)
from quadruped_pympc_tamols_torch.interfaces import QuadrupedPyMPCWrapper, WBInterface
from quadruped_pympc_tamols_torch.interop import config_from_dict, set_gradient_state
from quadruped_pympc_tamols_torch.kinematics import QPIK
from quadruped_pympc_tamols_torch.sim import SRBClosedLoopHarness
from quadruped_pympc_tamols_torch.sim.trace import ControlTrace
from quadruped_pympc_tamols_torch.utils.legs import Legs
from quadruped_pympc_tamols_torch.utils.verification import pdip_solve_np_f64
from jax_references import check_inputs, digest
from jax_references import load as load_jax
from test_golden_traces import _ref, _state, _trot_seq

torch.set_num_threads(1)
BLIND = {"sim.visual_foothold_adaptation": "blind"}
GRF_ATOL = 0.05  # N: float32 interior points that converge, in two libraries
F64_FLOOR = 0.01  # N: the floor of the first-stage GRF bound against float64
HM_RTOL = 1e-4  # the assembled QP's tolerance (tests/test_torch_gradient.py: QP_RTOL)
KNOB_TICKS = 5
# Knob sets of the nominal controller: (config overrides, compute_control
# arguments, the call whose QPs the float64 route holds, or None: "solve", or
# "prepare" for the QP of AS-RTI-A's extra iteration).
KNOBS = {
    "integrators": ({"mpc.gradient.use_integrators": True}, {}, None),
    "wrench": ({}, {"external_wrenches": np.array([25.0, -15.0, 10.0, 2.0, -3.0, 1.0])}, None),
    "inertia_mass": ({}, {"inertia": np.diag([0.09, 0.28, 0.31]) + 0.004, "mass": 26.5}, None),
    "speed": ({"mpc.gradient.solver_mode": "speed"}, {}, None),
    "crazy_speed": ({"mpc.gradient.solver_mode": "crazy_speed"}, {}, None),
    "basic": ({"mpc.gradient.qp_algorithm": "basic"}, {}, "solve"),
    "as_rti_a": ({"mpc.gradient.use_RTI": True, "mpc.gradient.as_rti_type": "AS-RTI-A"}, {},
                 "prepare"),
}


def _cfgs(mpc_type="nominal", **over):
    jc = jax_make_config("aliengo", mpc_type=mpc_type, **over)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _record(mpc, name):
    """Wrap mpc.<name> (solve or prepare) to record its first six host inputs (the
    arguments of the one-shot assembler, whose QP that call solves first) and its
    output, as numpy copies (the port's outputs on the CPU may alias its buffers)."""
    fn, records = getattr(mpc, name), []

    def recorded(*a):
        out = fn(*a)
        records.append(([np.array(x, np.float32) for x in a[:6]],
                        type(out)(*(np.array(x, np.float32) for x in out))))
        return out

    setattr(mpc, name, recorded)
    return records


def _jax_qp(jc):
    """The JAX package's one-shot assembler and QP solve, on numpy arrays."""
    *_, assemble = jax_split(jc, return_assembler=True)
    fn, iters = jax_solver_for(jc.mpc.gradient)
    solve = jax.jit(lambda *q: fn(*q, iters=iters).z)
    return (lambda r: [np.asarray(a) for a in assemble(*r)]), (lambda q: np.asarray(solve(*q)))


def _port_qp(tc):
    """The port's one-shot assembler and QP solve on the CPU, on numpy arrays."""
    *_, assemble = make_rti_solver_split(tc, return_assembler=True, device="cpu")
    fn, iters = qp_solver_for(tc.mpc.gradient, "cpu")
    return (lambda r: [a[0].numpy() for a in assemble(*(torch.from_numpy(x)[None] for x in r))],
            lambda q: fn(*(torch.from_numpy(a.copy())[None] for a in q),
                         iters=iters).z[0].numpy())


def _f64_gaps(records, assemble, solve):
    """First-stage GRF gap to the float64 reference of each recorded QP, solved
    again from the recorded inputs."""
    gaps = []
    for ins, _ in records:
        q = assemble(ins)
        gaps.append(float(np.abs(solve(q)[:12] - pdip_solve_np_f64(*q)[0][:12]).max()))
    return np.asarray(gaps)


def _extra_iteration_gaps(records, assemble):
    """AS-RTI-A's extra iteration, from the recorded preparations' own output: it
    solves the QP of the predicted state at the warm start and linearizes again at
    Ubar = U_warm + z. First-stage gap of that z to the float64 solution of the
    same QP."""
    gaps = []
    for ins, prep in records:
        z = (prep.Ubar.reshape(ins[5].shape) - ins[5]).reshape(-1)
        z64 = pdip_solve_np_f64(*assemble(ins))[0]
        gaps.append(float(np.abs(z[:12] - z64[:12]).max()))
    return np.asarray(gaps)


def _knob_ticks(jc):
    """The KNOB_TICKS ticks of test_knob_sets_match_jax: (state, ref, seq) of a trot
    with the state drifting and the contact sequence rolling."""
    rng = np.random.default_rng(7)
    seq0 = _trot_seq(jc.mpc.horizon)
    return [(_state(pos=(0.01 * k, 0.0, 0.31 + 0.005 * k), vel=rng.normal([0.2, 0, 0], 0.05),
                    rpy=rng.normal(0, 0.03, 3), omega=rng.normal(0, 0.1, 3)),
             _ref(jc, vel=(0.3, 0, 0)), np.roll(seq0, -k, axis=1)) for k in range(KNOB_TICKS)]


def _tick_arrays(ticks) -> list:
    """The ticks' dicts as (key, array) pairs, for the recording's digest."""
    return [[sorted(st.items()), sorted(ref.items()), seq] for st, ref, seq in ticks]


def jax_knob_references() -> dict:
    """The JAX package's side of test_knob_sets_match_jax (tests/jax_references.py):
    each knob set's controller over its ticks (GRFs, status and integral a tick)
    and, for the float64 route, its first-stage gaps to float64 on its own QPs."""
    out = {}
    for knobs, (over, kwargs, route) in KNOBS.items():
        jc, _ = _cfgs(**over)
        jaxm = JaxMPC(jc)
        jrec = _record(jaxm, route) if route else None
        ticks = _knob_ticks(jc)
        rows = []
        for state, ref, seq in ticks:
            want = jaxm.compute_control(state, ref, seq, **kwargs)
            rows.append((np.asarray(want[0], np.float32), int(want[3]),
                         np.asarray(jaxm.integral, np.float32)))
            if jc.mpc.gradient.use_RTI:
                jaxm.compute_rti_prepare()
        out[f"{knobs}/grfs"] = np.stack([r[0] for r in rows])
        out[f"{knobs}/status"] = np.array([r[1] for r in rows])
        out[f"{knobs}/integral"] = np.stack([r[2] for r in rows])
        if route == "solve":
            out[f"{knobs}/gaps"] = _f64_gaps(jrec, *_jax_qp(jc))
        elif route == "prepare":
            out[f"{knobs}/gaps"] = _extra_iteration_gaps(jrec, _jax_qp(jc)[0])
        out[f"digest/{knobs}"] = digest(jc, sorted(kwargs.items()), _tick_arrays(ticks))
    return out


def _assert_no_less_accurate(tgaps, jgaps, label):
    """The float64 route: over the recorded QPs, the port's largest and mean
    first-stage gaps to float64 are at most max(2 x the JAX package's, F64_FLOOR)."""
    for stat in (np.max, np.mean):
        assert stat(tgaps) <= max(2 * stat(jgaps), F64_FLOOR), (label, stat.__name__, tgaps,
                                                                jgaps)


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_knob_sets_match_jax(knobs):
    """KNOB_TICKS ticks of a trot with the state drifting and the contact sequence
    rolling, each controller carrying its own warm start: the same status and the
    integral to 1e-6; GRFs within GRF_ATOL where every QP converges. The basic
    interior point (18 iterations) and AS-RTI-A's extra iteration (a QP at the
    predicted state) stop at the float32 floor: the JAX package's own GRFs on
    these ticks lie 0.3-4.2 N and 1.2-3.3 N off float64, so two float32
    implementations part by ~1 N there, and the float64 route holds them
    (``_assert_no_less_accurate``). For "basic", on the QPs of ``solve`` solved
    again from its inputs; for AS-RTI-A, on what each preparation's extra
    iteration produced (``_extra_iteration_gaps``), with the port's Hessian at
    the point it reached held to the JAX package's at the same point. With
    use_RTI both run the split: the preparation after each tick, the feedback
    phase on the next. The JAX side is recorded (``jax_knob_references``); the
    Hessian at the port's point is the JAX assembler's, live."""
    over, kwargs, route = KNOBS[knobs]
    jc, tc = _cfgs(**over)
    port = GradientMPC(tc, device="cpu")
    if route:
        trec = _record(port, route)
    ticks = _knob_ticks(jc)
    rec = load_jax("knobs")
    check_inputs(rec, knobs, jc, sorted(kwargs.items()), _tick_arrays(ticks))
    for k, (state, ref, seq) in enumerate(ticks):
        got = port.compute_control(state, ref, seq, **kwargs)
        assert got[3] == rec[f"{knobs}/status"][k] == 0, (knobs, k)
        if not route:
            np.testing.assert_allclose(got[0], rec[f"{knobs}/grfs"][k], rtol=0, atol=GRF_ATOL,
                                       err_msg=f"{knobs} tick {k}")
        np.testing.assert_allclose(port.integral, rec[f"{knobs}/integral"][k], rtol=0,
                                   atol=1e-6)
        if jc.mpc.gradient.use_RTI:
            assert port.compute_rti_prepare() is not None
    assert port.integral.any() == jc.mpc.gradient.use_integrators
    if route == "solve":
        assert len(trec) == len(rec[f"{knobs}/gaps"]) == KNOB_TICKS
        _assert_no_less_accurate(_f64_gaps(trec, *_port_qp(tc)), rec[f"{knobs}/gaps"], knobs)
    elif route == "prepare":
        assert len(trec) == len(rec[f"{knobs}/gaps"]) == KNOB_TICKS
        (tasm, _), (jasm, _) = _port_qp(tc), _jax_qp(jc)
        _assert_no_less_accurate(_extra_iteration_gaps(trec, tasm), rec[f"{knobs}/gaps"], knobs)
        for ins, prep in trec:
            # Linearized again where the extra iteration landed: the preparation's
            # Hessian is the JAX package's at the same point.
            want = jasm([*ins[:5], prep.Ubar[0]])[0]
            np.testing.assert_allclose(prep.Hm[0], want, rtol=0,
                                       atol=HM_RTOL * np.abs(want).max())


def test_gradient_state_carries_across():
    """Three trot ticks of the JAX controller with integral action; a fresh port
    controller given its state (interop.set_gradient_state) computes the fourth
    tick's GRFs within GRF_ATOL of JAX's and the same integral."""
    jc, tc = _cfgs(**{"mpc.gradient.use_integrators": True})
    jaxm = JaxMPC(jc)
    seq0 = _trot_seq(jc.mpc.horizon)
    ticks = [(_state(pos=(0.01 * k, 0.0, 0.31), vel=(0.2, 0.02 * k, 0)),
              _ref(jc, vel=(0.3, 0, 0)), np.roll(seq0, -k, axis=1)) for k in range(4)]
    for tick in ticks[:3]:
        jaxm.compute_control(*tick)
    port = set_gradient_state(GradientMPC(tc, device="cpu"), jaxm.U_warm, jaxm.previous_grfs,
                              jaxm.integral)
    assert np.any(port.U_warm) and np.any(port.integral)
    got, want = port.compute_control(*ticks[3]), jaxm.compute_control(*ticks[3])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=GRF_ATOL)
    np.testing.assert_allclose(port.integral, jaxm.integral, rtol=0, atol=1e-6)


LOOP_VEL = np.array([0.3, 0.0, 0.0])
LOOP_SEED, LOOP_S = 0, 1.0


def jax_closed_loop() -> dict:
    """The JAX package's side of test_closed_loop_matches_jax (tests/jax_references.py):
    its SRB harness's 1 s history, nominal, blind, 0.3 m/s."""
    jc, _ = _cfgs(**BLIND)
    return {"history": np.asarray(JaxHarness(jc, seed=LOOP_SEED).run(LOOP_S, LOOP_VEL)),
            "digest/loop": digest(jc, LOOP_SEED, LOOP_S, LOOP_VEL)}


def test_closed_loop_matches_jax():
    """1 s of the SRB harness with the nominal controller, blind, 0.3 m/s, against
    the JAX harness's (recorded): base states to 1e-3 (the plants integrate in
    float32 and the swing curves run in float32 on the JAX side, float64 in the
    port), and the robot moved."""
    jc, tc = _cfgs(**BLIND)
    rec = load_jax("nominal_loop")
    check_inputs(rec, "loop", jc, LOOP_SEED, LOOP_S, LOOP_VEL)
    jhist = rec["history"]
    thist = SRBClosedLoopHarness(tc, seed=LOOP_SEED, device="cpu").run(LOOP_S, LOOP_VEL)
    np.testing.assert_allclose(thist, jhist, rtol=0, atol=1e-3)
    assert thist[-1, 0] - thist[0, 0] > 0.2


def _jax_hms(hms):
    return None if hms is None else JaxGrid(*(jnp.asarray(getattr(hms, leaf).numpy())
                                              for leaf in ("center", "yaw", "resolution",
                                                           "heights")))


def test_wrapper_on_the_recorded_trace_matches_jax():
    """The first 100 steps (20 MPC ticks) of the recorded MuJoCo trace through
    both packages' QuadrupedPyMPCWrapper with the nominal controller, each solving
    its own ticks: the first tick's GRFs within GRF_ATOL (the same inputs), finite
    torques, and the float64 route over every tick's QP. On these real ticks the
    JAX package's own first-stage GRFs lie up to ~10 N off float64, and a tick
    where the two float32 solves part carries on through the warm start, so later
    ticks are not compared with each other."""
    trace = ControlTrace()
    recorded = config_from_dict(trace.config)
    tc = dataclasses.replace(recorded, mpc=dataclasses.replace(recorded.mpc, type="nominal"))
    jc = jax_make_config("aliengo", mpc_type="nominal", **{"sim.visual_foothold_adaptation":
                                                          tc.sim.visual_foothold_adaptation})
    assert config_from_dict(dataclasses.asdict(jc)) == tc
    feet0 = trace.arrays["feet_pos"][0]
    tw = QuadrupedPyMPCWrapper(tc, Legs(feet0.copy()), device="cpu")
    jw = JaxWrapper(jc, JaxLegs(feet0.copy()))
    trec = _record(tw.srbd_controller_interface.controller, "solve")
    jrec = _record(jw.srbd_controller_interface.controller, "solve")
    for i in range(100):
        kw = trace.inputs(i)
        jkw = {k: JaxLegs(v.data.copy()) if isinstance(v, Legs) else v for k, v in kw.items()}
        jkw["heightmaps"] = _jax_hms(kw["heightmaps"])
        tau = tw.compute_actions(**kw)
        jw.compute_actions(**jkw)
        if i == 0:
            np.testing.assert_allclose(tw.nmpc_GRFs.data, np.asarray(jw.nmpc_GRFs.data),
                                       rtol=0, atol=GRF_ATOL)
        assert np.all(np.isfinite(tau.data))
    assert len(trec) == len(jrec) == 20
    _assert_no_less_accurate(_f64_gaps(trec, *_port_qp(tc)), _f64_gaps(jrec, *_jax_qp(jc)),
                             "wrapper")


def test_soft_qp_matches_jax():
    """soft_qp_solve (8 iterations, its default) on four seeded random strictly
    convex QPs whose slacked rows include an infeasible pair, the soft path's
    reason to exist. Its iterate stops 0.15-0.55 short of the float64 solution of
    the augmented problem in the JAX package too, so the float64 route holds it:
    the port's gap at most max(2 x JAX's, F64_FLOOR), on each problem."""
    n, m = 12, 20
    for seed in range(4):
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(n, n))
        Hm = (A @ A.T + np.eye(n)).astype(np.float32)
        g = rng.normal(size=n).astype(np.float32)
        C = rng.normal(size=(m, n)).astype(np.float32)
        d = rng.uniform(0.5, 2.0, size=m).astype(np.float32)
        C[1], d[1] = -C[0], -d[0] - 0.5  # rows 0 and 1 cannot both hold
        S = np.zeros((m, 2), np.float32)
        S[0, 0] = S[1, 1] = 1.0
        z64 = pdip_solve_np_f64(*soft_qp_augment_np(Hm, g, C, d, S))[0][:n]
        jz = np.asarray(jqp.soft_qp_solve(*(jnp.asarray(a) for a in (Hm, g, C, d)), S).z)
        z = qp.soft_qp_solve(*(torch.from_numpy(a)[None] for a in (Hm, g, C, d)), S).z[0].numpy()
        assert z.shape == (n,) and np.all(np.isfinite(z))
        assert np.abs(z - z64).max() <= max(2 * np.abs(jz - z64).max(), F64_FLOOR), seed


def test_qp_ik_matches_jax():
    """QPIK (sim.ik_solver="qp"): 20 random hip-frame targets and 10 world-frame
    ticks warm-started from the last solution, joints within 1e-5 rad of the JAX
    package's; the whole-body interface builds with it."""
    jc, tc = _cfgs("sampling")
    jik, tik = JaxQPIK(jc.robot), QPIK(tc.robot)
    np.testing.assert_array_equal(tik.q_seed, np.asarray(jik.q_seed))
    rng = np.random.default_rng(2)
    for _ in range(20):
        p = tik.legs.fk_all(tik.q_seed) + rng.normal(0, 0.08, (4, 3))
        np.testing.assert_allclose(tik.solve_hip_frame(p), np.asarray(jik.solve_hip_frame(p)),
                                   rtol=0, atol=1e-5)
    nominal = np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0], [-0.25, 0.15, 0.0],
                        [-0.25, -0.15, 0.0]])
    for _ in range(10):
        feet = nominal + rng.normal(0, 0.05, (4, 3))
        base, rpy = np.array([0.0, 0.0, 0.33]) + rng.normal(0, 0.02, 3), rng.normal(0, 0.1, 3)
        np.testing.assert_allclose(tik.compute_solution(base, rpy, *feet),
                                   jik.compute_solution(base, rpy, *feet), rtol=0, atol=1e-5)
    cfg = make_config("aliengo", **{"sim.ik_solver": "qp"})
    assert isinstance(WBInterface(cfg, Legs(nominal.copy()), device="cpu").ik, QPIK)
