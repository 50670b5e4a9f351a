"""The port's gradient variants in their loops, against the JAX package on the
CPU: the foothold optimizer's stance-proximity freeze and box, the kinodynamic
joint trajectories reaching the whole-body layer through the interface and the
wrapper, the failure fallback, a variant controller's state carried across
mid-walk, short SRB closed loops and a short MuJoCo run of the kinodynamic
controller. Both sides get the same inputs, made from numpy seeds or the
recorded trace; the JAX side runs on the CPU as its own tests do.

Tolerances: GRFs within GRF_ATOL where the QPs converge (float32 interior points
in two libraries), states within STATE_ATOL over the closed loops (float32
plants; the swing curves run in float32 on the JAX side, float64 in the port),
rollouts within 1e-4 m. ``python tests/test_torch_variants_loop.py [row ...]``
prints the JAX package's variant walks for PERF.md (chip_smoke.py's
``JAX_CPU_VARIANT_WALKS``), and ``... f64`` what the float64 routes see
(``report_float64_routes``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu.controllers.gradient import variants as jv
from quadruped_pympc_tamols_tpu.interfaces import QuadrupedPyMPCWrapper as JaxWrapper
from quadruped_pympc_tamols_tpu.planner.heightmap import GridHeightMap as JaxGrid
from quadruped_pympc_tamols_tpu.sim import SRBClosedLoopHarness as JaxHarness
from quadruped_pympc_tamols_tpu.utils.legs import Legs as JaxLegs
from quadruped_pympc_tamols_torch.controllers.gradient import variants as tv
from quadruped_pympc_tamols_torch.dynamics.srbd import make_params
from quadruped_pympc_tamols_torch.interfaces import QuadrupedPyMPCWrapper
from quadruped_pympc_tamols_torch.interop import config_from_dict, set_variant_state
from quadruped_pympc_tamols_torch.sim import SRBClosedLoopHarness
from quadruped_pympc_tamols_torch.sim.trace import ControlTrace
from quadruped_pympc_tamols_torch.utils.legs import Legs
from jax_references import check_inputs, digest
from jax_references import load as load_jax
from test_golden_traces import _ref, _state, _trot_seq
from test_torch_variants import ENSEMBLE, assert_no_less_accurate, perturbed, solver_gaps_to_f64

torch.set_num_threads(1)
# One BLAS thread for the float64 references: the suite runs files side by side.
threadpool_limits(1)
BLIND = {"sim.visual_foothold_adaptation": "blind"}
GRF_ATOL = 0.05  # N
STATE_ATOL = 1e-3
LOOP_STEPS = 100  # 0.2 s, 20 MPC ticks
KINO_STATE_ATOL = 0.03  # the kinodynamic MuJoCo run, measured 0.0105 (see its test)
LEGS = ("FL", "FR", "RL", "RR")


def _cfgs(mpc_type="nominal", **over):
    jc = jax_make_config("aliengo", mpc_type=mpc_type, **over)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _standing(cfg):
    """tests/test_gradient_variants.py:_standing at the reference height."""
    return _state(pos=(0.0, 0.0, cfg.sim.ref_z)), _ref(cfg)


def test_foothold_proximity_freeze_and_box_match_jax():
    """use_foothold_optimization with boxes: FR touches down at stage 5 under a
    lateral drift. The foot state does not move across stage 4 -> 5 (the
    stance-proximity gate), it moves earlier, the optimized touch-down stays in
    its box, and the rollout (last_X) and footholds match the JAX package's."""
    jc, tc = _cfgs(**{"mpc.gradient.use_foothold_optimization": True,
                      "mpc.gradient.use_foothold_constraints": True})
    state, ref = _standing(jc)
    state["linear_velocity"] = np.array([0.5, 0.2, 0.0])
    ref["ref_foot_FR"] = (state["foot_FR"] + [0.06, 0.0, 0.0])[None]
    seq = np.ones((4, jc.mpc.horizon))
    seq[1, :5] = 0.0
    port, jaxm = tv.VariantGradientMPC(tc, "nominal", device="cpu"), jv.VariantGradientMPC(jc,
                                                                                          "nominal")
    g, fh, _, status, _ = port.compute_control(state, ref, seq)
    jg, jfh, _, jstatus, _ = jaxm.compute_control(state, ref, seq)
    assert status == jstatus == 0
    fr = port.last_X[:, 15:18]
    np.testing.assert_allclose(fr[5], fr[4], rtol=0, atol=1e-6)
    assert np.linalg.norm(fr[4] - fr[0]) > 1e-4
    hw = np.asarray(tc.mpc.gradient.foothold_box_halfwidth)
    assert np.all(np.abs(fh[1, :2] - ref["ref_foot_FR"][0, :2]) <= hw + 1e-5)
    np.testing.assert_allclose(port.last_X, jaxm.last_X, rtol=0, atol=1e-4)
    np.testing.assert_allclose(fh, jfh, rtol=0, atol=1e-4)
    np.testing.assert_allclose(g, jg, rtol=0, atol=GRF_ATOL)


def _recorded(mpc):
    """Wrap mpc.solve to record its host inputs and output (numpy copies)."""
    fn, records = mpc.solve, []

    def solve(*a):
        out = fn(*a)
        records.append(([np.array(x, np.float32) for x in a], [np.array(x) for x in out]))
        return out

    mpc.solve = solve
    return records


def _tick_qps(tc, variant, records):
    """The QP of each recorded solve, assembled again by the port from its inputs."""
    spec = tv.make_spec(tc, variant, make_params(tc))
    _, _, assemble, _ = tv.make_variant_solver(tc, spec, return_assembler=True, device="cpu")
    return [[a.numpy() for a in assemble(*(torch.from_numpy(a) for a in ins))]
            for ins, _ in records]


def _forces(tc, variant):
    """The first stage's force inputs in z: the GRFs, or input_rates' rates."""
    nu = tv.make_spec(tc, variant, make_params(tc)).nu
    return slice(nu - 12, nu)


def _same_or_f64(tc, variant, trec, jrec, got, want, label):
    """One tick solved from the same inputs by both packages: GRFs within
    GRF_ATOL, or, where the float32 iterates part, the float64 route on its QP
    and ENSEMBLE perturbed copies."""
    if np.abs(np.asarray(got) - np.asarray(want)).max() > GRF_ATOL:
        q = _tick_qps(tc, variant, trec[-1:])[0]
        assert_no_less_accurate(solver_gaps_to_f64(perturbed(q, ENSEMBLE),
                                                   _forces(tc, variant)), label)


def _jax_hms(hms):
    return None if hms is None else JaxGrid(*(jnp.asarray(getattr(hms, leaf).numpy())
                                              for leaf in ("center", "yaw", "resolution",
                                                           "heights")))


def test_kinodynamic_joints_reach_the_wb_layer_through_the_wrapper():
    """The recorded MuJoCo trace (real joint angles) through both packages'
    QuadrupedPyMPCWrapper with the kinodynamic controller, 15 steps (3 MPC
    ticks): the interface hands the OCP's joint trajectories on, the whole-body
    layer's joint targets are their first stage (within the saturation), the
    torques stay finite, and the solves hold through float64 on the same
    matrices (these QPs sit near the float32 floor: both packages' first-stage
    GRFs lie up to ~0.07 N off float64, and two float32 solves part there): the
    QPs of the three ticks each package solved, each solved by both.""" 
    trace = ControlTrace()
    recorded = config_from_dict(trace.config)
    tc = dataclasses.replace(recorded, mpc=dataclasses.replace(recorded.mpc, type="kinodynamic"))
    jc = jax_make_config("aliengo", mpc_type="kinodynamic", **{
        "sim.visual_foothold_adaptation": tc.sim.visual_foothold_adaptation})
    assert config_from_dict(dataclasses.asdict(jc)) == tc
    feet0 = trace.arrays["feet_pos"][0]
    tw = QuadrupedPyMPCWrapper(tc, Legs(feet0.copy()), device="cpu")
    jw = JaxWrapper(jc, JaxLegs(feet0.copy()))
    trec = _recorded(tw.srbd_controller_interface.controller)
    jrec = _recorded(jw.srbd_controller_interface.controller)
    for i in range(15):
        kw = trace.inputs(i)
        jkw = {k: JaxLegs(v.data.copy()) if isinstance(v, Legs) else v for k, v in kw.items()}
        jkw["heightmaps"] = _jax_hms(kw["heightmaps"])
        tau = tw.compute_actions(**kw)
        jw.compute_actions(**jkw)
        assert np.all(np.isfinite(tau.data))
        joints = tw.srbd_controller_interface.nmpc_joints_pos
        assert joints is not None and joints.shape == (tc.mpc.horizon, 12)
        q_now = np.asarray(kw["qpos_js"].data).reshape(4, 3)
        want = q_now + np.clip(joints[0].reshape(4, 3) - q_now, -3.0, 3.0)
        np.testing.assert_allclose(np.asarray(tw.des_joints_pos.data).reshape(4, 3), want,
                                   rtol=0, atol=1e-6)
    assert len(trec) == len(jrec) == 3
    qps = _tick_qps(tc, "kinodynamic", trec) + _tick_qps(tc, "kinodynamic", jrec)
    assert_no_less_accurate(solver_gaps_to_f64(qps, _forces(tc, "kinodynamic")),
                            "kinodynamic wrapper")


@pytest.mark.parametrize("variant", ["input_rates", "kinodynamic"])
def test_nan_state_takes_the_fallback(variant):
    """A NaN state: status 1 in both packages, the previous tick's GRFs, the warm
    start zeroed and last_X kept; input_rates' GRFs within GRF_ATOL of the JAX
    package's (the kinodynamic tick's joint velocities are held through float64
    in the wrapper test)."""
    jc, tc = _cfgs(variant)
    state, ref = _state(vel=(0.2, 0, 0)), _ref(jc, vel=(0.3, 0, 0))
    for leg in LEGS:
        state[f"joint_{leg}"] = np.array([0.0, 0.8, -1.5])
    seq = _trot_seq(jc.mpc.horizon)
    port, jaxm = tv.VariantGradientMPC(tc, variant, device="cpu"), jv.VariantGradientMPC(jc,
                                                                                        variant)
    g0 = port.compute_control(state, ref, seq)[0]
    jaxm.compute_control(state, ref, seq)
    X0 = port.last_X.copy()
    bad = dict(state, position=np.array([np.nan, 0.0, 0.32]))
    grfs, _, _, status, _ = port.compute_control(bad, ref, seq)
    jgrfs, _, _, jstatus, _ = jaxm.compute_control(bad, ref, seq)
    assert status == jstatus == 1
    np.testing.assert_array_equal(grfs, g0)
    np.testing.assert_array_equal(port.last_X, X0)
    assert not np.any(port.U_warm) and not np.any(jaxm.U_warm)
    if variant == "input_rates":
        np.testing.assert_allclose(grfs, jgrfs, rtol=0, atol=GRF_ATOL)


def test_variant_state_carries_across_mid_walk():
    """50 steps (10 ticks) of the JAX package's SRB harness with the input_rates,
    collaborative and lyapunov controllers; a fresh port controller given each
    one's state (interop.set_variant_state: warm start, the force, arm-wrench or
    z1/z2/phi states, previous GRFs) hands its solve the JAX controller's inputs
    (to 1e-6) and returns its GRFs within GRF_ATOL, or where the float32
    iterates part (the JAX package's collaborative iterate stops short of
    float64 on this tick) holds through float64 on the tick's QP and perturbed
    copies; lyapunov's phi update to 1e-6.""" 
    for variant in ("input_rates", "collaborative", "lyapunov"):
        jc, tc = _cfgs(variant, **BLIND)
        h = JaxHarness(jc, seed=0)
        jaxm = h.ctrl.controller
        calls = []
        solve = jaxm.compute_control

        def recorded(*a, **kw):
            calls.append((a, kw))
            return solve(*a, **kw)

        jaxm.compute_control = recorded
        for _ in range(50):  # input_rates fails to factor on tick 2 (queue 3)
            h.step(np.array([0.3, 0.0, 0.0]))
        jaxm.compute_control = solve
        a, kw = calls[-1]
        port = set_variant_state(tv.VariantGradientMPC(tc, variant, device="cpu"),
                                 jaxm.U_warm, jaxm.extra_state, jaxm.previous_grfs)
        assert np.any(port.U_warm) and np.any(port.extra_state)
        trec, jrec = _recorded(port), _recorded(jaxm)
        got, want = port.compute_control(*a, **kw), jaxm.compute_control(*a, **kw)
        assert got[3] == want[3] == 0
        for x, y in zip(trec[0][0], jrec[0][0]):  # the same solver inputs
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
        if variant == "lyapunov":
            np.testing.assert_allclose(port.extra_state[6:9], jaxm.extra_state[6:9], rtol=0,
                                       atol=1e-6)
        _same_or_f64(tc, variant, trec, jrec, got[0], want[0], variant)


# Closed loops against the JAX harness: row -> (mpc_type, overrides, steps), rows
# of the walk table that walk in the JAX package. input_rates: its float32 QP
# (rate inputs, Levenberg-Marquardt scaled by 1e-3) fails to factor on ticks 2
# and 8 in both packages, which then take the fallback. lyapunov (60 steps) is
# held through float64: the two harnesses' states part by up to 0.03 within
# 0.4 s (`python tests/test_torch_variants_loop.py f64` prints both).
LOOPS = {"zmp": ("nominal", {"mpc.gradient.use_zmp_stability": True}, LOOP_STEPS),
         "input_rates": ("input_rates", {}, LOOP_STEPS),
         "lyapunov": ("lyapunov", {}, 60)}
F64_LOOPS = ("lyapunov",)


@pytest.mark.parametrize("row", list(LOOPS))
def test_closed_loop_matches_jax(row):
    """The SRB harness, blind, 0.3 m/s: base states within STATE_ATOL of the JAX
    harness's and the same ticks taking the fallback; for F64_LOOPS the float64
    route over every tick each harness solved, both bases upright (|roll|,
    |pitch| < 0.05 rad) and positions within 2 cm of each other: the QPs of every
    tick each harness solved, each solved by both packages."""
    mpc_type, over, steps = LOOPS[row]
    jc, tc = _cfgs(mpc_type, **BLIND, **over)
    vel = np.array([0.3, 0.0, 0.0])
    jh, th = JaxHarness(jc, seed=0), SRBClosedLoopHarness(tc, seed=0, device="cpu")
    jrec, trec = _recorded(jh.ctrl.controller), _recorded(th.ctrl.controller)
    jhist, thist = jh.run(steps * jc.sim.dt, vel), th.run(steps * tc.sim.dt, vel)
    assert len(trec) == len(jrec) == steps // th._mpc_every

    def failed(records):
        return [k for k, (_, out) in enumerate(records) if not np.all(np.isfinite(out[0]))]

    assert failed(trec) == failed(jrec), (failed(trec), failed(jrec))
    if row not in F64_LOOPS:
        np.testing.assert_allclose(thist, jhist, rtol=0, atol=STATE_ATOL)
        return
    qps = _tick_qps(tc, mpc_type, trec) + _tick_qps(tc, mpc_type, jrec)
    assert_no_less_accurate(solver_gaps_to_f64(qps, _forces(tc, mpc_type)), row)
    for hist in (thist, jhist):
        assert np.abs(hist[:, 6:8]).max() < 0.05
    np.testing.assert_allclose(thist[:, :3], jhist[:, :3], rtol=0, atol=0.02)


KINO_RUN = dict(episode_duration_s=0.2, ref_base_lin_vel=(0.0, 0.0), seed=0)


def test_kinodynamic_run_simulation_matches_jax():
    """run_simulation with the kinodynamic controller, 0.2 s of MuJoCo (20 MPC
    ticks) at zero commanded velocity, against the JAX package's on the CPU
    (recorded):
    neither fell, and the base states stay within KINO_STATE_ATOL of each other.
    The float32 joint velocities of these ticks sit at their floor in both
    packages (the wrapper test above holds their solves through float64), and
    the joint targets they set part the two MuJoCo states by up to 0.011 (rad/s,
    on the angular velocity; 1e-4 m on the position) in 0.2 s (``... f64``), so
    the states are not held to STATE_ATOL."""
    pytest.importorskip("mujoco")
    from quadruped_pympc_tamols_torch.sim import simulation

    jc, tc = _cfgs("kinodynamic", **BLIND)
    jres = load_jax("kinodynamic_run")
    check_inputs(jres, "run", jc, KINO_RUN)
    tres = simulation.run_simulation(tc, device="cpu", **KINO_RUN)[0]
    assert not tres.fell and not bool(jres["fell"])
    assert np.all(np.isfinite(tres.state_history))
    np.testing.assert_allclose(tres.state_history, jres["state_history"], rtol=0,
                               atol=KINO_STATE_ATOL)


def jax_kinodynamic_run() -> dict:
    """The JAX package's side of test_kinodynamic_run_simulation_matches_jax
    (tests/jax_references.py): its 0.2 s kinodynamic run_simulation, seed 0."""
    from quadruped_pympc_tamols_tpu.sim import simulation as jsim

    jc, _ = _cfgs("kinodynamic", **BLIND)
    jres = jsim.run_simulation(jc, **KINO_RUN)[0]
    return {"state_history": np.asarray(jres.state_history), "fell": np.asarray(jres.fell),
            "digest/run": digest(jc, KINO_RUN)}


# The variant walks of PERF.md's closed-loop table (3 s at 0.3 m/s, blind):
# row -> (mpc_type, gait, overrides).
WALKS = {"input_rates": ("input_rates", "trot", {}),
         "lyapunov": ("lyapunov", "trot", {}),
         "collaborative": ("collaborative", "trot", {}),
         "zmp": ("nominal", "trot", {"mpc.gradient.use_zmp_stability": True}),
         "foothold": ("nominal", "trot", {"mpc.gradient.use_foothold_optimization": True}),
         "ddp": ("nominal", "trot", {"mpc.gradient.use_DDP": True}),
         "static_crawl": ("nominal", "crawl", {"mpc.gradient.use_static_stability": True}),
         "foothold_constraints": ("nominal", "trot", {
             "mpc.gradient.use_foothold_optimization": True,
             "mpc.gradient.use_foothold_constraints": True}),
         "zmp_crawl": ("nominal", "crawl", {"mpc.gradient.use_zmp_stability": True})}


def reference_walks(rows=tuple(WALKS), duration=3.0, vel=(0.3, 0.0, 0.0)):
    """(row, walked m, min z m, max |roll|,|pitch| rad, mean z of the second half
    m) of the JAX package's SRB harness for each row of WALKS."""
    out = []
    for row in rows:
        mpc_type, gait, over = WALKS[row]
        cfg = jax_make_config("aliengo", mpc_type=mpc_type, gait=gait, **BLIND, **over)
        hist = JaxHarness(cfg, seed=0).run(duration, np.asarray(vel))
        n = len(hist)
        out.append((row, hist[-1, 0] - hist[0, 0], hist[:, 2].min(),
                    np.abs(hist[:, 6:8]).max(), np.mean(hist[n // 2:, 2])))
    return out


def report_float64_routes():
    """Print what the float64 routes of these tests see (ROADMAP queue 3): the
    first-stage gaps to float64 of both packages' 14-iteration solves on the
    golden F64_ROUTE ticks' QP ensembles (and the port's routed keys against the
    fixture) and on the kinodynamic wrapper's recorded ticks (the port's with
    and without cascade-summed residuals), the ticks each package's input_rates
    SRB loop falls back on (60 steps), and the largest state differences of the
    lyapunov SRB loop (0.4 s) and of the kinodynamic MuJoCo run (0.2 s, per
    state component)."""
    import test_torch_variants as tvar
    from quadruped_pympc_tamols_torch.controllers.gradient.qp import pdip_solve_mehrotra

    jc, tc = _cfgs()
    for name in tvar.F64_ROUTE:
        variant = name[len("trot_"):]
        state, ref, seq = tvar._golden_state(name)
        port = tv.VariantGradientMPC(tc, variant, device="cpu")
        rec = _recorded(port)
        cost = port.compute_control(state, ref, seq)[4]
        print(f"{name}: cost {cost:.4f}, golden fixture "
              f"{float(np.load(tvar.FIXTURE)[name + '/cost']):.4f}")
        _, _, jasm, _ = jv.make_variant_solver(jc, tvar._specs("nominal", {}, variant)[2],
                                               return_assembler=True)
        _, _, tasm, _ = tv.make_variant_solver(tc, port.spec, return_assembler=True,
                                               device="cpu")
        ins = rec[0][0]
        jq = [np.asarray(a) for a in jasm(*ins)]
        tq = [a.numpy() for a in tasm(*(torch.from_numpy(a) for a in ins))]
        gaps = tvar.solver_gaps_to_f64([jq, tq] + tvar.perturbed(jq, tvar.ENSEMBLE)[1:],
                                       slice(0, port.spec.nu))
        print(f"{name}: first-stage input gaps to float64 (port, JAX) on JAX's QP, the "
              f"port's, {tvar.ENSEMBLE} perturbed copies: {np.round(gaps, 4).tolist()}")
    trace = ControlTrace()
    recorded = config_from_dict(trace.config)
    kc = dataclasses.replace(recorded, mpc=dataclasses.replace(recorded.mpc, type="kinodynamic"))
    w = QuadrupedPyMPCWrapper(kc, Legs(trace.arrays["feet_pos"][0].copy()), device="cpu")
    rec = _recorded(w.srbd_controller_interface.controller)
    for i in range(25):
        w.compute_actions(**trace.inputs(i))
    qps = _tick_qps(kc, "kinodynamic", rec)
    forces = _forces(kc, "kinodynamic")
    gaps = tvar.solver_gaps_to_f64(qps, forces)
    plain = []
    for q in qps:
        z = pdip_solve_mehrotra(*(torch.from_numpy(np.array(a))[None] for a in q),
                                iters=14).z[0].numpy()
        plain.append(float(np.abs(z[forces] - tvar.pdip_solve_np_f64(*q)[0][forces]).max()))
    print(f"kinodynamic wrapper, 5 recorded ticks: GRF gaps to float64, port (cascade) "
          f"{np.round(gaps[:, 0], 4).tolist()}, port (matmuls) {np.round(plain, 4).tolist()}, "
          f"JAX {np.round(gaps[:, 1], 4).tolist()}")
    vel = np.array([0.3, 0.0, 0.0])
    ji, ti = _cfgs("input_rates", **BLIND)
    for label, h in (("port", SRBClosedLoopHarness(ti, seed=0, device="cpu")),
                     ("JAX", JaxHarness(ji, seed=0))):
        rec = _recorded(h.ctrl.controller)
        h.run(60 * ji.sim.dt, vel)
        print(f"input_rates SRB loop, 60 steps, {label}: fallback on ticks "
              f"{[k for k, (_, out) in enumerate(rec) if not np.all(np.isfinite(out[0]))]}")
    jl, tl = _cfgs("lyapunov", **BLIND)
    d = np.abs(SRBClosedLoopHarness(tl, seed=0, device="cpu").run(0.4, vel)
               - JaxHarness(jl, seed=0).run(0.4, vel)).max()
    print(f"lyapunov SRB loop, 0.4 s: largest state difference {d:.4f}")
    from quadruped_pympc_tamols_tpu.sim import simulation as jsim
    from quadruped_pympc_tamols_torch.sim import simulation
    jk, tk = _cfgs("kinodynamic", **BLIND)
    d = np.abs(simulation.run_simulation(tk, device="cpu", **KINO_RUN)[0].state_history
               - jsim.run_simulation(jk, **KINO_RUN)[0].state_history).max(axis=0)
    print(f"kinodynamic MuJoCo run, 0.2 s: largest difference per state component "
          f"{np.round(d, 4).tolist()}")


if __name__ == "__main__":
    import sys

    import conftest  # noqa: F401

    if sys.argv[1:] == ["f64"]:
        report_float64_routes()
        sys.exit()
    for r in reference_walks([a for a in sys.argv[1:]] or tuple(WALKS)):
        print("%s: walked %.4f m, min z %.4f m, max |roll|,|pitch| %.4f rad, mean z of the "
              "second half %.4f m" % r, flush=True)
