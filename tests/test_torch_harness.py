"""The port's main path end to end on the CPU: the SRB closed loop against the JAX
package's harness at zero noise, and the torch harness walking."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu.controllers.sampling import SamplingState as JaxState
from quadruped_pympc_tamols_tpu.sim import SRBClosedLoopHarness as JaxHarness
from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.interfaces import SRBDControllerInterface
from quadruped_pympc_tamols_torch.interop import config_from_dict, sampling_state_from_numpy
from quadruped_pympc_tamols_torch.sim import SRBClosedLoopHarness

torch.set_num_threads(1)
BLIND = {"sim.visual_foothold_adaptation": "blind"}


def _assert_walking(cfg, hist, vel, duration):
    """The band of tests/test_closed_loop_walking.py:18-29."""
    z = hist[:, 2]
    assert np.all(np.isfinite(hist)), "state diverged"
    assert np.all(z > 0.15), f"robot collapsed: min z {z.min():.3f}"
    assert np.all(np.abs(hist[:, 6]) < 0.5) and np.all(np.abs(hist[:, 7]) < 0.5), \
        "robot tipped over"
    dist = hist[-1, 0] - hist[0, 0]
    assert dist > 0.5 * vel[0] * duration, f"tracked {dist:.2f} m"
    assert abs(np.mean(z[len(z) // 2:]) - cfg.sim.ref_z) < 0.08


@pytest.mark.parametrize("vel, method", [((0.3, 0.0, 0.0), "random_sampling"),
                                         ((0.0, 0.2, 0.0), "random_sampling"),
                                         ((0.3, 0.0, 0.0), "mppi")],
                         ids=["vel0", "vel1", "mppi3"])
def test_zero_noise_closed_loop_matches_jax(vel, method):
    """0.3 s (30 MPC ticks) at zero exploration noise: every solve returns the
    warm-started incumbent, so both stacks are deterministic. State histories
    agree to atol 1e-3: the plants integrate in float32 and the swing curves run in
    float32 (JAX, jitted) against float64 (port, numpy), which moves the feet by
    ~1e-7 m a step and the base by well under a millimetre over 150 steps. MPPI
    runs the slice's walking configuration, 3 chained iterations a tick."""
    over = {**BLIND, "mpc.sampling.num_samples": 32,
            "mpc.sampling.sigma_random": (0.0, 0.0, 0.0), "mpc.sampling.sigma_mppi": 0.0,
            "mpc.sampling.method": method,
            "mpc.sampling.num_iterations": 3 if method == "mppi" else 1}
    jc = jax_make_config("aliengo", mpc_type="sampling", **over)
    tc = config_from_dict(dataclasses.asdict(jc))
    jh = JaxHarness(jc, seed=0)
    th = SRBClosedLoopHarness(tc, seed=0, device="cpu")
    # The same nonzero incumbent in both: at zero noise each solve keeps it (minus
    # the lift-off resets), so the GRFs carry tangential forces and the base moves.
    P = th.ctrl.controller.num_parameters
    inc = (np.random.default_rng(0).standard_normal(P) * 4.0).astype(np.float32)
    js = jh.ctrl.controller.state
    jh.ctrl.controller.state = JaxState(jnp.asarray(inc), js.key, js.sigma)
    th.ctrl.controller.state = sampling_state_from_numpy(inc, np.zeros(P), 0, device="cpu")
    jhist = jh.run(0.3, np.asarray(vel))
    thist = th.run(0.3, np.asarray(vel))
    np.testing.assert_allclose(thist, jhist, atol=1e-3)
    np.testing.assert_allclose(th.feet, jh.feet, atol=1e-4)
    assert np.ptp(thist[:, 0]) > 1e-3 and np.ptp(thist[:, 1]) > 1e-4  # it moved


def test_torch_harness_walks():
    cfg = make_config("aliengo", mpc_type="sampling",
                      **{**BLIND, "mpc.sampling.num_samples": 1000})
    h = SRBClosedLoopHarness(cfg, seed=0, device="cpu")
    duration, vel = 2.0, (0.3, 0.0, 0.0)
    hist = h.run(duration, np.asarray(vel))
    _assert_walking(cfg, hist, vel, duration)


def _dicts(k):
    state = dict(position=np.array([0.01 * k, 0.0, 0.32]), linear_velocity=np.array([0.1, 0, 0]),
                 orientation=np.zeros(3), angular_velocity=np.zeros(3))
    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]])
    ref = dict(ref_position=np.array([0.0, 0.0, 0.35]), ref_linear_velocity=np.array([0.3, 0, 0]),
               ref_orientation=np.zeros(3), ref_angular_velocity=np.zeros(3))
    for i, leg in enumerate(("FL", "FR", "RL", "RR")):
        state[f"foot_{leg}"] = feet[i] + [0.01 * k, 0, 0]
        ref[f"ref_foot_{leg}"] = (feet[i] + [0.01 * k + 0.05, 0, 0]).reshape(1, 3)
    return state, ref


def test_pipelined_interface_returns_previous_tick():
    """sampling.pipelined hands back the previous tick's solution; the stream of
    solves itself is unchanged."""
    over = {**BLIND, "mpc.sampling.num_samples": 64}
    plain = SRBDControllerInterface(make_config(**over), seed=3, device="cpu")
    piped = SRBDControllerInterface(make_config(**over, **{"mpc.sampling.pipelined": True}),
                                    seed=3, device="cpu")
    seq = np.ones((4, 12))
    seq[1, 4:] = seq[2, 4:] = 0.0
    outs_plain, outs_piped = [], []
    for k in range(4):
        state, ref = _dicts(k)
        outs_plain.append(plain.compute_control(state, ref, seq))
        outs_piped.append(piped.compute_control(state, ref, seq))
    for k in range(1, 4):
        # GRFs are shift-invariant; the predicted position carries tick k's recentering.
        np.testing.assert_array_equal(outs_piped[k][0].data, outs_plain[k - 1][0].data)
    np.testing.assert_array_equal(outs_piped[0][0].data, outs_plain[0][0].data)


def test_unported_options_raise():
    """The gradient family's variants and its DDP solver, refused before the
    variant slice, now build the harness on the CPU and step it through a solve
    to finite states."""
    for over in ({"mpc.type": "lyapunov"}, {"mpc.type": "nominal", "mpc.gradient.use_DDP": True}):
        cfg = make_config("aliengo", **{**BLIND, "mpc.sampling.num_samples": 32, **over})
        h = SRBClosedLoopHarness(cfg, device="cpu")
        x = h.step(np.array([0.3, 0.0, 0.0]))
        assert np.all(np.isfinite(x)) and np.any(h.grfs.data), over


def test_wb_interface_references_match_jax():
    """update_state_and_reference on the same scripted base and feet for 200 steps:
    identical contact sequences, and state/reference dicts within float64
    rounding (both are host numpy)."""
    from quadruped_pympc_tamols_tpu.interfaces import WBInterface as JaxWB
    from quadruped_pympc_tamols_tpu.utils.legs import Legs as JaxLegs
    from quadruped_pympc_tamols_torch.interfaces import WBInterface
    from quadruped_pympc_tamols_torch.utils.legs import Legs

    jc = jax_make_config("aliengo", mpc_type="sampling", **BLIND)
    tc = config_from_dict(dataclasses.asdict(jc))
    rng = np.random.default_rng(0)
    feet0 = np.array([[0.24, 0.15, 0], [0.24, -0.15, 0], [-0.24, 0.15, 0], [-0.24, -0.15, 0]])
    twb, jwb = WBInterface(tc, Legs(feet0.copy())), JaxWB(jc, JaxLegs(feet0.copy()))
    for k in range(200):
        base = np.array([0.0015 * k, 0.0, 0.35]) + rng.normal(0, 0.002, 3)
        rpy, vel = rng.normal(0, 0.02, 3), np.array([0.3, 0.0, 0.0]) + rng.normal(0, 0.05, 3)
        feet = feet0 + [0.0015 * k, 0, 0] + rng.normal(0, 0.01, (4, 3))
        hips = base + np.array([[0.24, 0.05, 0], [0.24, -0.05, 0], [-0.24, 0.05, 0],
                                [-0.24, -0.05, 0]])
        args = dict(com_pos=base, base_pos=base, base_lin_vel=vel, base_ori_euler_xyz=rpy,
                    base_ang_vel=rng.normal(0, 0.05, 3), heightmaps=None, simulation_dt=0.002,
                    ref_base_lin_vel=np.array([0.3, 0.0, 0.0]), ref_base_ang_vel=np.zeros(3))
        ts, tr, tseq, tsh, _ = twb.update_state_and_reference(
            feet_pos=Legs(feet.copy()), hip_pos=Legs(hips), joints_pos=Legs.zeros((3,)), **args)
        js, jr, jseq, jsh, _ = jwb.update_state_and_reference(
            feet_pos=JaxLegs(feet.copy()), hip_pos=JaxLegs(hips), joints_pos=JaxLegs.zeros((3,)),
            **args)
        np.testing.assert_array_equal(tseq, jseq)
        assert tsh == jsh
        for key in ("position", "linear_velocity", "orientation", "angular_velocity",
                    "foot_FL", "foot_RR"):
            np.testing.assert_allclose(ts[key], js[key], atol=1e-12)
        for key in ("ref_foot_FL", "ref_foot_FR", "ref_foot_RL", "ref_foot_RR",
                    "ref_linear_velocity", "ref_orientation", "ref_position"):
            np.testing.assert_allclose(tr[key], jr[key], atol=1e-12)
    np.testing.assert_array_equal(twb.current_contact, jwb.current_contact)


# (method, iterations, parametrization) of every walk the port runs on the card,
# without and with mpc.optimize_step_freq.
WALKED = ((("random_sampling", 1, "cubic_spline"), ("mppi", 1, "cubic_spline"),
           ("mppi", 3, "cubic_spline"), ("random_sampling", 3, "cubic_spline"),
           ("cem_mppi", 1, "cubic_spline"), ("cem_mppi", 3, "cubic_spline"),
           ("random_sampling", 1, "linear_spline"), ("random_sampling", 1, "zero_order"),
           ("mppi", 3, "zero_order")),
          (("random_sampling", 1, "cubic_spline"), ("mppi", 1, "cubic_spline"),
           ("cem_mppi", 1, "cubic_spline")))


def reference_walks(num_samples=10_000, duration=3.0, vel=(0.3, 0.0, 0.0), gait_adaptive=False,
                    walks=None, horizon=None):
    """The JAX package's SRB harness walking the README quickstart for the
    sampling methods, iteration counts and parametrizations of the port's slices
    (``walks``, by default all of ``WALKED``), or with ``mpc.optimize_step_freq``
    for the gait-adaptive slice, at the configuration's horizon or ``horizon``:
    (method, iterations, parametrization, distance (m), min z (m), max
    |roll|,|pitch| (rad), step frequency at the end)."""
    rows = []
    for method, iterations, parametrization in walks or WALKED[gait_adaptive]:
        cfg = jax_make_config("aliengo", mpc_type="sampling", **{
            **BLIND, "mpc.sampling.num_samples": num_samples, "mpc.sampling.method": method,
            "mpc.sampling.num_iterations": iterations,
            "mpc.sampling.parametrization": parametrization,
            "mpc.optimize_step_freq": gait_adaptive,
            **({"mpc.horizon": horizon} if horizon else {})})
        h = JaxHarness(cfg, seed=0)
        hist = h.run(duration, np.asarray(vel))
        rows.append((method, iterations, parametrization, hist[-1, 0] - hist[0, 0],
                     hist[:, 2].min(), np.abs(hist[:, 6:8]).max(), h.wb.pgg.step_freq))
    return rows


if __name__ == "__main__":
    # python tests/test_torch_harness.py [gait] [row ...]: the JAX reference's
    # walks on the CPU, on the platform the tests use (tests/conftest.py), for
    # PERF.md; with "gait", the gait-adaptive walks (mpc.optimize_step_freq); with
    # row numbers, only those rows of WALKED; "horizon H row ...": those rows at
    # horizon H (chip_smoke.py's JAX_CPU_LONG_WALK is "horizon 32 0").
    import sys

    import conftest  # noqa: F401

    args = sys.argv[1:]
    horizon = int(args[1]) if args[:1] == ["horizon"] else None
    args = args[2:] if horizon else args
    gait = args[:1] == ["gait"]
    picked = [WALKED[gait][int(a)] for a in args[gait:]]
    for row in reference_walks(gait_adaptive=gait, walks=picked, horizon=horizon):
        print("method %s, iterations %d, %s: walked %.4f m, min z %.4f m, max |roll|,|pitch| "
              "%.4f rad, step frequency %.4f Hz" % row, flush=True)
