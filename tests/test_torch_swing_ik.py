"""The last of the JAX package's gait, gradient and dataset entry points in the port,
against the JAX package on the CPU: the fused swing-reference and whole-body IK
step (``gait/swing.py:make_swing_ik_step``, both generators, 300 scripted control
steps), the gait-phase helpers (``GaitState``, ``advance_phase``,
``contact_from_phase``), the names ``estimate_terrain`` and ``make_rti_solver``,
and ``sim/generate_dataset.py``.

Tolerances: the swing step runs the same float32 formulas in another order of
operations than XLA's, so positions atol 1e-6 m, velocities 1e-5 m/s,
accelerations 1e-4 m/s^2 (up to ~30 m/s^2 at the curve's ends) and joint angles
1e-5 rad (measured: 6e-8, 2e-6, 2e-5, 3e-6). The phase arithmetic is the same
float32 operations: atol 1e-6 over 300 steps. The dataset's states hold the
closed-loop tolerances of ``test_torch_mujoco.py:test_wrapper_closed_loop_matches_jax``:
the base states 1e-3, the feet 1e-4, and the joints 1e-4 (over a 0.1 s
nominal-MPC episode; measured 1.2e-4 on the base velocity, 3e-5 on the joints).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from quadruped_pympc_tamols_tpu import gait as jgait
from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu.controllers import gradient as jgrad
from quadruped_pympc_tamols_tpu.gait.swing import make_swing_ik_step as jax_swing_ik_step
from quadruped_pympc_tamols_torch import gait
from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.controllers import gradient

threadpool_limits(1)
torch.set_num_threads(1)
STEPS = 300


def scripted(k):
    """Control step k's inputs: four legs a swing cycle apart at 2 ms a step, the
    swing mask flipping every 60 steps, the base drifting and turning."""
    period = (0.35 + 0.01 * np.arange(4)).astype(np.float32)
    t = np.mod(0.002 * k + np.array([0.0, 0.17, 0.17, 0.0]), period).astype(np.float32)
    lift_off = np.array([[0.3, 0.15, 0.0], [0.3, -0.15, 0.01], [-0.2, 0.15, 0.0],
                         [-0.2, -0.15, 0.02]], np.float32)
    lift_off[:, 0] += np.float32(0.001 * k)
    touch_down = (lift_off + [0.1, 0.0, 0.03]).astype(np.float32)
    step_h = np.full(4, 0.08, np.float32)
    mask = (np.mod(k // 60 + np.arange(4), 2) == 0).astype(np.float32)
    stance = (lift_off + 0.01).astype(np.float32)
    base = np.array([0.05 + 0.001 * k, 0.0, 0.33], np.float32)
    rpy = np.array([0.02 * np.sin(0.05 * k), 0.03 * np.cos(0.03 * k), 0.01 * k], np.float32)
    return t, period, step_h, lift_off, touch_down, mask, stance, base, rpy


@pytest.mark.parametrize("generator", ["bezier_ref", "explicit"])
def test_swing_ik_step_matches_jax(generator):
    """300 control steps of the port's make_swing_ik_step on the CPU (the graph's
    eager function) against the JAX package's jitted step; swing legs follow the
    curve, stance legs their foothold, and the IK reproduces the JAX joints."""
    jstep = jax_swing_ik_step(jax_make_config("aliengo").robot, generator)
    step = gait.make_swing_ik_step(make_config("aliengo").robot, generator, device="cpu")
    tol = (1e-6, 1e-5, 1e-4, 1e-5)
    for k in range(STEPS):
        inputs = scripted(k)
        want = jstep(*(jnp.asarray(x) for x in inputs))
        got = step(*(torch.from_numpy(x) for x in inputs))
        for g, w, atol in zip(got, want, tol):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=atol)
        stance = inputs[5] == 0
        assert np.array_equal(got[0].numpy()[stance], inputs[6][stance])
        assert not got[1].numpy()[stance].any()
    # The JAX package's names of the jitted references are the device twins here.
    t, period, step_h, lo, td = (torch.from_numpy(x) for x in scripted(7)[:5])
    ref = {"bezier_ref": gait.swing.bezier_swing_refs_jit,
           "explicit": gait.swing.explicit_swing_refs_jit}[generator]
    jref = {"bezier_ref": jgait.swing.bezier_swing_refs_jit,
            "explicit": jgait.swing.explicit_swing_refs_jit}[generator]
    for g, w, atol in zip(ref(t, period, step_h, lo, td),
                          jax_vmap_refs(jref, scripted(7)[:5]), tol):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=atol)


def jax_vmap_refs(fn, args):
    import jax
    return [np.asarray(x) for x in jax.vmap(fn)(*(jnp.asarray(a) for a in args))]


def test_gait_phase_helpers_match_jax():
    """GaitState over (3, 4) phases advanced 300 steps at three step frequencies,
    its stance masks at duty 0.6, as torch tensors and as numpy arrays, against
    the JAX package's advance_phase and contact_from_phase."""
    phase0 = np.array([[0.0, 0.5, 0.5, 0.0], [0.1, 0.6, 0.6, 0.1], [0.9, 0.4, 0.4, 0.9]],
                      np.float32)
    freq = np.array([[1.4], [2.0], [2.4]], np.float32)
    state = gait.GaitState(torch.from_numpy(phase0))
    jphase, nphase = jnp.asarray(phase0), phase0
    for _ in range(STEPS):
        state = gait.GaitState(gait.advance_phase(state.phase, 0.002, torch.from_numpy(freq)))
        jphase = jgait.advance_phase(jphase, 0.002, jnp.asarray(freq))
        nphase = gait.advance_phase(nphase, 0.002, freq)
        np.testing.assert_allclose(state.phase.numpy(), np.asarray(jphase), rtol=0, atol=1e-6)
        np.testing.assert_allclose(nphase, np.asarray(jphase), rtol=0, atol=1e-6)
        want = np.asarray(jgait.contact_from_phase(jphase, 0.6))
        got = gait.contact_from_phase(state.phase, 0.6)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(gait.contact_from_phase(np.asarray(jphase), 0.6), want)
    assert isinstance(jgait.GaitState(jphase).phase, type(jphase))


def test_exported_names_match_jax():
    """Every name the JAX package's gait and gradient packages export, the port
    exports; estimate_terrain is the terrain step, and make_rti_solver the
    one-shot solve of make_rti_solver_split with the JAX solver's dims."""
    assert set(jgait.__all__) <= set(gait.__all__)
    assert set(jgrad.__all__) <= set(gradient.__all__)
    feet = np.array([[0.3, 0.2, 0.05], [0.3, -0.2, 0.02], [-0.3, 0.2, 0.0], [-0.3, -0.2, 0.01]])
    base = np.array([0.02, 0.01, 0.33])
    got = gait.estimate_terrain(base, 0.2, feet, 0.01, 0.02, 0.0, True, True)
    want = jgait.estimate_terrain(jnp.asarray(base, jnp.float32), jnp.float32(0.2),
                                  jnp.asarray(feet, jnp.float32), 0.01, 0.02, 0.0, True, True)
    np.testing.assert_allclose(got, [float(w) for w in want], rtol=1e-5, atol=1e-6)
    cfg = make_config("aliengo", mpc_type="nominal")
    solve, dims = gradient.make_rti_solver(cfg, device="cpu")
    _, jdims = jgrad.make_rti_solver(jax_make_config("aliengo", mpc_type="nominal"))
    assert (dims.nx, dims.nu, dims.horizon) == (jdims.nx, jdims.nu, jdims.horizon)
    split = gradient.make_rti_solver_split(cfg, device="cpu")
    assert callable(solve) and split[3] == dims


def test_generate_dataset_matches_jax(tmp_path):
    """One 0.1 s episode with the nominal gradient MPC: the port's files, keys,
    shapes and dtypes equal the JAX package's, and its states and joints lie
    within the closed-loop tolerance."""
    from quadruped_pympc_tamols_torch.sim.generate_dataset import generate_dataset
    from quadruped_pympc_tamols_tpu.sim.generate_dataset import generate_dataset as jax_dataset

    over = {"sim.visual_foothold_adaptation": "blind"}
    jax_paths = jax_dataset(jax_make_config("aliengo", mpc_type="nominal", **over),
                            str(tmp_path / "jax"), num_episodes=1, episode_duration_s=0.1)
    paths = generate_dataset(make_config("aliengo", mpc_type="nominal", **over),
                             str(tmp_path / "port"), num_episodes=1, episode_duration_s=0.1,
                             device="cpu")
    assert [p.rsplit("/", 1)[1] for p in paths] == [p.rsplit("/", 1)[1] for p in jax_paths]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["episode_0.npz", "motion_0.npz"]
    for name in ("episode_0.npz", "motion_0.npz"):
        with np.load(tmp_path / "port" / name) as got, np.load(tmp_path / "jax" / name) as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            for k, atol in (("base_pos", 1e-3), ("base_lin_vel", 1e-3),
                            ("base_ori_euler_xyz", 1e-3), ("base_ang_vel", 1e-3),
                            ("feet_pos", 1e-4), ("joints_pos", 1e-4)):
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)
