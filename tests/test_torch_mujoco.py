"""The port's torque path and MuJoCo tier against the JAX package on the CPU: the
MJCF scenes, QuadrupedEnv's readers, steps and heightmaps (bit for bit), the
whole-body torque path for seven knob sets on a recorded MuJoCo trace
(``tests/fixtures/torch_mujoco_trace.npz``, made by
``tools/record_mujoco_trace.py``), and the wrapper's zero-noise closed loop through
``run_simulation``. Both sides get the same inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu.config import ROBOTS
from quadruped_pympc_tamols_tpu.controllers.sampling import SamplingState as JaxState
from quadruped_pympc_tamols_tpu.interfaces import WBInterface as JaxWB
from quadruped_pympc_tamols_tpu.observability import EpisodeLogger as JaxLogger
from quadruped_pympc_tamols_tpu.planner.heightmap import GridHeightMap as JaxGrid
from quadruped_pympc_tamols_tpu.utils.legs import Legs as JaxLegs
from quadruped_pympc_tamols_torch import make_config, replace_config
from quadruped_pympc_tamols_torch.interfaces import WBInterface
from quadruped_pympc_tamols_torch.interop import config_from_dict, sampling_state_from_numpy
from quadruped_pympc_tamols_torch.kinematics import LegKinematics
from quadruped_pympc_tamols_torch.observability import EpisodeLogger
from quadruped_pympc_tamols_torch.sim.trace import ControlTrace
from quadruped_pympc_tamols_torch.utils.frames import euler_xyz_to_rot_np
from quadruped_pympc_tamols_torch.utils.legs import Legs

mujoco = pytest.importorskip("mujoco")

from quadruped_pympc_tamols_tpu.kinematics.leg_ik import LegKinematics as JaxKin  # noqa: E402
from quadruped_pympc_tamols_tpu.sim import mjcf as jax_mjcf  # noqa: E402
from quadruped_pympc_tamols_tpu.sim import simulation as jax_simulation  # noqa: E402
from quadruped_pympc_tamols_tpu.sim.mujoco_env import QuadrupedEnv as JaxEnv  # noqa: E402
from quadruped_pympc_tamols_torch.sim import mjcf, simulation  # noqa: E402
from quadruped_pympc_tamols_torch.sim.mujoco_env import QuadrupedEnv  # noqa: E402

torch.set_num_threads(1)
# Every scene of sim/mjcf.py.
SCENES = ("flat", "slippery", "ramp", "stairs", "random_boxes", "stepping_stones",
          "stepping_stones_chasm", "trip_bar", "perlin", "rough")
TORQUE_ATOL = 1e-6  # tau (N m), des_q (rad), des_qd (rad/s)
# Reference footholds (m): the planners score in float32 on either side, as
# tests/test_torch_tamols.py holds them.
REF_ATOL = 1e-5
KNOB_STEPS = 300
TRACE = ControlTrace()
# The recorded configuration: make_config("aliengo", mpc_type="sampling") with
# the README's full-physics foothold strategy.
RECORDED = {"sim.visual_foothold_adaptation": "height"}


def test_trace_is_the_recorded_configuration():
    """The fixture was recorded with RECORDED's configuration (N = 10 000), and
    its 500 steps hold 100 MPC ticks with GRFs only on stance legs."""
    cfg = config_from_dict(TRACE.config)
    want = config_from_dict(dataclasses.asdict(jax_make_config("aliengo", mpc_type="sampling",
                                                               **RECORDED)))
    assert cfg == want and cfg.mpc.sampling.num_samples == 10_000
    assert TRACE.steps == 500 and len(TRACE.arrays["hm_steps"]) > 0
    assert np.all(np.isfinite(TRACE.arrays["tau"]))


def test_mjcf_matches_jax_for_every_scene_and_robot():
    for robot in ROBOTS:
        rp, jrp = make_config(robot).robot, jax_make_config(robot).robot
        for scene in SCENES:
            for seed, friction, legs in ((0, 0.8, 0.15), (3, 0.4, 0.3)):
                assert mjcf.quadruped_mjcf(rp, scene, friction, seed, legs) == \
                    jax_mjcf.quadruped_mjcf(jrp, scene, friction, seed, legs), (robot, scene)


def test_crouch_ik_matches_jax_float32_bits():
    """The float32 IK that seeds the crouch pose and the numeric IK is the JAX
    package's jitted ik_all bit for bit, for every robot, inside and outside the
    reachable annulus."""
    rng = np.random.default_rng(0)
    for robot in ROBOTS:
        kin, jkin = LegKinematics(make_config(robot).robot), JaxKin(jax_make_config(robot).robot)
        for _ in range(40):
            p = (np.array([0.0, 0.08, -0.35]) + rng.normal(0, 0.2, (4, 3))).astype(np.float32)
            np.testing.assert_array_equal(kin.ik_all_f32(p), np.asarray(jkin.ik_all(p)))


def test_env_readers_and_steps_match_jax():
    """Reset pose, every reader and 300 steps of the same torques, bit for bit, on
    two robots and spawns; the inertia and contact readers too."""
    rng = np.random.default_rng(0)
    for robot, scene, spawn in (("aliengo", "random_boxes", None),
                                ("go1", "stairs", np.array([0.7, -0.3, 0.45]))):
        env = QuadrupedEnv(make_config(robot), scene=scene, seed=3)
        jenv = JaxEnv(jax_make_config(robot), scene=scene, seed=3)
        if spawn is not None:
            env.reset(base_pos=spawn)
            jenv.reset(base_pos=spawn)
        for k in range(301):
            if k % 100 == 0:
                for name in ("base_pos", "base_lin_vel", "base_ang_vel", "base_ori_euler_xyz",
                             "com_pos"):
                    np.testing.assert_array_equal(getattr(env, name), getattr(jenv, name))
                for name in ("feet_pos", "feet_vel", "hip_positions", "joints_pos",
                             "joints_vel", "feet_jacobians", "feet_jacobians_dot",
                             "legs_mass_matrix", "legs_qfrc_bias", "legs_qfrc_passive"):
                    np.testing.assert_array_equal(getattr(env, name)().data,
                                                  getattr(jenv, name)().data, err_msg=name)
                np.testing.assert_array_equal(env.srb_inertia(), jenv.srb_inertia())
                np.testing.assert_array_equal(env.feet_contact_state(), jenv.feet_contact_state())
                for a, b in zip(env.feet_contact_points(), jenv.feet_contact_points()):
                    assert len(a) == len(b)
                    for (pa, na), (pb, nb) in zip(a, b):
                        np.testing.assert_array_equal(pa, pb)
                        np.testing.assert_array_equal(na, nb)
            tau = rng.normal(0.0, 8.0, (4, 3))
            env.step(Legs(tau))
            jenv.step(JaxLegs(tau))
        np.testing.assert_array_equal(env.data.qpos, jenv.data.qpos)


def test_heightmaps_match_jax():
    """Ray-cast grids on stairs and random_boxes, at yaw 0 and at random yaws, and
    the leg-stacked grids: the same origins, and the same heights bit for bit."""
    rng = np.random.default_rng(1)
    for scene in ("stairs", "random_boxes"):
        env = QuadrupedEnv(make_config("aliengo"), scene=scene, seed=1)
        jenv = JaxEnv(jax_make_config("aliengo"), scene=scene, seed=1)
        for k in range(12):
            center, yaw = rng.uniform([-0.5, -1.0], [2.5, 1.0]), rng.uniform(-np.pi, np.pi) * (k > 0)
            hm, jhm = env.heightmap(center, yaw, device="cpu"), jenv.heightmap(center, yaw)
            for leaf in ("center", "yaw", "resolution", "heights"):
                np.testing.assert_array_equal(getattr(hm, leaf).numpy(),
                                              np.asarray(getattr(jhm, leaf)))
        feet = rng.uniform([0.0, -0.3, 0.0], [2.0, 0.3, 0.0], (4, 3))
        hms, jhms = env.leg_heightmaps(Legs(feet), 0.2, device="cpu"), \
            jenv.leg_heightmaps(JaxLegs(feet), 0.2)
        np.testing.assert_array_equal(hms.heights.numpy(), np.asarray(jhms.heights))
        assert hms.heights.shape == (4, 13, 7) and hms.center.shape == (4, 2)


def _jax_hms(hms):
    return None if hms is None else JaxGrid(*(jnp.asarray(getattr(hms, leaf).numpy()) for leaf in
                                              ("center", "yaw", "resolution", "heights")))


def _dig_pits(hms):
    """Recorded grids with a 30 cm deep pit of 5 x 3 cells around each centre:
    TAMOLS moves footholds out of it, so the torque path re-plans swings
    (retargets)."""
    if hms is not None:
        hms.heights = hms.heights.clone()
        hms.heights[:, 4:9, 2:5] -= 0.3
    return hms


def _wall_contacts(wb, feet, contacts):
    """Recorded contact points, plus for each leg past 40 % of its swing a contact
    at the foot whose normal opposes the swing direction (an obstacle ahead)."""
    for leg in range(4):
        if wb.current_contact[leg] == 0 and wb.stc.swing_time[leg] > 0.4 * wb.stc.swing_period:
            contacts[leg] = contacts[leg] + [(feet[leg].copy(), np.array([-0.8, 0.0, 0.6]))]
    return contacts


# name: (overrides of the recorded configuration, a perturbation of the recorded
# inputs, the branch it must reach at least once). "default" is make_config's
# own foothold strategy, TAMOLS.
KNOB_SETS = {
    "default": ({"sim.visual_foothold_adaptation": "tamols"}, "terrain", "retarget"),
    "late_touchdown_hold": ({"sim.late_touchdown_hold": 0.03,
                             "sim.late_touchdown_hold_xy": 0.05}, "late", "hold"),
    "swing_reach_clamp": ({"sim.swing_reach_clamp": 0.95}, "far", "clamp"),
    "geom_contact": ({"sim.reflex_trigger_mode": "geom_contact",
                      "sim.swing_generator": "scipy"}, "wall", "reflex"),
    "numeric_ik": ({"sim.ik_solver": "numeric"}, None, None),
    "touchdown_overdrive": ({"sim.touchdown_overdrive": 0.01}, None, None),
    "optimize_step_freq": ({"mpc.optimize_step_freq": True}, None, "handoff"),
}


@pytest.mark.parametrize("knobs", list(KNOB_SETS))
def test_torque_path_matches_jax(knobs):
    """update_state_and_reference and compute_stance_and_swing_torque on 300
    recorded MuJoCo steps with the recorded GRFs and footholds: the same contact
    sequences, reference footholds to 1e-5 and the same tau, des_q and des_qd to
    1e-6. Where the recorded
    flat-ground walk reaches no branch of a knob, its inputs are perturbed the same
    way for both: a pit under the footholds (retargets), footholds 5 cm lower or
    8 cm aside (the hold, in z and in xy), 40 cm further ahead (the reach clamp), an
    obstacle contact ahead of swinging feet (the geom_contact reflex, re-planned
    by the scipy generator); the step-frequency hand-off gets seeded candidate
    frequencies."""
    over, perturb, branch = KNOB_SETS[knobs]
    jcfg = jax_make_config("aliengo", mpc_type="sampling", **{**RECORDED, **over})
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    feet0 = TRACE.arrays["feet_pos"][0]
    twb = WBInterface(tcfg, Legs(feet0.copy()), device="cpu")
    jwb = JaxWB(jcfg, JaxLegs(feet0.copy()))
    rng = np.random.default_rng(0)
    seen = 0
    for i in range(KNOB_STEPS):
        up = TRACE.update_args(i)
        if perturb == "terrain":
            up["heightmaps"] = _dig_pits(up["heightmaps"])
        jup = dict(up, feet_pos=JaxLegs(up["feet_pos"].data), hip_pos=JaxLegs(up["hip_pos"].data),
                   joints_pos=JaxLegs(up["joints_pos"].data), heightmaps=_jax_hms(up["heightmaps"]))
        _, tref, tseq, _, topt = twb.update_state_and_reference(**up)
        _, jref, jseq, _, jopt = jwb.update_state_and_reference(**jup)
        np.testing.assert_array_equal(tseq, jseq)
        assert topt == jopt
        for key in ("ref_foot_FL", "ref_foot_FR", "ref_foot_RL", "ref_foot_RR", "ref_position"):
            np.testing.assert_allclose(tref[key], jref[key], rtol=0, atol=REF_ATOL)
        freq = float(rng.choice(tcfg.mpc.step_freq_available)) if topt else None
        args = TRACE.torque_args(i, optimize_swing=topt, best_sample_freq=freq,
                                 contact_points=perturb == "wall")
        fh = args["nmpc_footholds"].data
        if perturb == "late":
            fh[[0, 3], 2] -= 0.05
            fh[[1, 2], 1] += 0.08
        elif perturb == "far":
            fh[:, 0] += 0.4
        elif perturb == "wall":
            args["contact_points"] = _wall_contacts(twb, args["feet_pos"].data,
                                                    args["contact_points"])
        jargs = {k: JaxLegs(v.data.copy()) if isinstance(v, Legs) else v for k, v in args.items()}
        out = twb.compute_stance_and_swing_torque(**args)
        jout = jwb.compute_stance_and_swing_torque(**jargs)
        for name, t, j in zip(("tau", "des_q", "des_qd"), out, jout):
            np.testing.assert_allclose(t.data, np.asarray(j.data), rtol=0, atol=TORQUE_ATOL,
                                       err_msg=f"{name} at step {i}")
        np.testing.assert_array_equal(twb._hold_active, jwb._hold_active)
        seen += {"retarget": any(p is not None for p in twb.stc.retarget_points),
                 "hold": bool(twb._hold_active.any()),
                 "clamp": _clamped(twb, args),
                 "reflex": any(h is not None for h in twb.esd.hitpoints),
                 "handoff": topt == 1, None: True}[branch]
    assert seen > 0, f"{knobs}: the inputs never reached the {branch} branch"


def _clamped(wb, args):
    """A swing command on the reach sphere (sim.swing_reach_clamp) this tick."""
    hips = np.asarray(args["base_pos"]) + wb._hip_off @ euler_xyz_to_rot_np(args["base_rpy"]).T
    d = np.linalg.norm(wb.last_des_foot_pos.data - hips, axis=1)
    r_safe = wb.cfg.sim.swing_reach_clamp * wb._leg_reach
    return bool(np.any((wb.current_contact == 0) & np.isclose(d, r_safe, rtol=0, atol=1e-9)))


def test_wrapper_closed_loop_matches_jax(tmp_path, monkeypatch):
    """run_simulation on both sides for 0.4 s (200 steps, 40 MPC ticks) of the
    README's full-physics example at N = 32 and zero exploration noise, both
    controllers starting from the same nonzero incumbent: base states to 1e-3,
    feet to 1e-4 (each side's EpisodeLogger), the same observables, and no fall."""
    over = {"mpc.sampling.num_samples": 32, "mpc.sampling.sigma_random": (0.0, 0.0, 0.0),
            "sim.visual_foothold_adaptation": "height"}
    jc = jax_make_config("aliengo", mpc_type="sampling", **over)
    tc = config_from_dict(dataclasses.asdict(jc))
    inc_of = {}

    def incumbent(P):
        return inc_of.setdefault(P, (np.random.default_rng(0).standard_normal(P) * 4.0)
                                 .astype(np.float32))

    class JaxWrapper(jax_simulation.QuadrupedPyMPCWrapper):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            ctrl = self.srbd_controller_interface.controller
            ctrl.state = JaxState(jnp.asarray(incumbent(ctrl.num_parameters)), ctrl.state.key,
                                  ctrl.state.sigma)

    class Wrapper(simulation.QuadrupedPyMPCWrapper):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            ctrl = self.srbd_controller_interface.controller
            ctrl.state = sampling_state_from_numpy(incumbent(ctrl.num_parameters),
                                                   np.zeros(ctrl.num_parameters), 0, device="cpu")

    monkeypatch.setattr(jax_simulation, "QuadrupedPyMPCWrapper", JaxWrapper)
    monkeypatch.setattr(simulation, "QuadrupedPyMPCWrapper", Wrapper)
    jlog, tlog = JaxLogger(str(tmp_path / "jax.npz")), EpisodeLogger(str(tmp_path / "port.npz"))
    jres = jax_simulation.run_simulation(jc, episode_duration_s=0.4, ref_base_lin_vel=(0.3, 0.0),
                                         seed=0, logger=jlog)[0]
    tres = simulation.run_simulation(tc, episode_duration_s=0.4, ref_base_lin_vel=(0.3, 0.0),
                                     seed=0, logger=tlog, device="cpu")[0]
    assert not tres.fell and not jres.fell and len(tres.state_history) == 200
    np.testing.assert_allclose(tres.state_history, jres.state_history, rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.asarray(tlog.buffers["feet_pos"]),
                               np.asarray(jlog.buffers["feet_pos"]), rtol=0, atol=1e-4)
    assert sorted(tlog.buffers) == sorted(jlog.buffers)
    assert abs(tres.distance - jres.distance) < 1e-3
    tlog.flush()
    with np.load(tmp_path / "port.npz") as f:
        assert f["ctrl__nmpc_GRFs"].shape == (200, 4, 3)


def test_unported_pieces_raise(tmp_path, monkeypatch):
    """The gradient variants (mpc.type "lyapunov") and the DDP solver
    (mpc.gradient.use_DDP), refused before the variant slice, now build a
    wrapper on the CPU and solve a tick; video and the live viewer, refused before
    the last slice, now run (with a stub renderer and a stub viewer: there is no
    GL here): run_simulation writes the episode's frames at video_fps and syncs
    the viewer at 30 Hz; the wrapper, run_simulation and the heightmaps refuse a
    missing card instead of using the CPU."""
    import mujoco
    import mujoco.viewer
    from quadruped_pympc_tamols_torch.interfaces import QuadrupedPyMPCWrapper

    cfg = make_config("aliengo", mpc_type="sampling",
                      **{"sim.visual_foothold_adaptation": "blind",
                         "mpc.sampling.num_samples": 32})
    for over in ({"mpc.type": "lyapunov"},
                 {"mpc.type": "nominal", "mpc.gradient.use_DDP": True}):
        w = QuadrupedPyMPCWrapper(replace_config(cfg, **over), Legs(TRACE.arrays["feet_pos"][0]),
                                  device="cpu")
        tau = w.compute_actions(**{**TRACE.inputs(0), "heightmaps": None})
        assert np.all(np.isfinite(tau.data)) and np.any(w.nmpc_GRFs.data), over
    class StubRenderer:
        def __init__(self, model, height, width):
            self.scene = mujoco.MjvScene(model, maxgeom=64)
            self.frames = 0

        def update_scene(self, data, camera=None):
            self.scene.ngeom = 0

        def render(self):  # frames that differ: a GIF writer merges equal ones
            self.frames += 1
            return np.full((8, 8, 3), 60 * self.frames + self.scene.ngeom, np.uint8)

        def close(self):
            pass

    class StubViewer(StubRenderer):
        syncs = 0

        def __init__(self, model):
            super().__init__(model, 0, 0)
            self.user_scn = self.scene

        def is_running(self):
            return True

        def sync(self):
            StubViewer.syncs += 1

    monkeypatch.setattr(mujoco, "Renderer", StubRenderer)
    monkeypatch.setattr(mujoco.viewer, "launch_passive",
                        lambda model, data, key_callback=None: StubViewer(model))
    simulation.run_simulation(cfg, episode_duration_s=0.07, device="cpu",
                              video_path=str(tmp_path / "ep%d.gif"), video_fps=30.0)
    import imageio
    assert len(imageio.mimread(tmp_path / "ep0.gif")) == 3  # t = 0, 1/30, 2/30
    simulation.run_simulation(cfg, episode_duration_s=0.07, device="cpu", render=True)
    assert StubViewer.syncs == 3
    if not torch.cuda.is_available():
        env = QuadrupedEnv(cfg)
        for call in (lambda: QuadrupedPyMPCWrapper(cfg, env.feet_pos()),
                     lambda: simulation.run_simulation(cfg, episode_duration_s=0.01),
                     lambda: env.heightmap([0.0, 0.0], 0.0),
                     lambda: env.leg_heightmaps(env.feet_pos(), 0.0)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


# The full-physics episodes PERF.md's closed-loop table compares (at N = 10 000):
# (name, foothold strategy, scene, velocity, seed, seconds, least distance), the
# README's example and the default configuration on rough ground, each with the
# band of tests/test_mujoco_sim.py (:48-57, :204-217).
EPISODES = (("height flat", "height", "flat", 0.3, 0, 3.0, 0.3),
            ("tamols random_boxes", "tamols", "random_boxes", 0.25, 1, 2.0, 0.15))
# Host seconds by layer: (class, method) -> name.
LAYERS = {("env", "step"): "mujoco step", ("env", "leg_heightmaps"): "sensing",
          ("wb", "update_state_and_reference"): "planners",
          ("ctrl", "compute_control"): "solve",
          ("wb", "compute_stance_and_swing_torque"): "torque path"}
READERS = ("feet_pos", "feet_vel", "hip_positions", "joints_pos", "joints_vel",
           "feet_jacobians", "feet_jacobians_dot", "legs_mass_matrix", "legs_qfrc_bias",
           "legs_qfrc_passive", "feet_contact_points")


def episodes(package, rows=EPISODES):
    """Run each episode with ``package`` ("jax" or "port", the port's plain path on
    the CPU) and return (name, walked m, fell, mean velocity error, mean height
    error, wall s per simulated s, host s by layer)."""
    import time

    from quadruped_pympc_tamols_tpu.interfaces import controller_interface as jci
    from quadruped_pympc_tamols_tpu.interfaces import wb_interface as jwb
    from quadruped_pympc_tamols_tpu.sim import mujoco_env as jenv
    from quadruped_pympc_tamols_torch.interfaces import controller_interface as tci
    from quadruped_pympc_tamols_torch.interfaces import wb_interface as twb
    from quadruped_pympc_tamols_torch.sim import mujoco_env as tenv

    classes = {"jax": {"env": jenv.QuadrupedEnv, "wb": jwb.WBInterface,
                       "ctrl": jci.SRBDControllerInterface},
               "port": {"env": tenv.QuadrupedEnv, "wb": twb.WBInterface,
                        "ctrl": tci.SRBDControllerInterface}}[package]
    acc = {}

    def timed(cls, name, key):
        fn = getattr(cls, name)

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0

        setattr(cls, name, wrapped)
        return fn

    saved = [(classes[c], m, timed(classes[c], m, key)) for (c, m), key in LAYERS.items()]
    saved += [(classes["env"], m, timed(classes["env"], m, "mujoco readers")) for m in READERS]
    out = []
    try:
        for name, strategy, scene, vel, seed, seconds, least in rows:
            over = {"sim.visual_foothold_adaptation": strategy, "sim.scene": scene}
            acc.clear()
            t0 = time.perf_counter()
            if package == "jax":
                res = jax_simulation.run_simulation(
                    jax_make_config("aliengo", mpc_type="sampling", **over),
                    episode_duration_s=seconds, ref_base_lin_vel=(vel, 0.0), seed=seed)[0]
            else:
                res = simulation.run_simulation(
                    make_config("aliengo", mpc_type="sampling", **over),
                    episode_duration_s=seconds, ref_base_lin_vel=(vel, 0.0), seed=seed,
                    device="cpu")[0]
            wall = time.perf_counter() - t0
            out.append((name, res.distance, res.fell, res.distance > least and not res.fell,
                        res.mean_vel_error, res.mean_height_error, wall / seconds,
                        {k: round(v, 3) for k, v in acc.items()}))
    finally:
        for cls, m, fn in saved:
            setattr(cls, m, fn)
    return out


if __name__ == "__main__":
    # python tests/test_torch_mujoco.py [jax|port ...]: the full-physics episodes on
    # the CPU, on the platform the tests use (tests/conftest.py), for PERF.md.
    import sys

    import conftest  # noqa: F401

    for package in sys.argv[1:] or ("jax", "port"):
        for row in episodes(package):
            print(f"{package}: %s: walked %.4f m, fell %s, in band %s, mean velocity error "
                  "%.4f m/s, mean height error %.4f m, %.3f wall s per simulated s, host s by "
                  "layer %s" % row, flush=True)
