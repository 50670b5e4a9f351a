"""Main MuJoCo simulation harness.

Counterpart of ``quadruped_pympc_tamols_tpu/sim/simulation.py`` (reference
run_simulation, simulation/simulation.py:395-806): builds the env (scene,
velocity and friction randomization), the per-leg heightmap sensing and the
QuadrupedPyMPCWrapper, then runs the episode loop — MuJoCo state reads ->
compute_actions -> swing-leg joint PD -> torque clipping -> env.step — with the
fall test and per-episode metrics. Headless and deterministic unless asked for
video (``video_path``: ``sim/video.py``'s offscreen recorder) or the live viewer
(``render``), both of which need a GL backend, as in the JAX package. The MPC
solve and the TAMOLS planner run on ``device``; MuJoCo and the torque path on the
host.
"""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np

from ..config import Config
from ..interfaces.wrapper import QuadrupedPyMPCWrapper
from ..utils.device import resolve_device
from ..utils.legs import Legs
from .mujoco_env import QuadrupedEnv


@dataclasses.dataclass
class EpisodeResult:
    duration: float
    distance: float
    mean_vel_error: float
    mean_height_error: float
    fell: bool
    state_history: np.ndarray  # (T, 12)


def run_simulation(
    cfg: Config,
    num_episodes: int = 1,
    episode_duration_s: float = 5.0,
    ref_base_lin_vel=(0.3, 0.0),
    ref_base_ang_vel: float = 0.0,
    friction_range=(0.8, 0.8),
    seed: int = 0,
    scene: str | None = None,
    use_heightmaps: bool | None = None,
    logger=None,
    video_path: str | None = None,
    video_fps: float = 30.0,
    leg_mass_fraction: float = 0.15,
    render: bool = False,
    spawn=None,
    device="cuda",
):
    """Run episodes; returns a list of EpisodeResult.

    ``ref_base_lin_vel`` is a fixed (vx, vy), a ("random", lo, hi) tuple for
    randomized-velocity datagen (reference simulation.py:433-442), or a callable
    t -> (vx, vy) (or (t, base_pos) -> (vx, vy)) evaluated every step.
    ``video_path`` records each episode at ``video_fps`` (``sim/video.py``; a '%d'
    in the path takes the episode index); ``render`` opens MuJoCo's passive
    viewer with the debug overlays and its 'V' key toggles a recording into
    ``recordings/``.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    results = []
    scene = scene or cfg.sim.scene
    use_hm = (cfg.sim.visual_foothold_adaptation != "blind"
              if use_heightmaps is None else use_heightmaps)

    for ep in range(num_episodes):
        friction = rng.uniform(*friction_range)
        env = QuadrupedEnv(cfg, scene=scene, friction=friction, seed=seed + ep,
                           leg_mass_fraction=leg_mass_fraction)
        if spawn is not None:
            # Spawn mid-course; spawn = (x, y, ground_z).
            env.reset(base_pos=np.array([spawn[0], spawn[1],
                                         spawn[2] + cfg.robot.hip_height + 0.03]))
        vel_schedule = None
        if callable(ref_base_lin_vel):
            n_args = len(inspect.signature(ref_base_lin_vel).parameters)
            vel_schedule = (ref_base_lin_vel if n_args >= 2
                            else lambda t, _pos, _f=ref_base_lin_vel: _f(t))
            vel_cmd = np.array([*vel_schedule(0.0, env.base_pos), 0.0])
        elif isinstance(ref_base_lin_vel, tuple) and ref_base_lin_vel \
                and ref_base_lin_vel[0] == "random":
            vel_cmd = np.array([rng.uniform(ref_base_lin_vel[1], ref_base_lin_vel[2]),
                                0.0, 0.0])
        else:
            vel_cmd = np.array([ref_base_lin_vel[0], ref_base_lin_vel[1], 0.0])

        wrapper = QuadrupedPyMPCWrapper(cfg, env.feet_pos(), seed=seed + ep, device=device)
        tau_max = np.asarray(env.model.actuator_ctrlrange[:, 1]).reshape(4, 3)
        recorder = None
        if video_path is not None:
            from .video import VideoRecorder
            recorder = VideoRecorder(env, video_path, fps=video_fps)
        viewer, live_rec = None, {"rec": None}
        if render:
            viewer = _launch_viewer(env, live_rec, video_fps)
            next_sync = 0.0

        n_steps = int(round(episode_duration_s / env.sim_dt))
        hist = np.zeros((n_steps, 12))
        vel_err = []
        height_err = []
        fell = False
        x0 = env.base_pos.copy()

        for t in range(n_steps):
            if vel_schedule is not None:
                vel_cmd = np.array([*vel_schedule(t * env.sim_dt, env.base_pos), 0.0])
            heightmaps = None
            if use_hm and wrapper.wb_interface.vfa is not None \
                    and not wrapper.wb_interface.vfa.initialized:
                # Sense while the planner waits for its apex trigger (it adapts
                # once per swing). The grids stay on the host; the planner moves
                # them to the card only when it scores, at the apex.
                ref_feet = wrapper.wb_interface.frg.last_reference_footholds
                heightmaps = env.leg_heightmaps(ref_feet, env.base_ori_euler_xyz[2],
                                                device="cpu")

            tau = wrapper.compute_actions(
                com_pos=env.com_pos, base_pos=env.base_pos,
                base_lin_vel=env.base_lin_vel,
                base_ori_euler_xyz=env.base_ori_euler_xyz,
                base_ang_vel=env.base_ang_vel,
                feet_pos=env.feet_pos(), hip_pos=env.hip_positions(),
                joints_pos=env.joints_pos(), heightmaps=heightmaps,
                ref_base_lin_vel=vel_cmd,
                ref_base_ang_vel=np.array([0.0, 0.0, ref_base_ang_vel]),
                simulation_dt=env.sim_dt,
                qpos_js=env.joints_pos(), qvel_js=env.joints_vel(),
                feet_jac=env.feet_jacobians(), feet_jac_dot=env.feet_jacobians_dot(),
                feet_vel=env.feet_vel(), legs_qfrc_bias=env.legs_qfrc_bias(),
                legs_mass_matrix=env.legs_mass_matrix(),
                legs_qfrc_passive=env.legs_qfrc_passive(),
                contact_points=(env.feet_contact_points()
                                if cfg.sim.reflex_trigger_mode == "geom_contact" else None),
                # A callable: evaluated only by a controller that consumes it.
                inertia=env.srb_inertia if cfg.sim.use_inertia_recomputation else None,
            )
            # Feedforward torque plus the impedance joint PD toward the IK targets
            # (which hold stance feet in place), clipped to 0.9 ctrlrange
            # (reference simulation.py:477-485, 683-696).
            tau_total = np.asarray(tau.data)
            q_err = np.asarray(wrapper.des_joints_pos.data) - np.asarray(env.joints_pos().data)
            qd_err = np.asarray(wrapper.des_joints_vel.data) - np.asarray(env.joints_vel().data)
            tau_total = tau_total + (cfg.sim.impedance_joint_position_gain * q_err
                                     + cfg.sim.impedance_joint_velocity_gain * qd_err)
            tau_total = np.clip(tau_total, -0.9 * tau_max, 0.9 * tau_max)
            env.step(Legs(tau_total))

            x = np.concatenate([env.base_pos, env.base_lin_vel,
                                env.base_ori_euler_xyz, env.base_ang_vel])
            hist[t] = x
            vel_err.append(np.linalg.norm(x[3:5] - vel_cmd[:2]))
            height_err.append(abs(x[2] - cfg.sim.ref_z))
            if logger is not None:
                logger.log(t * env.sim_dt, env, wrapper)
            if recorder is not None:
                recorder.maybe_capture(t * env.sim_dt, wrapper)
            if live_rec["rec"] is not None:
                live_rec["rec"].maybe_capture(t * env.sim_dt, wrapper)
            if viewer is not None:
                if not viewer.is_running():
                    break
                if t * env.sim_dt >= next_sync:
                    # The live overlays (reference simulation.py:713-764) at 30 Hz.
                    from .video import draw_overlays
                    viewer.user_scn.ngeom = 0
                    draw_overlays(viewer.user_scn, env, wrapper)
                    viewer.sync()
                    next_sync = t * env.sim_dt + 1.0 / 30.0
            if x[2] < 0.5 * cfg.sim.ref_z or abs(x[6]) > 0.8 or abs(x[7]) > 0.8:
                fell = True
                hist = hist[: t + 1]
                break

        if recorder is not None:
            recorder.close(episode=ep)
        if live_rec["rec"] is not None:  # still recording at the episode's end
            print(f"[video] saved {live_rec['rec'].close()}", flush=True)
            live_rec["rec"] = None
        if viewer is not None:
            viewer.close()

        results.append(EpisodeResult(
            duration=len(hist) * env.sim_dt,
            distance=float(env.base_pos[0] - x0[0]),
            mean_vel_error=float(np.mean(vel_err)),
            mean_height_error=float(np.mean(height_err)),
            fell=fell,
            state_history=hist,
        ))
    return results


def _launch_viewer(env, live_rec, video_fps):
    """MuJoCo's passive viewer of ``env`` (reference simulation.py:713-770), its 'V'
    key toggling a recording (reference simulation/video_recorder.py:17-207) into
    ``live_rec["rec"]``, saved under ``recordings/``. Raises where there is no
    display, as the JAX package's does."""
    import mujoco.viewer as mj_viewer

    def key_cb(keycode):
        if keycode not in (ord("v"), ord("V")):
            return
        if live_rec["rec"] is None:
            import os
            import time

            from .video import VideoRecorder
            os.makedirs("recordings", exist_ok=True)
            fname = time.strftime("recordings/live_%Y%m%d_%H%M%S.mp4")
            live_rec["rec"] = VideoRecorder(env, fname, fps=video_fps)
            print(f"[video] recording -> {fname}", flush=True)
        else:
            print(f"[video] saved {live_rec['rec'].close()}", flush=True)
            live_rec["rec"] = None

    return mj_viewer.launch_passive(env.model, env.data, key_callback=key_cb)
