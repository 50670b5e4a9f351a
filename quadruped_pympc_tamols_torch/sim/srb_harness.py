"""Idealized SRB closed-loop harness: the full control stack walking, no MuJoCo.

Counterpart of ``quadruped_pympc_tamols_tpu/sim/srb_harness.py``. The plant is
the single-rigid-body model the MPC predicts (``dynamics/srbd.py``, float32 on
the host); feet are kinematic: stance feet pin to their touch-down points, swing
feet follow the commanded Bezier swing and land on the MPC footholds. The loop
runs through the real planner and controller stack (``WBInterface`` gait,
foothold and terrain pipeline + ``SRBDControllerInterface``), so a test can
assert that the robot walks.

The MPC solve and the TAMOLS foothold planner ("height" / "tamols", once per
swing apex) run on ``device``; the per-tick planner, swing and plant layers stay
on the host. Like the JAX harness it senses nothing itself: a caller hands
``step`` the heightmaps, and ``terrain_fn`` snaps touchdowns to the terrain.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config, LEGS
from ..dynamics.srbd import integrate_euler, make_params
from ..gait.swing import bezier_swing_refs
from ..interfaces.controller_interface import SRBDControllerInterface
from ..interfaces.wb_interface import WBInterface
from ..utils.device import resolve_device
from ..utils.frames import euler_xyz_to_rot_np
from ..utils.legs import Legs


class SRBClosedLoopHarness:
    def __init__(self, cfg: Config, seed: int = 0, terrain_fn=None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = make_params(cfg)  # host float32 plant
        self.terrain_fn = terrain_fn  # z = f(x, y), or None for flat ground
        rp = cfg.robot
        self.default_feet = np.array([
            [rp.hip_x, rp.hip_y + 0.1, 0.0],
            [rp.hip_x, -rp.hip_y - 0.1, 0.0],
            [-rp.hip_x, rp.hip_y + 0.1, 0.0],
            [-rp.hip_x, -rp.hip_y - 0.1, 0.0],
        ])
        self.reset(seed)

    def reset(self, seed: int = 0):
        cfg = self.cfg
        self.x = np.zeros(12)
        self.x[2] = cfg.sim.ref_z
        self.feet = self.default_feet.copy()
        self.wb = WBInterface(cfg, Legs(self.feet.copy()), device=self.device)
        self.ctrl = SRBDControllerInterface(cfg, seed=seed, device=self.device)
        self.grfs = Legs.zeros((3,))
        self.footholds = Legs(self.feet.copy())
        self.best_freq = cfg.gait_params.step_freq
        self.t = 0.0
        self._mpc_every = max(1, int(round(1.0 / (cfg.sim.mpc_frequency * cfg.sim.dt))))
        self._step = 0

    def hips_world(self):
        return self.x[0:3] + self.wb.ik.hip_offsets_b @ euler_xyz_to_rot_np(self.x[6:9]).T

    def _plant_step(self):
        """SRB dynamics under the commanded GRFs, one Euler step in float32."""
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32))

        x = integrate_euler(f32(self.x), f32(self.feet), f32(self.grfs.data),
                            f32(self.wb.current_contact), self.params, self.cfg.sim.dt)
        return x.numpy().astype(np.float64)

    def step(self, ref_base_lin_vel, ref_base_ang_vel=None, heightmaps=None):
        cfg = self.cfg
        ref_base_ang_vel = np.zeros(3) if ref_base_ang_vel is None else ref_base_ang_vel
        state_current, ref_state, contact_seq, _, optimize_swing = \
            self.wb.update_state_and_reference(
                com_pos=self.x[0:3], base_pos=self.x[0:3], base_lin_vel=self.x[3:6],
                base_ori_euler_xyz=self.x[6:9], base_ang_vel=self.x[9:12],
                feet_pos=Legs(self.feet.copy()), hip_pos=Legs(self.hips_world()),
                joints_pos=Legs.zeros((3,)), heightmaps=heightmaps,
                simulation_dt=cfg.sim.dt, ref_base_lin_vel=np.asarray(ref_base_lin_vel),
                ref_base_ang_vel=ref_base_ang_vel)

        if self._step % self._mpc_every == 0:
            self.grfs, self.footholds, self.best_freq, _ = self.ctrl.compute_control(
                state_current, ref_state, contact_seq,
                current_contact=self.wb.current_contact,
                previous_contact=self.wb.previous_contact,
                phase_signal=self.wb.pgg.phase_signal,
                optimize_swing=optimize_swing)
        self._step += 1
        # Between MPC ticks too, with the last solved frequency (as the JAX harness).
        if optimize_swing and cfg.mpc.optimize_step_freq:
            self.wb.pgg.step_freq = float(self.best_freq)

        self.x = self._plant_step()

        # Kinematic feet: swing feet follow the swing curve toward the MPC foothold.
        self.wb.stc.update_swing_time(self.wb.current_contact, cfg.sim.dt)
        for leg, leg_name in enumerate(LEGS):
            prev_c = self.wb.previous_contact[leg]
            cur_c = self.wb.current_contact[leg]
            if cur_c == 0:
                pos, _, _ = bezier_swing_refs(
                    self.wb.stc.swing_time[leg], self.wb.stc.swing_period, self.wb.step_height,
                    self.wb.frg.lift_off_positions[leg_name],
                    np.asarray(self.footholds[leg_name]))
                self.feet[leg] = pos
            elif prev_c == 0 and cur_c == 1:
                # Touch-down: land on the commanded foothold, snapped to the terrain.
                td = np.asarray(self.footholds[leg_name], np.float64).copy()
                td[2] = 0.0 if self.terrain_fn is None else float(self.terrain_fn(td[0], td[1]))
                self.feet[leg] = td

        self.t += cfg.sim.dt
        return self.x.copy()

    def run(self, duration: float, ref_base_lin_vel, ref_base_ang_vel=None):
        """Run the loop; returns the state history (T, 12)."""
        n = int(round(duration / self.cfg.sim.dt))
        hist = np.zeros((n, 12))
        for i in range(n):
            hist[i] = self.step(ref_base_lin_vel, ref_base_ang_vel)
        return hist
