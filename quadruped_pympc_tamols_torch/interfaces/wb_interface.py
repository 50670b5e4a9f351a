"""Whole-body interface: the planners around the MPC (host numpy).

Counterpart of ``quadruped_pympc_tamols_tpu/interfaces/wb_interface.py``
(reference interfaces/wb_interface.py:22-484). It owns the gait generator,
foothold reference generator, swing controller, terrain estimator, velocity
modulator and leg kinematics, and exposes
``update_state_and_reference``: gait timing and contact sequence, lift-off and
touch-down tracking, Raibert reference footholds, terrain slope/height estimation
and reference assembly (reference :108-302).

Terrain-aware adaptation (``sim.visual_foothold_adaptation`` "height" /
"tamols") runs the TAMOLS planner once per swing at its apex, on ``device``;
the rest is host numpy. ``compute_stance_and_swing_torque`` (with the
early-stance detector and the late-touchdown hold it feeds) arrives with the
MuJoCo harness, which supplies the leg Jacobians it needs; until then the
commanded swing state it records (``last_des_foot_pos``,
``_last_des_foot_vel``) stays zero, as it does in the JAX package's SRB harness.
"""
from __future__ import annotations

import collections

import numpy as np
from scipy.spatial.transform import Rotation

from ..config import Config
from ..gait.foothold_reference import FootholdReferenceGenerator
from ..gait.modulation import VelocityModulator
from ..gait.periodic import PeriodicGaitGenerator, make_timer_dts
from ..gait.swing import SwingTrajectoryController
from ..gait.terrain import TerrainEstimator
from ..kinematics.leg_ik import LegKinematics
from ..planner.tamols import TamolsPlanner
from ..utils.legs import Legs


class WBInterface:
    def __init__(self, cfg: Config, initial_feet_pos: Legs, device="cuda"):
        """``device`` is the TAMOLS planner's ("height" / "tamols"); blind
        footholds use none."""
        if cfg.sim.ik_solver != "analytic":
            raise NotImplementedError(
                f"sim.ik_solver={cfg.sim.ik_solver!r}: only the analytic IK is ported yet")
        self.cfg = cfg
        gait = cfg.gait_params
        self.pgg = PeriodicGaitGenerator(gait, cfg.mpc.horizon)
        self.timer_dts = make_timer_dts(cfg.mpc)
        self.frg = FootholdReferenceGenerator(gait.stance_time, initial_feet_pos,
                                              cfg.robot.hip_height)
        self.step_height = cfg.sim.step_height
        self.stc = SwingTrajectoryController(
            step_height=cfg.sim.step_height,
            swing_period=gait.swing_period,
            position_gain_fb=cfg.sim.swing_position_gain_fb,
            velocity_gain_fb=cfg.sim.swing_velocity_gain_fb,
            generator=cfg.sim.swing_generator,
            reflex_max_step_height=cfg.sim.reflex_max_step_height,
            liftoff_boost=cfg.sim.swing_liftoff_boost,
        )
        self.terrain_estimator = TerrainEstimator()
        self.ik = LegKinematics(cfg.robot)
        self.vm = VelocityModulator(activated=cfg.sim.velocity_modulator)
        self.vfa = (TamolsPlanner(cfg, device=device)
                    if cfg.sim.visual_foothold_adaptation != "blind" else None)
        self.current_contact = np.ones(4)
        self.previous_contact = np.ones(4)
        self.last_des_foot_pos = Legs.zeros((3,))
        # Commanded foot velocities of the last tick: a velocity-matched retarget
        # starts the re-planned curve from the commanded state.
        self._last_des_foot_vel = np.zeros((4, 3))
        # Moving-average base velocity for the foothold planner (the raw velocity
        # oscillates during stumbles and flips forward candidates infeasible).
        self._vel_hist = collections.deque(maxlen=20)

    def update_state_and_reference(self, com_pos, base_pos, base_lin_vel, base_ori_euler_xyz,
                                   base_ang_vel, feet_pos: Legs, hip_pos: Legs,
                                   joints_pos: Legs, heightmaps, simulation_dt: float,
                                   ref_base_lin_vel, ref_base_ang_vel):
        """Returns (state_current, ref_state, contact_sequence, step_height,
        optimize_swing) in the reference's dict schema."""
        cfg = self.cfg
        state_current = dict(
            position=np.asarray(com_pos) + self.frg.com_pos_offset_w,
            linear_velocity=np.asarray(base_lin_vel),
            orientation=np.asarray(base_ori_euler_xyz),
            angular_velocity=np.asarray(base_ang_vel),
            foot_FL=feet_pos.FL, foot_FR=feet_pos.FR,
            foot_RL=feet_pos.RL, foot_RR=feet_pos.RR,
            joint_FL=joints_pos.FL, joint_FR=joints_pos.FR,
            joint_RL=joints_pos.RL, joint_RR=joints_pos.RR,
        )

        if self.vm.activated:
            ref_base_lin_vel, ref_base_ang_vel = self.vm.modulate_velocities(
                np.asarray(ref_base_lin_vel), np.asarray(ref_base_ang_vel), feet_pos, hip_pos)

        if self.pgg.start_and_stop_activated:
            self.pgg.update_start_and_stop(
                feet_pos, hip_pos, self.frg.hip_offset, base_pos, base_ori_euler_xyz,
                base_lin_vel, base_ang_vel, ref_base_lin_vel, ref_base_ang_vel,
                self.current_contact)

        self.pgg.run(simulation_dt, self.pgg.step_freq)
        contact_sequence = self.pgg.compute_contact_sequence(self.timer_dts)
        self.previous_contact = self.current_contact.copy()
        self.current_contact = contact_sequence[:, 0].copy()

        self.frg.update_lift_off_positions(self.previous_contact, self.current_contact,
                                           feet_pos, self.pgg.gait_type, base_pos,
                                           base_ori_euler_xyz)
        self.frg.update_touch_down_positions(self.previous_contact, self.current_contact,
                                             feet_pos, self.pgg.gait_type, base_pos,
                                             base_ori_euler_xyz)
        ref_feet_pos = self.frg.compute_footholds_reference(
            base_pos, base_ori_euler_xyz, np.asarray(base_lin_vel)[:2],
            np.asarray(ref_base_lin_vel)[:2], hip_pos, cfg.sim.ref_z)

        # Terrain-aware foothold adaptation at the swing apex (reference :230-246):
        # computed once per swing when heightmaps are given; applying the stored
        # adaptation and the full-stance reset need no fresh sensing.
        ref_feet_constraints = None
        self._vel_hist.append(np.asarray(base_lin_vel, np.float64).copy())
        if self.vfa is not None:
            if heightmaps is not None \
                    and self.stc.check_apex_condition(self.current_contact, interval=0.01,
                                                      phase=cfg.tamols.trigger_phase) \
                    and not self.vfa.initialized:
                self._adapt_at_apex(heightmaps, np.asarray(ref_feet_pos.data), base_pos,
                                    feet_pos, hip_pos)
            if self.stc.check_full_stance_condition(self.current_contact):
                self.vfa.reset()
            adapted, ref_feet_constraints = self.vfa.get_footholds_adapted(
                np.asarray(ref_feet_pos.data))
            ref_feet_pos = Legs(np.asarray(adapted))

        # Terrain slope/height + reference rotation (reference :251-267).
        terrain_roll, terrain_pitch, terrain_height = \
            self.terrain_estimator.compute_terrain_estimation(
                base_pos, base_ori_euler_xyz[2], self.frg.lift_off_positions,
                self.current_contact)
        ref_pos = np.array([0.0, 0.0, cfg.sim.ref_z + terrain_height])
        ref_base_lin_vel = Rotation.from_euler("xyz", [terrain_roll, terrain_pitch, 0]) \
            .as_matrix() @ np.asarray(ref_base_lin_vel, np.float64)
        if terrain_pitch > 0.0:
            ref_base_lin_vel[2] = -ref_base_lin_vel[2]
        if abs(terrain_pitch) > 0.2:
            ref_base_lin_vel[0] /= 2.0
            ref_base_lin_vel[2] *= 2.0
        # Close the loop on the CoM height, not the base height (reference :273).
        ref_pos[2] -= np.asarray(base_pos)[2] - (np.asarray(com_pos)[2]
                                                 + self.frg.com_pos_offset_w[2])

        ref_state = dict(
            ref_foot_FL=ref_feet_pos.FL.reshape(1, 3),
            ref_foot_FR=ref_feet_pos.FR.reshape(1, 3),
            ref_foot_RL=ref_feet_pos.RL.reshape(1, 3),
            ref_foot_RR=ref_feet_pos.RR.reshape(1, 3),
            ref_foot_constraints=ref_feet_constraints,
            ref_linear_velocity=np.asarray(ref_base_lin_vel),
            ref_angular_velocity=np.asarray(ref_base_ang_vel),
            ref_orientation=np.array([terrain_roll, terrain_pitch, 0.0]),
            ref_position=ref_pos,
        )

        optimize_swing = 0
        if cfg.mpc.optimize_step_freq:
            optimize_swing = self.stc.check_touch_down_condition(
                self.current_contact, self.previous_contact, contact_sequence, lookahead=3)
        return state_current, ref_state, contact_sequence, self.step_height, optimize_swing

    def _adapt_at_apex(self, heightmaps, seeds, base_pos, feet_pos: Legs, hip_pos: Legs):
        """One planner call (JAX package :213-279): per-leg anchors and remaining
        swing times, then a re-plan of every swing whose touchdown moved."""
        cfg = self.cfg
        feet_now = np.asarray(feet_pos.data)
        lo_pos = np.asarray(self.frg.lift_off_positions.data)
        swinging = self.current_contact == 0
        # A swinging leg's foothold identity is its lift-off position (for the
        # progression cost and the 'foot' fallback); the stability diagonal and
        # the foot separation keep the current feet.
        feet_anchor = np.where(swinging[:, None], lo_pos, feet_now)
        # Flight-time reach inputs: what is left of this swing, or a full period
        # for the next swing of a stance leg.
        t_remain = np.full(4, self.stc.swing_period, np.float64)
        for leg in np.flatnonzero(swinging):
            t_remain[leg] = max(self.stc.swing_period - self.stc.swing_time[leg], 1e-3)
        self.vfa.compute_adaptation(
            heightmaps, seeds, np.asarray(hip_pos.data), np.asarray(base_pos),
            np.mean(self._vel_hist, axis=0), self.current_contact, feet_now,
            own_anchor=feet_anchor, t_remain=t_remain)
        if not cfg.tamols.retarget_swing:
            return
        # A touchdown moved by more than 3 cm re-plans the rest of its swing: from
        # the commanded point at the commanded velocity with a continuity-keeping
        # apex (retarget_velocity_match, mid-flight), else from the measured foot.
        adapted = self.vfa.footholds_adaptation
        des_prev = np.asarray(self.last_des_foot_pos.data)
        vmatch = cfg.tamols.retarget_velocity_match
        for leg in np.flatnonzero(swinging):
            if not np.linalg.norm(adapted[leg, :2] - seeds[leg, :2]) > 0.03:
                continue
            t_sw = float(self.stc.swing_time[leg])
            in_flight = vmatch and t_sw > 1.5 * cfg.sim.dt
            start = des_prev[leg] if in_flight else feet_now[leg]
            vel = self._last_des_foot_vel[leg] if in_flight else None
            apex = None
            if in_flight:
                apex = float(np.clip(max(lo_pos[leg, 2], adapted[leg, 2]) + self.stc.step_height
                                     - max(start[2], adapted[leg, 2]),
                                     0.02, self.stc.step_height))
            self.stc.retarget(leg, start, t_sw, velocity=vel, apex=apex)

    def reset(self, initial_feet_pos: Legs):
        self.pgg.reset()
        self.frg.lift_off_positions = Legs(np.asarray(initial_feet_pos.data).copy())
        if self.vfa is not None:
            self.vfa.reset()
        self.current_contact = np.ones(4)
        self.previous_contact = np.ones(4)
        self._last_des_foot_vel = np.zeros((4, 3))
        self._vel_hist.clear()
