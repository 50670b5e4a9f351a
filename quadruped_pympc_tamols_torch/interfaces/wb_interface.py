"""Whole-body interface: the planners and the torque path around the MPC.

Counterpart of ``quadruped_pympc_tamols_tpu/interfaces/wb_interface.py``
(reference interfaces/wb_interface.py:22-484). It owns the gait generator,
foothold reference generator, swing controller, terrain estimator, velocity
modulator, early-stance detector and IK, and exposes

* ``update_state_and_reference`` — gait timing and contact sequence (with the
  late-touchdown hold), lift-off and touch-down tracking, Raibert reference
  footholds, terrain slope/height estimation and reference assembly (reference
  :108-302);
* ``compute_stance_and_swing_torque`` — stance tau = -J^T f, Cartesian swing
  tracking with reflex and planner re-planning, friction compensation, IK ->
  joint PD targets and saturation (reference :304-467).

Terrain-aware adaptation (``sim.visual_foothold_adaptation`` "height" /
"tamols") runs the TAMOLS planner once per swing at its apex, on ``device``.
Everything else is host numpy, in the JAX package's dtypes (float32 swing
references, float64 elsewhere): a tick of it is ~1k scalar flops, which on the
card would be a chain of latency-bound launches. The SRB harness never calls
the torque path, so there the commanded swing state it records
(``last_des_foot_pos``, ``_last_des_foot_vel``) stays zero, as in the JAX
package's harness.
"""
from __future__ import annotations

import collections

import numpy as np
from scipy.spatial.transform import Rotation

from ..config import LEGS, Config
from ..gait.foothold_reference import FootholdReferenceGenerator
from ..gait.modulation import EarlyStanceDetector, VelocityModulator
from ..gait.periodic import PeriodicGaitGenerator, make_timer_dts
from ..gait.swing import SwingTrajectoryController, swing_cartesian_torque, swing_refs_np
from ..gait.terrain import TerrainEstimator
from ..kinematics.ik_solvers import QPIK, NumericIK
from ..kinematics.leg_ik import LegKinematics
from ..planner.tamols import TamolsPlanner
from ..utils.frames import euler_xyz_to_rot_np
from ..utils.legs import Legs


class WBInterface:
    def __init__(self, cfg: Config, initial_feet_pos: Legs, device="cuda"):
        """``device`` is the TAMOLS planner's ("height" / "tamols"); blind
        footholds use none."""
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
        if cfg.sim.ik_solver == "numeric":
            self.ik = NumericIK(cfg.robot)
        elif cfg.sim.ik_solver == "qp":
            self.ik = QPIK(cfg.robot)
        else:
            self.ik = LegKinematics(cfg.robot)
        # Fused host path (all-leg swing references and the analytic IK in one
        # numpy pass); only the closed-form IK is stateless enough for it.
        self._fused_host_path = isinstance(self.ik, LegKinematics)
        # Leg geometry of the reach clamp (sim.swing_reach_clamp): hip positions in
        # the base frame and the linkage's longest hip-to-foot distance.
        self._hip_off = np.asarray(LegKinematics(cfg.robot).hip_offsets_b, np.float64)
        self._leg_reach = float(np.hypot(cfg.robot.hip_offset_y,
                                         cfg.robot.thigh_length + cfg.robot.calf_length))
        self.vm = VelocityModulator(activated=cfg.sim.velocity_modulator)
        # Reflexes run for every controller family; only the 'scipy' swing
        # generator re-plans from their hitpoints (JAX package :75-86).
        self.esd = EarlyStanceDetector(trigger_mode=cfg.sim.reflex_trigger_mode,
                                       activated=cfg.sim.reflex_trigger_mode != "off")
        self._reflex_replanning = cfg.sim.swing_generator == "scipy"
        self.vfa = (TamolsPlanner(cfg, device=device)
                    if cfg.sim.visual_foothold_adaptation != "blind" else None)
        self.current_contact = np.ones(4)
        self._last_td_targets = None  # (4, 3) swing touchdown targets of the last tick
        self._hold_active = np.zeros(4, bool)  # late-touchdown hold latch
        self._hold_ticks = np.zeros(4, int)  # hold duration (safety cap)
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
        if cfg.sim.late_touchdown_hold > 0.0 and self._last_td_targets is not None:
            self._hold_late_touchdowns(np.asarray(feet_pos.data), contact_sequence,
                                       simulation_dt)

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

    def _hold_late_touchdowns(self, feet, contact_sequence, simulation_dt):
        """Late-touchdown hold (sim.late_touchdown_hold, JAX package :146-191):
        refuse the timer's swing->stance flip while the foot is still above its
        leg's touchdown target by more than the hold (or, with
        sim.late_touchdown_hold_xy, off it laterally by more than that), and zero
        the leg's first contact column so the MPC loads only real supports. A
        held leg keeps its latched target; a hold ends after 0.5 s."""
        cfg = self.cfg
        hold_xy = cfg.sim.late_touchdown_hold_xy
        for leg in range(4):
            late = feet[leg, 2] > self._last_td_targets[leg, 2] + cfg.sim.late_touchdown_hold
            if hold_xy > 0.0 and not late:
                late = np.linalg.norm(feet[leg, :2] - self._last_td_targets[leg, :2]) > hold_xy
            if late and self._hold_ticks[leg] * simulation_dt > 0.5:
                late = False
            if self.previous_contact[leg] == 0 and self.current_contact[leg] == 1 and late:
                self.current_contact[leg] = 0.0
                contact_sequence[leg, 0] = 0.0
                self._hold_active[leg] = True
                self._hold_ticks[leg] += 1
            else:
                self._hold_active[leg] = False
                self._hold_ticks[leg] = 0

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

    def compute_stance_and_swing_torque(
        self, simulation_dt, qpos_js: Legs, qvel_js: Legs, feet_jac: Legs,
        feet_jac_dot: Legs, feet_pos: Legs, feet_vel: Legs, legs_qfrc_bias: Legs,
        legs_mass_matrix: Legs, nmpc_GRFs: Legs, nmpc_footholds: Legs,
        optimize_swing: int, best_sample_freq: float, base_pos=None, base_rpy=None,
        legs_qfrc_passive: Legs | None = None, contact_points=None,
        nmpc_joints_pos=None, nmpc_joints_vel=None,
    ):
        """Returns (tau: Legs, des_joints_pos: Legs, des_joints_vel: Legs); JAX
        package :332-543."""
        cfg = self.cfg
        # Touchdown targets of the late-touchdown hold (next tick); held legs keep
        # their latched target.
        new_td = np.asarray(nmpc_footholds.data, np.float64)
        if self._last_td_targets is None:
            self._last_td_targets = new_td.copy()
        else:
            self._last_td_targets = np.where(self._hold_active[:, None],
                                             self._last_td_targets, new_td)
        if optimize_swing == 1:
            # Step-frequency hand-off from the gait-adaptive solve.
            self.pgg.step_freq = float(best_sample_freq)
            self.frg.stance_time = self.pgg.duty_factor / self.pgg.step_freq
            swing_period = (1 - self.pgg.duty_factor) / self.pgg.step_freq
            self.stc.regenerate_swing_trajectory_generator(self.step_height, swing_period)

        self.esd.update_detection(
            feet_pos, self.last_des_foot_pos, self.frg.lift_off_positions,
            nmpc_footholds, self.stc.swing_time, self.stc.swing_period,
            self.current_contact, self.previous_contact, contact_points=contact_points)

        # Stance torque tau = -J^T f (reference :369-372).
        tau = np.zeros((4, 3))
        jac = np.asarray(feet_jac.data)  # (4, 3, 3) world-frame foot Jacobians
        grfs = np.asarray(nmpc_GRFs.data)
        for leg in range(4):
            tau[leg] = -jac[leg].T @ grfs[leg]

        self.stc.update_swing_time(self.current_contact, simulation_dt)

        des_foot_pos = np.zeros((4, 3))
        des_foot_vel = np.zeros((4, 3))
        if self._fused_host_path:
            des_foot_pos, des_foot_vel, des_q = self._fused_swing(
                tau, jac, feet_pos, feet_vel, feet_jac_dot, qvel_js, legs_qfrc_bias,
                legs_mass_matrix, nmpc_footholds, base_pos, base_rpy)
        else:
            for leg, leg_name in enumerate(LEGS):
                if self.current_contact[leg] == 0:
                    t, p, v = self.stc.compute_swing_control_cartesian_space(
                        leg_id=leg,
                        q_dot=np.asarray(qvel_js[leg_name]).reshape(3),
                        J=jac[leg],
                        J_dot=np.asarray(feet_jac_dot[leg_name]),
                        lift_off=self.frg.lift_off_positions[leg_name],
                        touch_down=(np.asarray(nmpc_footholds[leg_name]).reshape(3)
                                    - np.array([0.0, 0.0, cfg.sim.touchdown_overdrive])),
                        foot_pos=np.asarray(feet_pos[leg_name]),
                        foot_vel=np.asarray(feet_vel[leg_name]),
                        h=np.asarray(legs_qfrc_bias[leg_name]).reshape(3),
                        mass_matrix=np.asarray(legs_mass_matrix[leg_name]),
                        early_stance_hitmoment=(self.esd.hitmoments[leg]
                                                if self._reflex_replanning else -1.0),
                        early_stance_hitpoint=(self.esd.hitpoints[leg]
                                               if self._reflex_replanning else None),
                    )
                    tau[leg] = t
                    des_foot_pos[leg] = p
                    des_foot_vel[leg] = v
                else:
                    # Stance legs hold their current position.
                    des_foot_pos[leg] = np.asarray(feet_pos[leg_name]).reshape(3)

        self.last_des_foot_pos = Legs(des_foot_pos.copy())
        self._last_des_foot_vel = des_foot_vel.copy()

        # Friction compensation (reference :411-415).
        if self.stc.use_friction_compensation and legs_qfrc_passive is not None:
            tau = tau - np.asarray(legs_qfrc_passive.data)

        # IK -> joint PD targets (reference :425-438).
        if not self._fused_host_path:
            des_q = self.ik.compute_solution(
                np.asarray(base_pos), np.asarray(base_rpy), des_foot_pos[0],
                des_foot_pos[1], des_foot_pos[2], des_foot_pos[3]).reshape(4, 3)
        des_qd = np.zeros((4, 3))
        for leg in range(4):
            # Damped inverse: a near-singular leg would otherwise yield huge
            # joint-velocity targets.
            Jm = jac[leg]
            des_qd[leg] = Jm.T @ np.linalg.inv(Jm @ Jm.T + 2e-3 * np.eye(3)) \
                @ des_foot_vel[leg]

        # Kinodynamic variant: the OCP's joint trajectories override the IK targets
        # (reference wb_interface.py:440-443).
        if nmpc_joints_pos is not None:
            des_q = np.asarray(nmpc_joints_pos)[0].reshape(4, 3)
            if nmpc_joints_vel is not None:
                des_qd = np.asarray(nmpc_joints_vel)[0].reshape(4, 3)

        # Saturation (reference :446-465).
        q_now = np.asarray(qpos_js.data).reshape(4, 3)
        qd_now = np.asarray(qvel_js.data).reshape(4, 3)
        des_q = q_now + np.clip(des_q - q_now, -3.0, 3.0)
        des_qd = qd_now + np.clip(des_qd - qd_now, -10.0, 10.0)
        return Legs(tau), Legs(des_q), Legs(des_qd)

    def _fused_swing(self, tau, jac, feet_pos, feet_vel, feet_jac_dot, qvel_js,
                     legs_qfrc_bias, legs_mass_matrix, nmpc_footholds, base_pos, base_rpy):
        """The analytic IK's path (JAX package :373-481): all legs' swing
        references in one float32-input numpy pass, with reflex and planner
        re-planning, the touchdown overdrive and the reach clamp, then the
        analytic IK and each swing leg's Cartesian torque (written into ``tau``).
        Returns (des_foot_pos, des_foot_vel, des_q)."""
        cfg, stc = self.cfg, self.stc
        t_eff = np.asarray(stc.swing_time, np.float32).copy()
        period = np.full(4, stc.swing_period, np.float32)
        step_h = np.full(4, stc.step_height, np.float32)
        lo = np.asarray(self.frg.lift_off_positions.data, np.float32).copy()
        v0 = np.zeros((4, 3), np.float32)
        v0_mask = np.zeros(4, np.float32)
        for leg in range(4):
            hm, hp = ((self.esd.hitmoments[leg], self.esd.hitpoints[leg])
                      if self._reflex_replanning else (-1.0, None))
            if hp is None and stc.retarget_points[leg] is not None:
                # Planner-moved touchdown: the same re-planning, with the start
                # velocity and apex the retarget recorded.
                hm, hp = stc.retarget_moments[leg], stc.retarget_points[leg]
                if stc.retarget_apexes[leg] is not None:
                    step_h[leg] = stc.retarget_apexes[leg]
                if stc.retarget_vels[leg] is not None:
                    v0[leg] = stc.retarget_vels[leg]
                    v0_mask[leg] = 1.0
            elif hp is not None and hm >= 0.0:
                step_h[leg] = stc.reflex_max_step_height
            if hp is not None and hm >= 0.0:
                # Reflex re-planning from the hitpoint
                # (reference scipy_swing_trajectory_generator.py:25-47).
                lo[leg] = np.asarray(hp, np.float32)
                period[leg] = max(stc.swing_period - hm, 1e-3)
                t_eff[leg] = t_eff[leg] - hm
        swing_mask = (np.asarray(self.current_contact) == 0).astype(np.float32)
        td = np.asarray(nmpc_footholds.data, np.float32).copy()
        # Touchdown overdrive (sim.touchdown_overdrive): aim the curve end below the
        # planned foothold so contact comes before the timer declares stance.
        td[:, 2] -= cfg.sim.touchdown_overdrive
        pos, vel, acc = swing_refs_np(stc.generator, t_eff, period, step_h, lo, td,
                                      liftoff_boost=stc.liftoff_boost, v0=v0, v0_mask=v0_mask)
        m = swing_mask[:, None].astype(np.float64)
        # Stance legs hold their current position: their IK/PD target must not be
        # the next foothold, or the joint impedance drags planted feet along.
        feet = np.asarray(feet_pos.data, np.float64)
        des_foot_pos = m * pos + (1.0 - m) * feet
        des_foot_vel = m * vel
        des_acc = m * acc
        if cfg.sim.swing_reach_clamp > 0.0:
            self._clamp_reach(des_foot_pos, des_foot_vel, des_acc, td, base_pos, base_rpy)
        des_q = self.ik.ik_world(des_foot_pos, np.asarray(base_pos),
                                 euler_xyz_to_rot_np(base_rpy))
        fvel = np.asarray(feet_vel.data)
        jdot = np.asarray(feet_jac_dot.data)
        qd = np.asarray(qvel_js.data).reshape(4, 3)
        h_b = np.asarray(legs_qfrc_bias.data).reshape(4, 3)
        M = np.asarray(legs_mass_matrix.data)
        for leg in range(4):
            if self.current_contact[leg] == 0:
                tau[leg] = swing_cartesian_torque(
                    des_foot_pos[leg], des_foot_vel[leg], des_acc[leg], feet[leg], fvel[leg],
                    jac[leg], jdot[leg], qd[leg], h_b[leg], M[leg], stc.position_gain_fb,
                    stc.velocity_gain_fb, stc.use_feedback_linearization)
        return des_foot_pos, des_foot_vel, des_q

    def _clamp_reach(self, des_foot_pos, des_foot_vel, des_acc, td, base_pos, base_rpy):
        """Reach clamp (sim.swing_reach_clamp, JAX package :436-465), in place: a
        swing command outside the leg's sphere around the current hip moves onto
        it, loses its outward radial velocity and its acceleration; while still
        more than 4 cm from the touchdown target in xy it first holds its altitude
        at least 5 cm above the target."""
        R_b = euler_xyz_to_rot_np(base_rpy)
        hips_w = np.asarray(base_pos)[None, :] + self._hip_off @ R_b.T
        r_safe = self.cfg.sim.swing_reach_clamp * self._leg_reach
        for leg in range(4):
            if self.current_contact[leg] != 0:
                continue
            v = des_foot_pos[leg] - hips_w[leg]
            d = float(np.linalg.norm(v))
            if not d > r_safe:
                continue
            dxy = float(np.linalg.norm(td[leg, :2] - des_foot_pos[leg, :2]))
            if dxy > 0.04:
                des_foot_pos[leg, 2] = max(des_foot_pos[leg, 2], td[leg, 2] + 0.05)
                v = des_foot_pos[leg] - hips_w[leg]
                d = float(np.linalg.norm(v))
            u = v / d
            des_foot_pos[leg] = hips_w[leg] + u * r_safe
            out_rad = float(des_foot_vel[leg] @ u)
            if out_rad > 0.0:
                des_foot_vel[leg] -= out_rad * u
            des_acc[leg] = 0.0

    def reset(self, initial_feet_pos: Legs):
        self.pgg.reset()
        self.frg.lift_off_positions = Legs(np.asarray(initial_feet_pos.data).copy())
        if self.vfa is not None:
            self.vfa.reset()
        self.esd.reset()
        self.current_contact = np.ones(4)
        self._last_td_targets = None
        self._hold_active = np.zeros(4, bool)
        self._hold_ticks = np.zeros(4, int)
        self.previous_contact = np.ones(4)
        self._last_des_foot_vel = np.zeros((4, 3))
        self._vel_hist.clear()
