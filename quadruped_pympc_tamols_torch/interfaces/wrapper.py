"""Facade wrapper: the one object a simulation or robot stack talks to.

Counterpart of ``quadruped_pympc_tamols_tpu/interfaces/wrapper.py`` (reference
QuadrupedPyMPC_Wrapper, quadruped_pympc/quadruped_pympc_wrapper.py:18-258): owns
the controller interface, the gradient family's batched gait optimizer and the
whole-body interface; ``compute_actions`` runs the planners, the MPC solve at the
MPC rate (on ``device``: for the sampling family one kernel launch, for the
nominal gradient MPC one CUDA-graph replay, and one device-to-host copy a solve
on the card) and the host torque path, and collects named observables
(:205-243). The ticks between solves touch the card only when the TAMOLS
planner runs at a swing apex, or the nominal solver's RTI preparation
(``mpc.gradient.use_RTI``) runs after a solve.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..utils.device import resolve_device
from ..utils.legs import Legs
from .controller_interface import SRBDBatchedControllerInterface, SRBDControllerInterface
from .wb_interface import WBInterface

ALL_OBSERVABLES = (
    "ref_base_height", "ref_base_angles", "ref_feet_pos", "nmpc_GRFs",
    "nmpc_footholds", "swing_time", "phase_signal", "lift_off_positions",
    "swing_period", "step_frequency", "optimize_swing",
)


class QuadrupedPyMPCWrapper:
    def __init__(self, cfg: Config, initial_feet_pos: Legs,
                 quadrupedpympc_observables_names=ALL_OBSERVABLES, seed: int = 42,
                 device="cuda"):
        """``device`` runs the MPC solve and the TAMOLS planner; ``"cpu"`` runs
        their plain torch versions. With ``mpc.optimize_step_freq`` and the gradient
        family, the batched gait optimizer picks the step frequency at each
        touch-down window (JAX package :30-33, :77-83)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.srbd_controller_interface = SRBDControllerInterface(cfg, seed=seed,
                                                                 device=self.device)
        self.srbd_batched_controller_interface = (
            SRBDBatchedControllerInterface(cfg, device=self.device)
            if (cfg.mpc.optimize_step_freq and cfg.mpc.type != "sampling") else None)
        self.wb_interface = WBInterface(cfg, initial_feet_pos, device=self.device)

        self.observables_names = quadrupedpympc_observables_names
        self.quadrupedpympc_observables = {}

        self.nmpc_GRFs = Legs.zeros((3,))
        self.nmpc_footholds = Legs(np.asarray(initial_feet_pos.data).copy())
        self.nmpc_predicted_state = None
        self.best_sample_freq = cfg.gait_params.step_freq
        self._step_counter = 0
        # MPC runs every 1/(mpc_frequency * sim_dt) sim steps (reference
        # quadruped_pympc_wrapper.py:134).
        self._mpc_every = max(1, int(round(1.0 / (cfg.sim.mpc_frequency * cfg.sim.dt))))

    def compute_actions(
        self, com_pos, base_pos, base_lin_vel, base_ori_euler_xyz, base_ang_vel,
        feet_pos: Legs, hip_pos: Legs, joints_pos: Legs, heightmaps,
        ref_base_lin_vel, ref_base_ang_vel, simulation_dt: float,
        qpos_js: Legs, qvel_js: Legs, feet_jac: Legs, feet_jac_dot: Legs,
        feet_vel: Legs, legs_qfrc_bias: Legs, legs_mass_matrix: Legs,
        legs_qfrc_passive: Legs | None = None, external_wrenches=None,
        contact_points=None, inertia=None,
    ) -> Legs:
        """One control tick; returns joint torques (Legs of (3,)). ``inertia`` (a
        callable or an array) reaches only a controller that consumes it: the
        nominal gradient MPC, not the sampling family."""
        (state_current, ref_state, contact_sequence, step_height, optimize_swing) = \
            self.wb_interface.update_state_and_reference(
                com_pos, base_pos, base_lin_vel, base_ori_euler_xyz, base_ang_vel,
                feet_pos, hip_pos, joints_pos, heightmaps, simulation_dt,
                ref_base_lin_vel, ref_base_ang_vel)

        if self._step_counter % self._mpc_every == 0:
            (self.nmpc_GRFs, self.nmpc_footholds, self.best_sample_freq,
             self.nmpc_predicted_state) = self.srbd_controller_interface.compute_control(
                state_current, ref_state, contact_sequence,
                external_wrenches=external_wrenches, inertia=inertia,
                current_contact=self.wb_interface.current_contact,
                previous_contact=self.wb_interface.previous_contact,
                phase_signal=self.wb_interface.pgg.phase_signal,
                optimize_swing=optimize_swing)
            # RTI preparation for the next tick, dispatched without waiting so it
            # overlaps the plant step (reference quadruped_pympc_wrapper.py:153-156);
            # a no-op on the sampling family.
            self.srbd_controller_interface.compute_rti()

            if self.srbd_batched_controller_interface is not None and optimize_swing:
                self.best_sample_freq = self.srbd_batched_controller_interface.optimize_gait(
                    state_current, ref_state, self.wb_interface.pgg.phase_signal,
                    self.wb_interface.pgg.duty_factor)
        self._step_counter += 1

        tau, des_q, des_qd = self.wb_interface.compute_stance_and_swing_torque(
            simulation_dt, qpos_js, qvel_js, feet_jac, feet_jac_dot, feet_pos,
            feet_vel, legs_qfrc_bias, legs_mass_matrix, self.nmpc_GRFs,
            self.nmpc_footholds, optimize_swing, self.best_sample_freq,
            base_pos=base_pos, base_rpy=base_ori_euler_xyz,
            legs_qfrc_passive=legs_qfrc_passive, contact_points=contact_points,
            nmpc_joints_pos=getattr(self.srbd_controller_interface, "nmpc_joints_pos", None),
            nmpc_joints_vel=getattr(self.srbd_controller_interface, "nmpc_joints_vel", None))

        self._collect_observables(ref_state, optimize_swing)
        self.des_joints_pos = des_q
        self.des_joints_vel = des_qd
        return tau

    def _collect_observables(self, ref_state, optimize_swing):
        wb = self.wb_interface
        values = {
            "ref_base_height": lambda: ref_state["ref_position"][2],
            "ref_base_angles": lambda: ref_state["ref_orientation"],
            "ref_feet_pos": lambda: np.stack([ref_state[f"ref_foot_{leg}"].reshape(3)
                                              for leg in ("FL", "FR", "RL", "RR")]),
            "nmpc_GRFs": lambda: np.asarray(self.nmpc_GRFs.data),
            "nmpc_footholds": lambda: np.asarray(self.nmpc_footholds.data),
            "swing_time": lambda: np.asarray(wb.stc.swing_time),
            "phase_signal": lambda: wb.pgg.phase_signal,
            "lift_off_positions": lambda: np.asarray(wb.frg.lift_off_positions.data),
            "swing_period": lambda: wb.stc.swing_period,
            "step_frequency": lambda: wb.pgg.step_freq,
            "optimize_swing": lambda: optimize_swing,
        }
        self.quadrupedpympc_observables = {name: values[name]()
                                           for name in self.observables_names
                                           if name in values}

    def get_obs(self) -> dict:
        """(reference quadruped_pympc_wrapper.py:247-253)"""
        return self.quadrupedpympc_observables

    def reset(self, initial_feet_pos: Legs):
        """(reference quadruped_pympc_wrapper.py:255-258)"""
        self.wb_interface.reset(initial_feet_pos)
        self.srbd_controller_interface.reset()
        self._step_counter = 0
