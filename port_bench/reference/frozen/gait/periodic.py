"""Periodic gait generation as pure phase arithmetic (host numpy).

Counterpart of ``quadruped_pympc_tamols_tpu/gait/periodic.py`` (reference
helpers/periodic_gait_generator.py:8-196). A leg's contact at elapsed time t is
``((phase0 + f*t) mod 1) < duty``, so the whole (4, H) sequence is one broadcasted
comparison. The one-robot gait layer stays on the host: it is a few dozen scalar
operations, far cheaper than a device round trip. The scenario fleet
(``parallel/scenario_engine.py``) keeps its gait on the device and calls the
torch twin ``contact_sequence_torch``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import GAIT_PHASE_OFFSETS, GaitParams, GaitType, MPCParams


@dataclasses.dataclass
class GaitState:
    """Per-leg phase signal in [0, 1): a (..., 4) tensor (batch dimensions allowed),
    the counterpart of the JAX package's pytree of the same name."""

    phase: torch.Tensor  # (..., 4)


def advance_phase(phase, dt, step_freq):
    """Advance the per-leg phase: (phase + dt*f) mod 1 (reference
    periodic_gait_generator.py:53-56); a tensor for a tensor, else numpy."""
    if isinstance(phase, torch.Tensor):
        return torch.remainder(phase + dt * step_freq, 1.0)
    f = np.asarray(step_freq, np.float32)
    return np.mod(np.asarray(phase, np.float32) + np.float32(dt) * f, np.float32(1.0))


def contact_from_phase(phase, duty_factor):
    """Stance mask, float32: phase < duty (reference periodic_gait_generator.py:71-74)."""
    if isinstance(phase, torch.Tensor):
        return (phase < duty_factor).to(torch.float32)
    return (np.asarray(phase) < duty_factor).astype(np.float32)


def make_timer_dts(mpc: MPCParams) -> np.ndarray:
    """(H,) elapsed-time offsets of the contact-sequence columns, t_0 = 0
    (reference compute_contact_sequence, periodic_gait_generator.py:104-117)."""
    H = mpc.horizon
    steps = np.zeros(H, dtype=np.float32)
    for i in range(1, H):
        if mpc.use_nonuniform_discretization and i < mpc.horizon_fine_grained:
            steps[i] = mpc.dt_fine_grained
        else:
            steps[i] = mpc.dt
    return np.cumsum(steps).astype(np.float32)


def contact_sequence(phase, step_freq, duty_factor, t_offsets, full_stance=False):
    """(..., 4, H) float32 stance sequence over the horizon, closed form.

    phase (..., 4); step_freq and duty_factor scalar or batched (...,);
    t_offsets (H,) from make_timer_dts."""
    phase = np.asarray(phase, np.float32)
    t_offsets = np.asarray(t_offsets, np.float32)
    if full_stance:
        return np.ones(phase.shape[:-1] + (4, t_offsets.shape[0]), np.float32)
    f = np.asarray(step_freq, np.float32)[..., None, None]
    ph = np.mod(phase[..., :, None] + f * t_offsets, np.float32(1.0))
    return (ph < np.asarray(duty_factor, np.float32)[..., None, None]).astype(np.float32)


def contact_sequence_torch(phase: torch.Tensor, step_freq: float, duty_factor: float,
                           t_offsets: torch.Tensor) -> torch.Tensor:
    """``contact_sequence`` on the device, float32: phase (..., 4), t_offsets (H,) on
    the phase's device; returns (..., 4, H)."""
    ph = torch.remainder(phase[..., :, None] + step_freq * t_offsets, 1.0)
    return (ph < duty_factor).to(torch.float32)


class PeriodicGaitGenerator:
    """Stateful host gait timer mirroring the reference class API."""

    def __init__(self, gait: GaitParams, horizon: int):
        self.gait_params = gait
        self.previous_gait_type = gait.gait_type
        self.gait_type = gait.gait_type
        self.duty_factor = gait.duty_factor
        self.step_freq = gait.step_freq
        self.horizon = horizon
        self.start_and_stop_activated = False
        self.reset()

    def reset(self):
        self.phase_offset = np.asarray(GAIT_PHASE_OFFSETS[GaitType(self.gait_type)], np.float64)
        self._phase = self.phase_offset.copy()

    @property
    def phase_signal(self) -> np.ndarray:
        return self._phase.copy()

    def set_phase_signal(self, phase: np.ndarray):
        self._phase = np.asarray(phase, np.float64).copy()

    def run(self, dt: float, step_freq: float) -> np.ndarray:
        """Advance the timer one tick; returns the current stance mask."""
        self._phase = np.mod(self._phase + dt * step_freq, 1.0)
        return (self._phase < self.duty_factor).astype(np.float64)

    def compute_contact_sequence(self, t_offsets: np.ndarray) -> np.ndarray:
        """(4, H) sequence; does not advance the timer."""
        if self.gait_type == GaitType.FULL_STANCE:
            self.reset()
            return np.ones((4, len(t_offsets)))
        ph = np.mod(self._phase[:, None] + self.step_freq * np.asarray(t_offsets)[None, :], 1.0)
        return (ph < self.duty_factor).astype(np.float64)

    def set_full_stance(self):
        self.gait_type = GaitType.FULL_STANCE
        self.reset()

    def restore_previous_gait(self):
        self.gait_type = self.previous_gait_type
        self.reset()

    def update_start_and_stop(self, feet_pos, hip_pos, hip_offset: float, base_pos,
                              base_ori_euler_xyz, base_lin_vel, base_ang_vel, ref_base_lin_vel,
                              ref_base_ang_vel, current_contact):
        """Energy-saving start/stop (reference periodic_gait_generator.py:128-196):
        full stance when idle, level, all feet in stance and under the hips."""
        yaw = base_ori_euler_xyz[2]
        R = np.array([[np.cos(yaw), np.sin(yaw)], [-np.sin(yaw), np.cos(yaw)]])
        feet_h = (R @ (np.asarray(feet_pos.data)[:, :2] - base_pos[:2]).T).T
        feet_h[:, 1] += np.array([-hip_offset, hip_offset, -hip_offset, hip_offset])
        hips_h = (R @ (np.asarray(hip_pos.data)[:, :2] - base_pos[:2]).T).T
        dist = np.linalg.norm(feet_h - hips_h, axis=1)
        idle = (
            np.linalg.norm(ref_base_lin_vel) == 0.0
            and np.linalg.norm(ref_base_ang_vel) == 0.0
            and np.linalg.norm(base_lin_vel) < 0.1
            and np.linalg.norm(base_ang_vel) < 0.1
            and abs(base_ori_euler_xyz[0]) < 0.05
            and abs(base_ori_euler_xyz[1]) < 0.05
            and np.sum(current_contact) == 4
            and np.all(dist < 0.06)
        )
        if idle:
            self.set_full_stance()
        elif self.gait_type == GaitType.FULL_STANCE:
            self.restore_previous_gait()
