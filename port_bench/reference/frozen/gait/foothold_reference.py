"""Raibert-style reference foothold generation (host numpy).

Counterpart of ``quadruped_pympc_tamols_tpu/gait/foothold_reference.py``
(reference helpers/foothold_reference_generator.py:53-199): footholds sit under
the hips in the yaw-aligned horizontal frame, pushed forward by half a stance time
of desired velocity (clipped to 1.5*hip_height) plus a capture-point correction
sqrt(h/g)*(v_avg - v_ref) clipped to +-5 cm, then rotated back to the world frame.
The z comes from the per-leg lift-off height. ``raibert_footholds_torch`` is the
float32 device twin that the scenario fleet calls.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..config import GRAVITY, GaitType
from ..utils.device import device_constant
from ..utils.frames import euler_xyz_to_rot_np, yaw_rot2, yaw_rot3_np
from ..utils.legs import Legs

# Stance-width y offset signs per leg (FL, FR, RL, RR): left legs widen +, right legs -.
_Y_OFFSET_SIGN = np.array([1.0, -1.0, 1.0, -1.0], dtype=np.float32)


def _yaw_rot2(yaw):
    """(..., 2, 2) world->horizontal rotation."""
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)


def raibert_footholds(base_pos, base_rpy, base_vel_mavg_xy_h, ref_base_vel_xy, hips_pos,
                      liftoff_z, stance_time, hip_height, com_height_nominal,
                      hip_offset: float = 0.1, com_pos_offset_b=None,
                      gravity: float = GRAVITY):
    """Reference footholds (..., 4, 3) in the world frame.

    base_pos/base_rpy (..., 3); base_vel_mavg_xy_h (..., 2) moving-average base
    velocity in the horizontal frame; ref_base_vel_xy (..., 2) desired world
    velocity; hips_pos (..., 4, 3); liftoff_z (..., 4)."""
    base_pos = np.asarray(base_pos)
    base_rpy = np.asarray(base_rpy)
    R2 = _yaw_rot2(base_rpy[..., 2])
    ref_vel_h = np.einsum("...ij,...j->...i", R2, ref_base_vel_xy)
    delta_ref_h = np.clip(0.5 * stance_time * ref_vel_h, -1.5 * hip_height, 1.5 * hip_height)
    err_comp = np.clip(np.sqrt(com_height_nominal / gravity)
                       * (np.asarray(base_vel_mavg_xy_h) - ref_vel_h), -0.05, 0.05)
    hips_h = np.einsum("...ij,...kj->...ki", R2,
                       np.asarray(hips_pos)[..., :2] - base_pos[..., None, :2])
    feet_h = hips_h.copy()
    feet_h[..., 1] += hip_offset * _Y_OFFSET_SIGN
    feet_h = feet_h + delta_ref_h[..., None, :] + err_comp[..., None, :]
    feet_w_xy = np.einsum("...ji,...kj->...ki", R2, feet_h) + base_pos[..., None, :2]
    if com_pos_offset_b is not None:
        off_w = np.stack([euler_xyz_to_rot_np(r) for r in base_rpy.reshape(-1, 3)]).reshape(
            base_rpy.shape[:-1] + (3, 3)) @ np.asarray(com_pos_offset_b)[..., None]
        feet_w_xy = feet_w_xy + off_w[..., None, :2, 0]
    return np.concatenate([feet_w_xy, np.asarray(liftoff_z)[..., :, None]], axis=-1)


def raibert_footholds_torch(base_pos, base_rpy, base_vel_mavg_xy_h, ref_base_vel_xy, hips_pos,
                            liftoff_z, stance_time: float, hip_height: float,
                            com_height_nominal: float, hip_offset: float = 0.1,
                            gravity: float = GRAVITY) -> torch.Tensor:
    """``raibert_footholds`` on the device in float32 (no CoM offset), in the JAX
    package's order of operations: tensors with the same leading shape,
    (..., 4, 3) footholds."""
    R2 = yaw_rot2(base_rpy[..., 2])
    ref_vel_h = torch.einsum("...ij,...j->...i", R2, ref_base_vel_xy)
    delta_ref_h = torch.clamp(0.5 * stance_time * ref_vel_h, -1.5 * hip_height, 1.5 * hip_height)
    err_comp = torch.clamp(float(np.sqrt(com_height_nominal / gravity))
                           * (base_vel_mavg_xy_h - ref_vel_h), -0.05, 0.05)
    hips_h = torch.einsum("...ij,...kj->...ki", R2, hips_pos[..., :2] - base_pos[..., None, :2])
    side = device_constant(hip_offset * _Y_OFFSET_SIGN, hips_h.device)
    feet_h = torch.stack([hips_h[..., 0], hips_h[..., 1] + side], dim=-1)
    feet_h = feet_h + delta_ref_h[..., None, :] + err_comp[..., None, :]
    feet_w_xy = torch.einsum("...ji,...kj->...ki", R2, feet_h) + base_pos[..., None, :2]
    return torch.cat([feet_w_xy, liftoff_z[..., :, None]], dim=-1)


class FootholdReferenceGenerator:
    """Tracks lift-off/touch-down positions across contact transitions and the
    base-velocity moving average, then places the Raibert footholds
    (reference foothold_reference_generator.py:14-199)."""

    def __init__(self, stance_time: float, lift_off_positions: Legs, hip_height: float,
                 vel_moving_average_length: int = 20):
        self.stance_time = stance_time
        self.hip_height = hip_height
        self.hip_offset = 0.1
        self.base_vel_hist = collections.deque(maxlen=vel_moving_average_length)
        init = np.asarray(lift_off_positions.data, np.float64)
        self.lift_off_positions = Legs(init.copy())
        self.touch_down_positions = Legs(init.copy())
        self.lift_off_positions_h = Legs(init.copy())
        self.touch_down_positions_h = Legs(init.copy())
        self.com_pos_offset_b = np.zeros(3)
        self.com_pos_offset_w = np.zeros(3)
        self.last_reference_footholds = Legs.zeros((3,))

    def compute_footholds_reference(self, base_position, base_ori_euler_xyz, base_xy_lin_vel,
                                    ref_base_xy_lin_vel, hips_position: Legs,
                                    com_height_nominal: float) -> Legs:
        yaw = base_ori_euler_xyz[2]
        R2 = np.array([[np.cos(yaw), np.sin(yaw)], [-np.sin(yaw), np.cos(yaw)]])
        self.base_vel_hist.append(R2 @ np.asarray(base_xy_lin_vel))
        vel_mavg_h = np.mean(self.base_vel_hist, axis=0)

        ref_vel_h = R2 @ np.asarray(ref_base_xy_lin_vel)
        delta_ref_h = np.clip(0.5 * self.stance_time * ref_vel_h,
                              -1.5 * self.hip_height, 1.5 * self.hip_height)
        err_comp = np.clip(np.sqrt(com_height_nominal / 9.81) * (vel_mavg_h - ref_vel_h),
                           -0.05, 0.05)
        hips = np.asarray(hips_position.data)
        hips_h = (hips[:, :2] - np.asarray(base_position)[None, :2]) @ R2.T
        feet_h = hips_h.copy()
        feet_h[:, 1] += self.hip_offset * _Y_OFFSET_SIGN
        feet_h += delta_ref_h[None, :] + err_comp[None, :]
        feet_w_xy = feet_h @ R2 + np.asarray(base_position)[None, :2]
        off_w = euler_xyz_to_rot_np(base_ori_euler_xyz) @ np.asarray(self.com_pos_offset_b)
        feet_w_xy = feet_w_xy + off_w[None, :2]
        liftoff_z = np.asarray(self.lift_off_positions.data)[:, 2]
        ref = Legs(np.concatenate([feet_w_xy, liftoff_z[:, None]], axis=1))
        self.com_pos_offset_w = off_w
        self.last_reference_footholds = Legs(ref.data.copy())
        return ref

    def update_lift_off_positions(self, previous_contact, current_contact, feet_pos: Legs,
                                  gait_type, base_position, base_ori_euler_xyz):
        """Freeze lift-off points at stance->swing edges; while in swing, keep the
        horizontal-frame point attached to the moving base (reference :159-178)."""
        R = yaw_rot3_np(base_ori_euler_xyz[2])
        lo = np.asarray(self.lift_off_positions.data)
        lo_h = np.asarray(self.lift_off_positions_h.data)
        feet = np.asarray(feet_pos.data)
        for leg in range(4):
            if gait_type == GaitType.FULL_STANCE:
                lo[leg] = feet[leg]
            elif previous_contact[leg] == 1 and current_contact[leg] == 0:
                lo[leg] = feet[leg]
                lo_h[leg] = R @ (lo[leg] - base_position)
            elif previous_contact[leg] == 0 and current_contact[leg] == 0:
                lo[leg] = R.T @ lo_h[leg] + base_position
        self.lift_off_positions = Legs(lo)
        self.lift_off_positions_h = Legs(lo_h)

    def update_touch_down_positions(self, previous_contact, current_contact, feet_pos: Legs,
                                    gait_type, base_position, base_ori_euler_xyz):
        """Symmetric tracking for touch-down points (reference :180-199)."""
        R = yaw_rot3_np(base_ori_euler_xyz[2])
        td = np.asarray(self.touch_down_positions.data)
        td_h = np.asarray(self.touch_down_positions_h.data)
        feet = np.asarray(feet_pos.data)
        for leg in range(4):
            if gait_type == GaitType.FULL_STANCE:
                td[leg] = feet[leg]
            elif previous_contact[leg] == 0 and current_contact[leg] == 1:
                td[leg] = feet[leg]
                td_h[leg] = R @ (td[leg] - base_position)
            elif previous_contact[leg] == 1 and current_contact[leg] == 1:
                td[leg] = R.T @ td_h[leg] + base_position
        self.touch_down_positions = Legs(td)
        self.touch_down_positions_h = Legs(td_h)
