"""Analytic 3-DoF quadruped leg kinematics (host numpy; the FK, the IK and the
world-frame IK also in torch).

Counterpart of ``quadruped_pympc_tamols_tpu/kinematics/leg_ik.py``. Leg model
(hip frame, x forward, y left, z up; legs identical up to the side sign of the
abduction offset d):
    x = -l3 sin(q2) - l4 sin(q2 + q3)
    y = d cos(q1) + E sin(q1)
    z = d sin(q1) - E cos(q1),    E = l3 cos(q2) + l4 cos(q2 + q3).
Per-tick IK is ~100 scalar flops per leg, so the control loop keeps it on the
host; ``gait.swing.make_swing_ik_step`` runs the torch path on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import RobotParams
from ..utils.device import device_constant
from ..utils.float32 import F32, atan2f, cosf, fmaf, sinf
from ..utils.frames import euler_xyz_to_rot_np

# Abduction offset side signs (FL, FR, RL, RR): left +, right -.
SIDE_SIGN = np.array([1.0, -1.0, 1.0, -1.0], dtype=np.float32)


class LegKinematics:
    """Per-leg FK/IK/Jacobian; single-leg methods broadcast over leading dims."""

    def __init__(self, robot: RobotParams):
        self.d_abd = robot.hip_offset_y
        self.l3 = robot.thigh_length
        self.l4 = robot.calf_length
        # IK solutions are clamped into the joint limits, so an out-of-reach target
        # saturates at the stops instead of at the kinematic singularity.
        self.q_lo = np.array([lim[0] for lim in robot.joint_limits], np.float32)
        self.q_hi = np.array([lim[1] for lim in robot.joint_limits], np.float32)
        # Hip joint positions in the base frame (4, 3).
        self.hip_offsets_b = np.array([
            [robot.hip_x, robot.hip_y, 0.0],
            [robot.hip_x, -robot.hip_y, 0.0],
            [-robot.hip_x, robot.hip_y, 0.0],
            [-robot.hip_x, -robot.hip_y, 0.0],
        ], dtype=np.float32)

    def fk(self, q, side_sign):
        """q (..., 3) joint angles -> foot position in the hip frame (..., 3).

        A torch tensor ``q`` (with ``side_sign`` a tensor on its device) takes the
        differentiable torch path, in q's dtype, that the kinodynamic OCP runs
        under ``torch.func``; anything else runs in float64 numpy."""
        if isinstance(q, torch.Tensor):
            d = self.d_abd * side_sign
            q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
            s1, c1 = torch.sin(q1), torch.cos(q1)
            E = self.l3 * torch.cos(q2) + self.l4 * torch.cos(q2 + q3)
            x = -self.l3 * torch.sin(q2) - self.l4 * torch.sin(q2 + q3)
            return torch.stack([x, d * c1 + E * s1, d * s1 - E * c1], dim=-1)
        q = np.asarray(q, np.float64)
        d = self.d_abd * np.asarray(side_sign, np.float64)
        q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
        E = self.l3 * np.cos(q2) + self.l4 * np.cos(q2 + q3)
        x = -self.l3 * np.sin(q2) - self.l4 * np.sin(q2 + q3)
        y = d * np.cos(q1) + E * np.sin(q1)
        z = d * np.sin(q1) - E * np.cos(q1)
        return np.stack([x, y, z], axis=-1)

    def ik(self, p, side_sign):
        """Foot position in the hip frame (..., 3) -> joint angles (..., 3), closed
        form, with the target clamped to the reachable annulus. A torch tensor
        ``p`` (``side_sign`` a tensor on its device) takes the torch path in p's
        dtype, in the JAX package's order of operations; anything else runs in
        float64 numpy."""
        if isinstance(p, torch.Tensor):
            return self._ik_torch(p, side_sign)
        p = np.asarray(p, np.float64)
        d = self.d_abd * np.asarray(side_sign, np.float64)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        l3, l4 = self.l3, self.l4
        E2 = np.maximum(y * y + z * z - d * d, 1e-9)
        E = np.sqrt(E2)
        q1 = np.arctan2(z, y) + np.arctan2(E, d * np.ones_like(E))
        q1 = np.arctan2(np.sin(q1), np.cos(q1))  # wrap to (-pi, pi]
        r2 = np.clip(x * x + E2, (l3 - l4) ** 2 + 1e-9, (l3 + l4) ** 2 - 1e-9)
        cos_knee = (r2 - l3 * l3 - l4 * l4) / (2 * l3 * l4)
        q3 = -np.arccos(np.clip(cos_knee, -1.0, 1.0))  # knee bends backward
        q2 = np.arctan2(-x, E) + np.arctan2(l4 * np.sin(-q3), l3 + l4 * np.cos(-q3))
        return np.clip(np.stack([q1, q2, q3], axis=-1), self.q_lo, self.q_hi)

    def _ik_torch(self, p, side_sign):
        d = self.d_abd * side_sign
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        l3, l4 = self.l3, self.l4
        E2 = torch.clamp(y * y + z * z - d * d, min=1e-9)
        E = torch.sqrt(E2)
        q1 = torch.atan2(z, y) + torch.atan2(E, d * torch.ones_like(E))
        q1 = torch.atan2(torch.sin(q1), torch.cos(q1))  # wrap to (-pi, pi]
        r2 = torch.clamp(x * x + E2, (l3 - l4) ** 2 + 1e-9, (l3 + l4) ** 2 - 1e-9)
        cos_knee = (r2 - l3 * l3 - l4 * l4) / (2 * l3 * l4)
        q3 = -torch.arccos(torch.clamp(cos_knee, -1.0, 1.0))  # knee bends backward
        q2 = (torch.atan2(-x, E)
              + torch.atan2(l4 * torch.sin(-q3), l3 + l4 * torch.cos(-q3)))
        q = torch.stack([q1, q2, q3], dim=-1)
        return torch.minimum(torch.maximum(q, device_constant(self.q_lo, p.device)),
                             device_constant(self.q_hi, p.device))

    def ik_all_f32(self, p_legs):
        """(4, 3) hip-frame targets -> (4, 3) float32 joints with the bits of the
        JAX package's jitted float32 ``ik_all`` on the CPU: the same formula as
        ``ik`` in XLA's evaluation order, with libm's float32 functions, its
        contracted multiply-adds, its folded constants and the divisor's
        reciprocal (``utils/float32.py``). It seeds the crouch pose and the
        numeric IK, whose later ticks depend on these bits."""
        p = np.asarray(p_legs, F32)
        d = F32(self.d_abd) * SIDE_SIGN
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        l3, l4 = self.l3, self.l4
        one = F32(1.0)
        # XLA's code contracts y*y + z*z - d*d one way where q1 reads it and
        # another where q2 and the knee read it.
        E_q1 = np.sqrt(np.maximum(fmaf(-d, d, fmaf(z, z, y * y)), F32(1e-9)))
        q1 = atan2f(z, y) + atan2f(E_q1, d)
        q1 = atan2f(sinf(q1), cosf(q1))
        E2 = np.maximum(fmaf(-d, d, fmaf(y, y, z * z)), F32(1e-9))
        r2 = np.clip(fmaf(x, x, E2), F32((l3 - l4) ** 2 + 1e-9), F32((l3 + l4) ** 2 - 1e-9))
        cos_knee = np.clip((r2 + -(F32(l3 * l3) + F32(l4 * l4))) * (one / F32(2 * l3 * l4)),
                           -one, one)
        knee = atan2f(np.sqrt((one - cos_knee) * (one + cos_knee)), cos_knee)  # acos
        q2 = atan2f(-x, np.sqrt(E2)) + atan2f(sinf(knee) * F32(l4),
                                             fmaf(cosf(knee), F32(l4), F32(l3)))
        return np.clip(np.stack([q1, q2, -knee], axis=-1), self.q_lo, self.q_hi)

    def jacobian(self, q, side_sign):
        """(..., 3) joints -> (..., 3, 3) hip-frame foot Jacobian d p / d q."""
        q = np.asarray(q, np.float64)
        d = self.d_abd * np.asarray(side_sign, np.float64)
        q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
        s1, c1 = np.sin(q1), np.cos(q1)
        s23 = np.sin(q2 + q3)
        E = self.l3 * np.cos(q2) + self.l4 * np.cos(q2 + q3)
        x = -self.l3 * np.sin(q2) - self.l4 * s23  # = dE/dq2
        dE3 = -self.l4 * s23
        zero = np.zeros_like(q1)
        return np.stack([
            np.stack([zero, -E, -self.l4 * np.cos(q2 + q3)], -1),
            np.stack([-d * s1 + E * c1, s1 * x, s1 * dE3], -1),
            np.stack([d * c1 + E * s1, -c1 * x, -c1 * dE3], -1),
        ], -2)

    def fk_all(self, q_legs):
        """(4, 3) joints -> (4, 3) hip-frame foot positions."""
        return self.fk(q_legs, SIDE_SIGN)

    def ik_all(self, p_legs):
        return self.ik(p_legs, SIDE_SIGN)

    def jacobians(self, q_legs):
        """(4, 3) joints -> (4, 3, 3) hip-frame foot Jacobians."""
        return self.jacobian(q_legs, SIDE_SIGN)

    def hips_world(self, base_pos, R_b2w):
        """(3,), (3, 3) -> (4, 3) hip positions in the world frame (torch for torch
        tensors)."""
        if isinstance(R_b2w, torch.Tensor):
            return base_pos + device_constant(self.hip_offsets_b, R_b2w.device) @ R_b2w.T
        return np.asarray(base_pos) + self.hip_offsets_b @ np.asarray(R_b2w).T

    def ik_world(self, feet_world, base_pos, R_b2w):
        """World-frame foot targets (4, 3) -> joint angles (4, 3) for a rigid base pose
        (torch for torch tensors)."""
        if isinstance(R_b2w, torch.Tensor):
            p_hip = torch.einsum("ij,lj->li", R_b2w.T, feet_world - self.hips_world(base_pos,
                                                                                      R_b2w))
            return self.ik(p_hip, device_constant(SIDE_SIGN, R_b2w.device))
        p_hip = (np.asarray(feet_world) - self.hips_world(base_pos, R_b2w)) @ np.asarray(R_b2w)
        return self.ik_all(p_hip)

    def compute_solution(self, base_pos, base_rpy, des_foot_FL, des_foot_FR, des_foot_RL,
                         des_foot_RR):
        """Reference-compatible entry: the 12-vector of joint targets."""
        feet = np.stack([np.asarray(f).reshape(3) for f in
                         (des_foot_FL, des_foot_FR, des_foot_RL, des_foot_RR)])
        return self.ik_world(feet, np.asarray(base_pos),
                             euler_xyz_to_rot_np(np.asarray(base_rpy))).reshape(12)
