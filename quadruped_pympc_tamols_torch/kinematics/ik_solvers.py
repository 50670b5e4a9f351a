"""Iterative IK solvers (host numpy): damped least squares and box-constrained QP.

Counterpart of ``quadruped_pympc_tamols_tpu/kinematics/ik_solvers.py``, selected
by ``sim.ik_solver`` (the analytic ``LegKinematics`` is the default):

* :class:`NumericIK` — damped-LS Gauss-Newton on the analytic FK, 5 iterations,
  warm-started from the last solution; float32 targets and results, as in the
  JAX package.
  It is a 4 x 3 problem: on the card it would be a chain of launches around
  ~1k flops, so it stays on the host.
* :class:`QPIK` — Gauss-Newton steps as box-constrained QPs (hard joint
  limits), the four legs' 3-variable QPs as one batch of the gradient family's
  interior-point solver (``controllers/gradient/qp.py:pdip_solve``) in float32
  torch on the host, as small as NumericIK's problem.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import RobotParams
from ..controllers.gradient.qp import pdip_solve
from ..utils.float32 import F32, cosf, sinf
from .leg_ik import SIDE_SIGN, LegKinematics


def _euler_xyz_to_rot_f32(rpy):
    """Body->world rotation from intrinsic xyz euler angles, float32."""
    cr, sr = cosf(rpy[0]), sinf(rpy[0])
    cp, sp = cosf(rpy[1]), sinf(rpy[1])
    cy, sy = cosf(rpy[2]), sinf(rpy[2])
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ], F32).reshape(3, 3)


class NumericIK:
    """Damped least-squares IK over all 4 legs (12 DoF) on the host.

    Counterpart of the JAX package's NumericIK (reference
    inverse_kinematics_numeric_mujoco.py:57-122): fixed iteration count, damping
    ``lam`` on the 3 x 3 normal equations, iterates from the last solution (a
    nominal crouch the first time).
    """

    def __init__(self, robot: RobotParams, iterations: int = 5, damping: float = 1e-3):
        self.legs = LegKinematics(robot)
        self.iterations = iterations
        self.damping = damping
        # Nominal posture seed: feet directly under the hips at hip_height.
        seed_p = np.tile(np.asarray([0.0, 0.0, -robot.hip_height], F32), (4, 1))
        seed_p[:, 1] += SIDE_SIGN * F32(robot.hip_offset_y)
        self.q_seed = self.legs.ik_all_f32(seed_p)
        self._q_last = self.q_seed

    def solve_hip_frame(self, p_hip, q0=None):
        """p_hip (4, 3) hip-frame targets, q0 (4, 3) initial guess -> (4, 3) float32.

        The JAX package iterates in float32; the iterations here run in float64
        on its float32 targets and round the result, which lands within its own
        float32 rounding of the exact iterate (a few 1e-7 rad)."""
        p_hip = np.asarray(p_hip, F32).astype(np.float64)
        q = np.asarray(self.q_seed if q0 is None else q0, np.float64).reshape(4, 3)
        lam = self.damping * np.eye(3)
        for _ in range(self.iterations):
            e = p_hip - self.legs.fk_all(q)
            J = self.legs.jacobians(q)
            JtJ = np.einsum("lji,ljk->lik", J, J) + lam
            rhs = np.einsum("lji,lj->li", J, e)
            q = q + np.linalg.solve(JtJ, rhs[..., None])[..., 0]
        return q.astype(F32)

    def compute_solution(self, base_pos, base_rpy, des_foot_FL, des_foot_FR,
                         des_foot_RL, des_foot_RR):
        """Reference-compatible entry: world-frame targets -> 12 joint angles."""
        R = _euler_xyz_to_rot_f32(np.asarray(base_rpy, F32))
        feet = np.stack([np.asarray(f, F32).reshape(3)
                         for f in (des_foot_FL, des_foot_FR, des_foot_RL, des_foot_RR)])
        hips = np.asarray(base_pos, F32) + self.legs.hip_offsets_b @ R.T
        p_hip = np.einsum("ij,lj->li", R.T, feet - hips)
        q = self.solve_hip_frame(p_hip, q0=self._q_last)
        self._q_last = q
        return q.reshape(12)


class QPIK:
    """Sequential-QP IK with hard joint-limit box constraints (JAX package
    ``kinematics/ik_solvers.py:90-156``, reference inverse_kinematics_qp.py:79-116):
    each Gauss-Newton step solves ``min ||J dq - e||^2 + reg ||dq||^2 s.t. lb <= q +
    dq <= ub`` per leg, the four legs as a batch of ``pdip_solve``, float32 QPs
    around the float64 kinematics."""

    def __init__(self, robot: RobotParams, iterations: int = 5, reg: float = 1e-4,
                 qp_iters: int = 14):
        self.legs = LegKinematics(robot)
        self.iterations = iterations
        self.reg = reg
        self.qp_iters = qp_iters
        self.lb = np.array([lo for lo, _ in robot.joint_limits], F32)
        self.ub = np.array([hi for _, hi in robot.joint_limits], F32)
        seed_p = np.tile(np.asarray([0.0, 0.0, -robot.hip_height], F32), (4, 1))
        seed_p[:, 1] += SIDE_SIGN * F32(robot.hip_offset_y)
        self.q_seed = np.clip(self.legs.ik_all_f32(seed_p), self.lb, self.ub)
        self._q_last = self.q_seed
        eye = torch.eye(3)
        self._C = torch.cat([eye, -eye]).expand(4, 6, 3)  # dq <= ub - q; -dq <= q - lb

    def solve_hip_frame(self, p_hip, q0=None):
        """p_hip (4, 3) hip-frame targets, q0 (4, 3) initial guess -> (4, 3) float32."""
        p_hip = np.asarray(p_hip, F32).astype(np.float64)
        q = np.asarray(self.q_seed if q0 is None else q0, F32).reshape(4, 3)
        for _ in range(self.iterations):
            e = torch.from_numpy((p_hip - self.legs.fk_all(q)).astype(F32))
            J = torch.from_numpy(self.legs.jacobians(q).astype(F32))
            Jt = J.transpose(-1, -2)
            Hm = Jt @ J + self.reg * torch.eye(3)
            g = -(Jt @ e[..., None])[..., 0]
            d = torch.from_numpy(np.concatenate([self.ub - q, q - self.lb], axis=-1))
            dq = pdip_solve(Hm, g, self._C, d, iters=self.qp_iters).z.numpy()
            q = np.clip(q + dq, self.lb, self.ub)
        return q

    def compute_solution(self, base_pos, base_rpy, des_foot_FL, des_foot_FR,
                         des_foot_RL, des_foot_RR):
        """Reference-compatible entry: world-frame targets -> 12 joint angles."""
        R = _euler_xyz_to_rot_f32(np.asarray(base_rpy, F32))
        feet = np.stack([np.asarray(f, F32).reshape(3)
                         for f in (des_foot_FL, des_foot_FR, des_foot_RL, des_foot_RR)])
        hips = np.asarray(base_pos, F32) + self.legs.hip_offsets_b @ R.T
        p_hip = np.einsum("ij,lj->li", R.T, feet - hips)
        q = self.solve_hip_frame(p_hip, q0=self._q_last)
        self._q_last = q
        return q.reshape(12)
