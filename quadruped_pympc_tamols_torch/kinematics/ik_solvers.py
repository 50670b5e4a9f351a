"""Iterative IK solvers (host numpy): damped least squares and box-constrained QP.

Counterpart of ``quadruped_pympc_tamols_tpu/kinematics/ik_solvers.py``, selected
by ``sim.ik_solver`` (the analytic ``LegKinematics`` is the default):

* :class:`NumericIK` — damped-LS Gauss-Newton on the analytic FK, 5 iterations,
  warm-started from the last solution; float32 targets and results, as in the
  JAX package.
  It is a 4 x 3 problem: on the card it would be a chain of launches around
  ~1k flops, so it stays on the host.
* :class:`QPIK` — the box-constrained QP steps need the gradient family's
  interior-point solver (``controllers/gradient/qp.py``), which is not ported
  yet; it raises.
"""
from __future__ import annotations

import numpy as np

from ..config import RobotParams
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
    ``kinematics/ik_solvers.py:90-156``). Each step is a 3-variable QP solved by
    the gradient family's interior-point kernel, which the port does not have yet
    (ROADMAP queue 1 item 4, the gradient family)."""

    def __init__(self, robot: RobotParams, *args, **kwargs):
        raise NotImplementedError(
            "sim.ik_solver='qp' needs the gradient family's interior-point QP solver "
            "(controllers/gradient/qp.py, ROADMAP queue 1 item 4), which is not ported yet")
