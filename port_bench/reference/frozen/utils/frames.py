"""Frame/rotation utilities shared by every layer.

Torch functions broadcast over leading batch dims; the ``*_np`` twins serve the
per-tick host layers, which stay in numpy. Conventions follow the reference:
euler angles are intrinsic xyz (roll, pitch, yaw); the "horizontal frame" is the
world frame yawed to the base heading (reference foothold_reference_generator.py:87-90).
Counterpart of ``quadruped_pympc_tamols_tpu/utils/frames.py``.
"""
from __future__ import annotations

import numpy as np
import torch


def yaw_rot2(yaw):
    """(.., 2, 2) world->horizontal rotation R_W2H (reference frg:88-90)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)


def yaw_rot3(yaw):
    """(.., 3, 3) world->horizontal rotation about z."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack([
        torch.stack([c, s, z], -1),
        torch.stack([-s, c, z], -1),
        torch.stack([z, z, o], -1),
    ], -2)


def euler_xyz_to_rot(rpy):
    """Body->world rotation matrix from intrinsic xyz euler angles, R = Rz Ry Rx
    (scipy ``Rotation.from_euler('xyz', rpy).as_matrix()``)."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1),
    ], -2)


def world_to_body_rot(rpy):
    """World->body rotation b_R_w, as used inside the SRB torque dynamics
    (reference centroidal_model_jax.py:141-155)."""
    return torch.swapaxes(euler_xyz_to_rot(rpy), -1, -2)


def skew(v):
    """(.., 3) -> (.., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([
        torch.stack([o, -z, y], -1),
        torch.stack([z, o, -x], -1),
        torch.stack([-y, x, o], -1),
    ], -2)


def conj_euler_rates_inv(roll, pitch):
    """Inverse of the euler-rate conjugation matrix E (omega = E @ rpy_dot):
    Einv = [[1, sin(r)tan(p), cos(r)tan(p)], [0, cos(r), -sin(r)],
            [0, sin(r)/cos(p), cos(r)/cos(p)]]."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp = torch.cos(pitch)
    tp = torch.tan(pitch)
    o = torch.ones_like(roll)
    z = torch.zeros_like(roll)
    return torch.stack([
        torch.stack([o, sr * tp, cr * tp], -1),
        torch.stack([z, cr, -sr], -1),
        torch.stack([z, sr / cp, cr / cp], -1),
    ], -2)


def inv3(A):
    """Closed-form batched 3x3 inverse (cofactors over the determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    cof = torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A21, A22, A23], -1),
        torch.stack([A31, A32, A33], -1),
    ], -2)
    return cof / det[..., None, None]


# -- numpy twins for per-tick host code -----------------------------------------

def euler_xyz_to_rot_np(rpy):
    """numpy twin of euler_xyz_to_rot for one (3,) rpy."""
    roll, pitch, yaw = float(rpy[0]), float(rpy[1]), float(rpy[2])
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def yaw_rot3_np(yaw):
    """numpy twin of yaw_rot3 (world->horizontal)."""
    c, s = np.cos(float(yaw)), np.sin(float(yaw))
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
