"""Single-rigid-body (centroidal) dynamics in torch.

Counterpart of ``quadruped_pympc_tamols_tpu/dynamics/srbd.py``; the same
Newton-Euler equations as the reference (centroidal_model_jax.py:93-174):

    com_acc   = (1/m) * sum_i c_i * f_i + g
    rpy_dot   = Einv(roll, pitch) @ omega
    omega_dot = I^-1 ( R_w2b @ sum_i c_i * (p_i - com) x f_i  -  omega x (I omega) )

State layout (12,): [com_pos(3), com_vel(3), rpy(3), omega_body(3)]. Feet (4, 3)
and ground-reaction forces (4, 3) are inputs; contact (4,) masks stance legs. All
functions broadcast over leading batch dimensions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..utils.frames import conj_euler_rates_inv, world_to_body_rot


@dataclasses.dataclass
class SRBDParams:
    """Dynamic parameters as 0-d / (3, 3) tensors on one device."""

    mass: torch.Tensor
    inertia: torch.Tensor
    inertia_inv: torch.Tensor
    gravity: torch.Tensor  # positive magnitude


def make_params(cfg: Config, dtype=torch.float32, device="cpu") -> SRBDParams:
    inertia = np.asarray(cfg.robot.inertia_matrix())

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), dtype=dtype, device=device)

    return SRBDParams(mass=t(cfg.robot.mass), inertia=t(inertia),
                      inertia_inv=t(np.linalg.inv(inertia)), gravity=t(cfg.gravity))


def fd(state, feet, forces, contact, params: SRBDParams):
    """State derivative (..., 12) of the SRB model.

    state (..., 12); feet and forces (..., 4, 3) in the world frame; contact (..., 4)
    stance mask (1 = stance)."""
    com = state[..., 0:3]
    vel = state[..., 3:6]
    rpy = state[..., 6:9]
    omega = state[..., 9:12]

    f_eff = forces * contact[..., :, None]
    zero = torch.zeros_like(params.gravity)
    g_vec = torch.stack([zero, zero, -params.gravity], -1)
    com_acc = torch.sum(f_eff, dim=-2) / params.mass[..., None] + g_vec

    lever = feet - com[..., None, :]
    torque_w = torch.sum(torch.linalg.cross(lever, f_eff, dim=-1), dim=-2)

    rpy_dot = torch.einsum("...ij,...j->...i",
                           conj_euler_rates_inv(rpy[..., 0], rpy[..., 1]), omega)
    torque_b = torch.einsum("...ij,...j->...i", world_to_body_rot(rpy), torque_w)
    I_omega = torch.einsum("...ij,...j->...i", params.inertia, omega)
    gyro = torch.linalg.cross(omega, I_omega, dim=-1)
    omega_dot = torch.einsum("...ij,...j->...i", params.inertia_inv, torque_b - gyro)
    return torch.cat([vel, com_acc, rpy_dot, omega_dot], dim=-1)


def integrate_euler(state, feet, forces, contact, params: SRBDParams, dt):
    """Explicit Euler step (reference centroidal_model_jax.py:164-174); ``dt`` may
    be a scalar or batched, and the feet stay fixed across the step."""
    dt = torch.as_tensor(dt, dtype=state.dtype, device=state.device)
    return state + fd(state, feet, forces, contact, params) * dt[..., None]


def integrate_rk4(state, feet, forces, contact, params: SRBDParams, dt):
    """Classic RK4 with zero-order-hold inputs."""
    dt = torch.as_tensor(dt, dtype=state.dtype, device=state.device)[..., None]
    k1 = fd(state, feet, forces, contact, params)
    k2 = fd(state + 0.5 * dt * k1, feet, forces, contact, params)
    k3 = fd(state + 0.5 * dt * k2, feet, forces, contact, params)
    k4 = fd(state + dt * k3, feet, forces, contact, params)
    return state + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
