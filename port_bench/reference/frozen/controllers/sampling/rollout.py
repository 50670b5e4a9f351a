"""Structure-of-arrays SRB rollout for sampling MPC, in plain torch.

Counterpart of ``quadruped_pympc_tamols_tpu/controllers/sampling/rollout.py``.
Every per-sample quantity is an (N,) row, the raw spline forces arrive step-major
as (H, 12, N), and the force model (gravity share, contact mask, friction clamp;
reference centroidal_nmpc_jax.py:376-409 and :270-314) is applied inside the
step loop. This is the plain version of the rollout that the CUDA sampling kernel
(``ops/csrc/sampling_rs.cu``) computes per thread, in the same order of
operations.

Clamps go through ``torch.clamp``, which, like ``jnp.clip``, propagates NaN: a
diverging rollout keeps its NaN and saturates to the 1e6 cost at the end.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...dynamics.srbd import SRBDParams
from ...utils.device import device_constant


@dataclasses.dataclass(frozen=True)
class ForceModelParams:
    """Static force-model constants (reference centroidal_nmpc_jax.py:39-41,159-164)."""

    scale_x: float  # max_force_x / max_force_z
    scale_y: float  # max_force_y / max_force_z
    grf_min: float
    grf_max: float
    mu: float


def apply_force_model_rows(raw12, contact4, share, fm: ForceModelParams):
    """Map one step's 12 raw force rows to physical GRFs.

    raw12: (12, ...) rows ordered [leg][axis]; contact4: (4,) stance mask; share:
    0-d gravity-share force, or (4,) per-leg shares (equilibrium_share).
    Returns a list of 12 physical force rows."""
    per_leg = share.ndim >= 1
    out = []
    for leg in range(4):
        cl = contact4[leg]
        sh = share[leg] if per_leg else share
        fx = raw12[leg * 3 + 0] * (cl * fm.scale_x)
        fy = raw12[leg * 3 + 1] * (cl * fm.scale_y)
        fz = torch.clamp((sh + raw12[leg * 3 + 2]) * cl, fm.grf_min, fm.grf_max)
        lim = fm.mu * fz
        fx = torch.clamp(fx, -lim, lim)
        fy = torch.clamp(fy, -lim, lim)
        out.extend([fx, fy, fz])
    return out


def gravity_share(contact_seq, mass: float, gravity: float = 9.81):
    """(..., H) uniform share m*g/n_stance per step (reference :377-385) of
    contact_seq (..., 4, H)."""
    n_stance = torch.sum(contact_seq, dim=-2)
    mg = torch.tensor(float(mass), dtype=contact_seq.dtype) * gravity  # f32 product
    return mg / torch.clamp(n_stance, min=1.0)


def equilibrium_share(feet, com_pos, contact_seq, mass, gravity, grf_max):
    """Static-equilibrium per-leg vertical force distribution, (..., H, 4).

    The least-norm f_z with sum(f_z) = m*g and zero CoM moment per stage,
        f = A^T (A A^T + eps I)^(-1) b,   A = [c; (p_x - com_x) c; (p_y - com_y) c],
    clipped to [0, grf_max] (see the JAX module for why the sampler wants it).
    feet (..., 4, 3), com_pos (..., 3), contact_seq (..., 4, H). No host copy and
    no error check that reads the device: the fleet runs this in a CUDA graph."""
    dtype = feet.dtype
    mg = np.float32(mass) * np.float32(gravity)  # f32 product
    b = device_constant([mg, 0.0, 0.0], feet.device, dtype)
    dx = feet[..., 0] - com_pos[..., None, 0]
    dy = feet[..., 1] - com_pos[..., None, 1]
    c = contact_seq.transpose(-1, -2).to(dtype)  # (..., H, 4)
    A = torch.stack([c, dx[..., None, :] * c, dy[..., None, :] * c], dim=-2)  # (..., H, 3, 4)
    M = A @ A.transpose(-1, -2) + 1e-3 * torch.eye(3, dtype=dtype, device=feet.device)
    y = torch.linalg.solve_ex(M, b.expand(*A.shape[:-2], 3))[0]  # (..., H, 3)
    f = torch.einsum("...hij,...hi->...hj", A, y)
    return torch.clamp(f, 0.0, float(grf_max))


def rollout_costs_soa(state12, feet, ref12, raw_steps, contact_seq, share, dts, q_diag,
                      params: SRBDParams, fm: ForceModelParams,
                      saturate: float = 1.0e6, zmp_weight: float = 0.0,
                      zmp_margin: float = 0.04):
    """Integrate all samples through the horizon and return their costs.

    Args:
        state12: (12,) initial base state (shared by all samples).
        feet: (4, 3) foot positions (fixed within the rollout).
        ref12: (12,) reference state.
        raw_steps: (H, 12, N) raw spline outputs, step-major.
        contact_seq: (4, H) stance masks.
        share: (H,) gravity share per step, or (H, 4) per-leg shares.
        dts: (H,) host array of per-stage steps.
        q_diag: (12,) host array of diagonal state-cost weights; zero weights are
            skipped.
        params, fm: SRB and force-model constants.

    A leading batch shape B (the scenario fleet's scenarios) may come before the
    shapes above in every per-tick input (state12, feet, ref12, raw_steps,
    contact_seq, share); each batch entry then rolls out its own problem.

    Returns:
        (*B, N) costs with NaN/Inf saturated to ``saturate``
        (reference centroidal_nmpc_jax.py:686-687).
    """
    batch = tuple(state12.shape[:-1])
    nb = len(batch)
    H, N = raw_steps.shape[-3], raw_steps.shape[-1]
    dtype, device = raw_steps.dtype, raw_steps.device
    m = params.mass
    g = params.gravity
    I = params.inertia
    Iinv = params.inertia_inv

    def lead(x, k):
        """x (*B, c_1..c_k) -> (c_1..c_k, *B, 1): component axes first, then the
        batch, then an axis that broadcasts against the samples."""
        return x.movedim(tuple(range(nb)), tuple(range(k, k + nb)))[..., None]

    feet = lead(feet, 2)  # (4, 3, *B, 1)
    ref12 = lead(ref12, 1)
    contact_t = lead(contact_seq.transpose(-1, -2), 2)  # (H, 4, *B, 1)
    if share.dim() == nb + 1:  # one share a step: the same for every leg
        share = share[..., None].expand(*share.shape, 4)
    share = lead(share, 2)  # (H, 4, *B, 1)
    raw_steps = raw_steps.movedim(tuple(range(nb)), tuple(range(2, 2 + nb)))  # (H, 12, *B, N)
    state = lead(state12, 1)
    rows = tuple(state[i].expand(*batch, N) for i in range(12))
    cost = torch.zeros(*batch, N, dtype=dtype, device=device)
    q_host = np.asarray(q_diag, np.float32)

    for n in range(H):
        px, py, pz, vx, vy, vz, rr, pp, yy, wx, wy, wz = rows
        dt = float(np.float32(dts[n]))
        c = contact_t[n]
        f = apply_force_model_rows(raw_steps[n], c, share[n], fm)

        Fx = Fy = Fz = 0.0
        Tx = Ty = Tz = 0.0
        for leg in range(4):
            fx, fy, fz = f[leg * 3 + 0], f[leg * 3 + 1], f[leg * 3 + 2]
            Fx, Fy, Fz = Fx + fx, Fy + fy, Fz + fz
            rx = feet[leg, 0] - px
            ry = feet[leg, 1] - py
            rz = feet[leg, 2] - pz
            Tx = Tx + (ry * fz - rz * fy)
            Ty = Ty + (rz * fx - rx * fz)
            Tz = Tz + (rx * fy - ry * fx)

        ax, ay, az = Fx / m, Fy / m, Fz / m - g

        sr, cr = torch.sin(rr), torch.cos(rr)
        sp, cp = torch.sin(pp), torch.cos(pp)
        sy, cy = torch.sin(yy), torch.cos(yy)
        tp = sp / cp

        # rpy_dot = Einv(roll, pitch) @ omega.
        r_dot = wx + sr * tp * wy + cr * tp * wz
        p_dot = cr * wy - sr * wz
        y_dot = (sr * wy + cr * wz) / cp

        # Body-frame torque: tau_b = R_w2b(ZYX) @ tau_w.
        tbx = cp * cy * Tx + cp * sy * Ty - sp * Tz
        tby = (sr * sp * cy - cr * sy) * Tx + (sr * sp * sy + cr * cy) * Ty + sr * cp * Tz
        tbz = (cr * sp * cy + sr * sy) * Tx + (cr * sp * sy - sr * cy) * Ty + cr * cp * Tz

        # Gyroscopic term omega x (I omega).
        Iwx = I[0, 0] * wx + I[0, 1] * wy + I[0, 2] * wz
        Iwy = I[1, 0] * wx + I[1, 1] * wy + I[1, 2] * wz
        Iwz = I[2, 0] * wx + I[2, 1] * wy + I[2, 2] * wz
        gx = wy * Iwz - wz * Iwy
        gy = wz * Iwx - wx * Iwz
        gz = wx * Iwy - wy * Iwx

        mx, my, mz = tbx - gx, tby - gy, tbz - gz
        wdx = Iinv[0, 0] * mx + Iinv[0, 1] * my + Iinv[0, 2] * mz
        wdy = Iinv[1, 0] * mx + Iinv[1, 1] * my + Iinv[1, 2] * mz
        wdz = Iinv[2, 0] * mx + Iinv[2, 1] * my + Iinv[2, 2] * mz

        px, py, pz = px + vx * dt, py + vy * dt, pz + vz * dt
        vx, vy, vz = vx + ax * dt, vy + ay * dt, vz + az * dt
        rr, pp, yy = rr + r_dot * dt, pp + p_dot * dt, yy + y_dot * dt
        wx, wy, wz = wx + wdx * dt, wy + wdy * dt, wz + wdz * dt

        rows = (px, py, pz, vx, vy, vz, rr, pp, yy, wx, wy, wz)
        for i in range(12):
            w_i = float(q_host[i])
            if w_i != 0.0:
                e = rows[i] - ref12[i]
                cost = cost + w_i * e * e
        if zmp_weight > 0.0:
            # ZMP-band cost (config sampling.zmp_weight): during 2-stance phases
            # the ZMP approximation p = com_xy - (com_z/g) a_xy pays
            # quadratically beyond zmp_margin of the stance support segment.
            zx = px - (pz / g) * ax
            zy = py - (pz / g) * ay
            pairs = ((0, 3, 1, 2), (1, 2, 0, 3), (0, 2, 1, 3),
                     (1, 3, 0, 2), (0, 1, 2, 3), (2, 3, 0, 1))
            pen = 0.0
            for i, j, k, l in pairs:
                mask = c[i] * c[j] * (1.0 - c[k]) * (1.0 - c[l])
                axp, ayp = feet[i, 0], feet[i, 1]
                vxp, vyp = feet[j, 0] - axp, feet[j, 1] - ayp
                denom = vxp * vxp + vyp * vyp + 1e-9
                t = torch.clamp(((zx - axp) * vxp + (zy - ayp) * vyp) / denom, 0.0, 1.0)
                dxp = zx - (axp + t * vxp)
                dyp = zy - (ayp + t * vyp)
                dist = torch.sqrt(dxp * dxp + dyp * dyp + 1e-12)
                pen = pen + mask * torch.square(torch.clamp(dist - zmp_margin, min=0.0))
            cost = cost + zmp_weight * pen

    bad = torch.isnan(cost) | torch.isinf(cost)
    return torch.where(bad, torch.full_like(cost, saturate), cost)
