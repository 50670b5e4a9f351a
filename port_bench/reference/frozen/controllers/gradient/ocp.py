"""Optimal-control-problem machinery for the gradient MPC family, in torch.

Counterpart of ``quadruped_pympc_tamols_tpu/controllers/gradient/ocp.py``. The
single-rigid-body OCP on the shared dynamics (``dynamics/srbd.py``): stage
Jacobians by ``torch.func.jacfwd`` of the discrete step under ``torch.func.vmap``
over the stages, and the multiple-shooting problem condensed into a dense QP
over the input sequence.

Every torch function takes leading batch dimensions (``...``): the solver runs
B = 1 for one solve and B = K for the gait candidates, where the JAX package
vmaps. Cost weights are the reference's LINEAR_LS values
(centroidal_nmpc_nominal.py:501-551).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ...dynamics.srbd import SRBDParams, fd
from ...utils.frames import world_to_body_rot


@dataclasses.dataclass(frozen=True)
class OCPDims:
    nx: int = 12
    nu: int = 12  # 4 legs x 3 GRF components
    horizon: int = 12

    @property
    def nU(self) -> int:
        return self.nu * self.horizon


def q_diag_gradient() -> np.ndarray:
    """(12,) base-state weights (reference centroidal_nmpc_nominal.py:504-508)."""
    return np.array([0, 0, 1500, 200, 200, 200, 500, 500, 0, 20, 20, 50], dtype=np.float32)


def r_diag_gradient(robot: str = "aliengo") -> np.ndarray:
    """(12,) GRF weights (reference :516-522; hyqreal uses 1e-5)."""
    v = 1e-5 if robot.startswith("hyqreal") else 1e-3
    return np.full(12, v, dtype=np.float32)


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def step_fn(x, u, feet, contact, params: SRBDParams, dt, integrator: str = "euler",
            ext_wrench=None):
    """Discrete dynamics x_{k+1} = F(x_k, u_k); u (..., 12) is the stacked GRF
    vector, feet (..., 4, 3), contact (..., 4), dt (...,). ``ext_wrench`` (..., 6)
    is the world-frame external [force, torque], entering the balance as the
    reference's wrench parameters do (centroidal_model_nominal.py)."""
    forces = u.reshape(u.shape[:-1] + (4, 3))

    def f(xx):
        d = fd(xx, feet, forces, contact, params)
        if ext_wrench is not None:
            acc = d[..., 3:6] + ext_wrench[..., :3] / params.mass[..., None]
            tau_b = _mv(world_to_body_rot(xx[..., 6:9]), ext_wrench[..., 3:])
            domega = d[..., 9:12] + _mv(params.inertia_inv, tau_b)
            d = torch.cat([d[..., 0:3], acc, d[..., 6:9], domega], dim=-1)
        return d

    dt = dt[..., None]
    if integrator == "rk4":
        k1 = f(x)
        k2 = f(x + 0.5 * dt * k1)
        k3 = f(x + 0.5 * dt * k2)
        k4 = f(x + dt * k3)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    return x + dt * f(x)


class Linearization(NamedTuple):
    A: torch.Tensor  # (..., H, nx, nx)
    B: torch.Tensor  # (..., H, nx, nu)
    xbar: torch.Tensor  # (..., H+1, nx) nominal rollout


def _stage_wrench(ext_wrench, U):
    """Per-stage (..., H, 6) wrench: zeros for None; a (6,) wrench holds on every
    stage. Callers pass (..., H, 6) to compensate only the first stages
    (reference centroidal_nmpc_input_rates.py:1360-1373)."""
    H = U.shape[-2]
    if ext_wrench is None:
        return U.new_zeros(U.shape[:-2] + (H, 6))
    if ext_wrench.dim() == 1:
        return ext_wrench.expand(U.shape[:-2] + (H, 6))
    return ext_wrench


def _stage_params(params: SRBDParams, batch, H):
    """The parameters of every stage, flattened to (prod(batch) * H, ...)."""
    mass = params.mass.expand(batch).unsqueeze(-1).expand(batch + (H,)).reshape(-1)
    I = params.inertia.expand(batch + (3, 3)).unsqueeze(-3).expand(batch + (H, 3, 3))
    Iinv = params.inertia_inv.expand(batch + (3, 3)).unsqueeze(-3).expand(batch + (H, 3, 3))
    return mass, I.reshape(-1, 3, 3), Iinv.reshape(-1, 3, 3)


def rollout_nominal(x0, U, feet_traj, contact_seq, params, dts, integrator="euler",
                    ext_wrench=None):
    """Forward-simulate the nominal trajectory under the inputs U (..., H, nu);
    returns (..., H+1, nx)."""
    w = _stage_wrench(ext_wrench, U)
    xs = [x0]
    for k in range(U.shape[-2]):
        xs.append(step_fn(xs[-1], U[..., k, :], feet_traj[..., k, :, :], contact_seq[..., :, k],
                          params, dts[k], integrator, w[..., k, :]))
    return torch.stack(xs, dim=-2)


def linearize_dynamics(xbar, U, feet_traj, contact_seq, params, dts, integrator="euler",
                       ext_wrench=None):
    """Stage Jacobians A_k = dF/dx, B_k = dF/du along the nominal trajectory, one
    forward-mode Jacobian per stage, vectorized over every stage of every batch."""
    batch, H = U.shape[:-2], U.shape[-2]
    w = _stage_wrench(ext_wrench, U)
    mass, inertia, inertia_inv = _stage_params(params, batch, H)
    gravity = params.gravity

    def jac(x, u, feet, c, dt, wk, m, I, Iinv):
        p = SRBDParams(mass=m, inertia=I, inertia_inv=Iinv, gravity=gravity)
        A = torch.func.jacfwd(lambda xx: step_fn(xx, u, feet, c, p, dt, integrator, wk))(x)
        B = torch.func.jacfwd(lambda uu: step_fn(x, uu, feet, c, p, dt, integrator, wk))(u)
        return A, B

    n = int(np.prod(batch, dtype=np.int64)) * H
    A, B = torch.func.vmap(jac)(
        xbar[..., :-1, :].reshape(n, -1), U.reshape(n, -1), feet_traj.reshape(n, 4, 3),
        contact_seq.transpose(-1, -2).reshape(n, 4), dts.expand(batch + (H,)).reshape(n),
        w.reshape(n, 6), mass, inertia, inertia_inv)
    nx, nu = A.shape[-1], B.shape[-1]
    return Linearization(A.reshape(batch + (H, nx, nx)), B.reshape(batch + (H, nx, nu)), xbar)


def condense(lin: Linearization, dims: OCPDims):
    """Prediction operators for the condensed QP (deviation variables).

    delta_x_{k+1} = A_k delta_x_k + B_k delta_u_k, delta_x_0 = x0 - xbar_0.
    Returns F (..., H, nx, nx) with delta_x_{k+1} = F[k] @ delta_x0 + sum_j G[k, j]
    delta_u_j, and G (..., H, H, nx, nu), lower block triangular.

    The block recursion of the JAX package (F[k] = A_k F[k-1], G[k, j] = A_k
    G[k-1, j] for j < k, G[k, k] = B_k): where nx = nu (the nominal and the
    foothold and kinodynamic variants) each stage's products, F and the k blocks
    of G alike, are one batched matmul; otherwise F and G take one each."""
    H = dims.horizon
    A, B = lin.A, lin.B
    zero = torch.zeros_like(B[..., 0, None, :, :])

    def padded(blocks, k):  # G[k, 0..k] then zeros to H blocks
        return torch.cat([blocks, zero.expand(zero.shape[:-3] + (H - 1 - k,)
                                              + zero.shape[-2:])], dim=-3)

    if A.shape[-1] != B.shape[-1]:
        F, row = [A[..., 0, :, :]], B[..., 0, None, :, :]
        G = [padded(row, 0)]
        for k in range(1, H):
            F.append(A[..., k, :, :] @ F[-1])
            row = torch.cat([A[..., k, None, :, :] @ row, B[..., k, None, :, :]], dim=-3)
            G.append(padded(row, k))
        return torch.stack(F, dim=-3), torch.stack(G, dim=-4)
    # row k: [F[k], G[k, 0], ..., G[k, k]]
    row = torch.stack([A[..., 0, :, :], B[..., 0, :, :]], dim=-3)
    F, G = [row[..., 0, :, :]], [padded(row[..., 1:, :, :], 0)]
    for k in range(1, H):
        prod = A[..., k, None, :, :] @ row
        row = torch.cat([prod, B[..., k, None, :, :]], dim=-3)
        F.append(row[..., 0, :, :])
        G.append(padded(row[..., 1:, :, :], k))
    return torch.stack(F, dim=-3), torch.stack(G, dim=-4)


def input_operator(Gm):
    """The dU-major transposed operator G^T (..., H nu, H nx) of G (..., H, H, nx, nu)."""
    H, nx, nu = Gm.shape[-4], Gm.shape[-2], Gm.shape[-1]
    perm = tuple(range(Gm.dim() - 4)) + tuple(Gm.dim() - 4 + i for i in (1, 3, 0, 2))
    return Gm.permute(perm).reshape(Gm.shape[:-4] + (H * nu, H * nx))


def condensed_cost(Fm, Gm, xbar, x0, Xref, Uref, Ubar, q_diag, r_diag, dims: OCPDims):
    """Dense Hessian and gradient of the condensed QP in delta_U.

    cost = sum_k ||x_{k+1} - xref_{k+1}||^2_Q + ||u_k - uref_k||^2_R with x_{k+1} =
    xbar_{k+1} + F[k] dx0 + (G dU)_k. Returns (Hm (..., nU, nU), g (..., nU))."""
    H = dims.horizon
    dx0 = x0 - xbar[..., 0, :]
    e = xbar[..., 1:, :] + torch.einsum("...kij,...j->...ki", Fm, dx0) - Xref
    Gt = input_operator(Gm)
    Qw = q_diag.repeat(H)
    Rw = r_diag.repeat(H)
    g_state = _mv(Gt, Qw * e.reshape(e.shape[:-2] + (-1,)))
    Hm_state = (Gt * Qw) @ Gt.transpose(-1, -2)
    du_ref = (Ubar - Uref).reshape(Ubar.shape[:-2] + (-1,))
    return Hm_state + torch.diag(Rw), g_state + Rw * du_ref


def friction_cone_rows(mu, grf_min, grf_max, contact_seq, dims: OCPDims,
                       stance_min_force: float = 0.0):
    """Per-stage inequality C_k u_k <= d_k (6 rows per leg: fz bounds and 4 cone
    rows, reference friction-cone h-constraints centroidal_nmpc_nominal.py:430-499).
    contact_seq (..., 4, H). Returns C (H, 24, nu) on the host and d (..., H, 24)
    from ``friction_cone_bounds``, both float32."""
    rows = []
    for leg in range(4):
        base = np.zeros((6, 12), dtype=np.float32)
        ex, ey, ez = leg * 3, leg * 3 + 1, leg * 3 + 2
        base[0, ez] = -1.0  # -fz <= -grf_min
        base[1, ez] = 1.0  # fz <= fz_max(stage, leg)
        base[2, ex], base[2, ez] = 1.0, -mu  # fx - mu fz <= 0
        base[3, ex], base[3, ez] = -1.0, -mu
        base[4, ey], base[4, ez] = 1.0, -mu
        base[5, ey], base[5, ez] = -1.0, -mu
        rows.append(base)
    C = torch.from_numpy(np.concatenate(rows, axis=0)).expand(dims.horizon, 24, 12)
    return C, friction_cone_bounds(grf_min, grf_max, contact_seq, stance_min_force)


def friction_cone_bounds(grf_min, grf_max, contact_seq, stance_min_force: float = 0.0):
    """The right-hand sides d (..., H, 24) of ``friction_cone_rows``, on
    contact_seq's device: the fz upper bound of a swing leg collapses to ~0, and
    ``stance_min_force`` raises the fz lower bound of stance stages only (config
    gradient.stance_min_force)."""
    seq_t = contact_seq.transpose(-1, -2)  # (..., H, 4)
    lower = -(grf_min + stance_min_force * seq_t)
    upper = grf_max * seq_t + 1e-3
    zeros = torch.zeros_like(seq_t)
    d = torch.stack([lower, upper, zeros, zeros, zeros, zeros], dim=-1)  # (..., H, 4, 6)
    return d.reshape(seq_t.shape[:-1] + (24,)).to(torch.float32)


def build_feet_trajectory(feet_now, ref_feet_list, contact_seq, horizon):
    """Per-stage foot positions over the horizon (host numpy, a copy of the JAX
    package's).

    Stance feet hold their current position; at each in-horizon touch-down the leg
    jumps to its (next) reference foothold, mirroring the reference's
    idx_ref_foot_to_assign advance (centroidal_nmpc_nominal.py:1165-1235).

    Args:
        feet_now: (4, 3) current foot positions.
        ref_feet_list: (4, K, 3) per-leg reference foothold sequence (K >= 1).
        contact_seq: (4, H).
    Returns (H, 4, 3).
    """
    feet_now = np.asarray(feet_now, np.float64)
    ref = np.asarray(ref_feet_list, np.float64)
    if ref.ndim == 2:
        ref = ref[:, None, :]
    seq = np.asarray(contact_seq)
    out = np.zeros((horizon, 4, 3))
    for leg in range(4):
        idx = 0
        pos = feet_now[leg] if seq[leg, 0] == 1 else ref[leg, 0]
        for k in range(horizon):
            if k > 0 and seq[leg, k] == 1 and seq[leg, k - 1] == 0:
                pos = ref[leg, min(idx, ref.shape[1] - 1)]
                idx += 1
            out[k, leg] = pos
    return out
