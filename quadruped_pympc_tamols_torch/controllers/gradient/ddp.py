"""DDP / iLQR solver option for the gradient MPC family, in torch.

Counterpart of ``quadruped_pympc_tamols_tpu/controllers/gradient/ddp.py`` (the
reference's DDP nlp-solver option, config ``use_DDP``): the Gauss-Newton stage
cost minimized with a Riccati backward pass over the horizon and a line-searched
nonlinear forward pass over four step sizes at once; the friction-cone set is
enforced by stage-wise projection during the forward rollout. The backward pass
is sequential, or the parallel-in-time pass of ``parallel_riccati.py`` (the
exact same recursion in O(log H) depth). Every array carries a leading batch
dimension B, as the RTI solve's do, so the gait candidates run as one batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ...config import Config
from ...dynamics.srbd import SRBDParams, make_params
from ...utils.device import resolve_device
from .ocp import (OCPDims, linearize_dynamics, q_diag_gradient, r_diag_gradient,
                  rollout_nominal, step_fn)
from .parallel_riccati import lqr_backward_associative
from .sqp import RTISolution

ALPHAS = (1.0, 0.6, 0.3, 0.1)  # the forward pass's step sizes
COST_NONFINITE = 3.4e38  # a non-finite line-search cost, before the argmin


def project_cone(u, contact, mu, grf_min, grf_max):
    """Project stacked (..., 12) GRF vectors onto the per-leg friction cone and
    bounds: swing legs zeroed, stance fz clamped to [grf_min, grf_max] and the
    tangential components to the mu fz box. contact (..., 4)."""
    f = u.reshape(u.shape[:-1] + (4, 3))

    def clip(x, lo, hi):  # jnp.clip's minimum(maximum(.))
        return torch.minimum(torch.maximum(x, lo), hi)

    fz = torch.clamp(f[..., 2], grf_min, grf_max) * contact
    lim = mu * fz
    fx, fy = clip(f[..., 0], -lim, lim), clip(f[..., 1], -lim, lim)
    return torch.stack([fx, fy, fz], dim=-1).reshape(u.shape)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def make_ddp_solver(cfg: Config, integrator: str = "euler", device="cuda"):
    """The DDP solve on ``device``, with the signature of the RTI solve:
    ``solve(x0, feet_traj, contact_seq, Xref, Uref, U_warm, ext_wrench=None,
    srbd_rt=None) -> RTISolution`` (arrays (B, ...) as ``make_rti_solver_split``
    takes them), and ``dims``."""
    device = resolve_device(device)
    dims = OCPDims(horizon=cfg.mpc.horizon)
    H, nx, nu = dims.horizon, dims.nx, dims.nu
    gp = cfg.mpc.gradient
    srbd = make_params(cfg, device=device)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    dts = dev(cfg.mpc.dts())
    q_diag, r_diag = dev(q_diag_gradient()), dev(r_diag_gradient(cfg.robot.name))
    Q_mat, R_f = torch.diag(q_diag), torch.diag(r_diag) + gp.levenberg_marquardt * torch.eye(
        nu, device=device)
    lm = gp.levenberg_marquardt
    mu, grf_min, grf_max = cfg.mpc.mu, cfg.mpc.grf_min, cfg.mpc.grf_max
    ddp_iters = max(1, gp.ddp_iters)
    alphas = dev(ALPHAS)

    def stage_costs(xn, u, xref, uref):
        ex, eu = xn - xref, u - uref
        return (ex * ex * q_diag).sum(-1) + (eu * eu * r_diag).sum(-1)

    def backward_sequential(A, B, xbar, U, Xref, Uref):
        """Riccati recursion; the stage cost lives on (x_{k+1}, u_k), so the state
        quadratic is folded into V_{k+1} before each stage step."""
        vx = xbar.new_zeros(xbar.shape[:-2] + (nx,))
        Vxx = xbar.new_zeros(xbar.shape[:-2] + (nx, nx))
        kff, Kfb = [None] * H, [None] * H
        for k in reversed(range(H)):
            Ak, Bk = A[:, k], B[:, k]
            Bt = Bk.transpose(-1, -2)
            vx_eff = vx + q_diag * (xbar[:, k + 1] - Xref[:, k])
            Vxx_eff = Vxx + Q_mat
            Qu = _mv(Bt, vx_eff) + r_diag * (U[:, k] - Uref[:, k])
            Quu = Bt @ Vxx_eff @ Bk + R_f
            Qux = Bt @ Vxx_eff @ Ak
            kK = torch.linalg.solve_ex(Quu, torch.cat([Qu[..., None], Qux], dim=-1),
                                       check_errors=False)[0]
            kff[k], Kfb[k] = -kK[..., 0], -kK[..., 1:]
            Quxt = Qux.transpose(-1, -2)
            vx = _mv(Ak.transpose(-1, -2), vx_eff) + _mv(Quxt, kff[k])
            Vxx = Ak.transpose(-1, -2) @ Vxx_eff @ Ak + Quxt @ Kfb[k]
            Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        return torch.stack(kff, dim=1), torch.stack(Kfb, dim=1)

    def backward_associative(A, B, xbar, U, Xref, Uref):
        """The same recursion in O(log H) depth (``parallel_riccati.py``), by an
        exact reduction to the tracking-LQR form: deviations around the nominal
        rollout, the input linear term absorbed by the shift m = R_f^{-1} r (U -
        Uref) (R_f diagonal), and the stage state costs (on dx_{k+1}) moved one
        stage on, the last one becoming the terminal cost."""
        Bsz = U.shape[0]
        m = (r_diag * (U - Uref)) / (r_diag + lm)  # (B, H, nu)
        c = -torch.einsum("bknm,bkm->bkn", B, m)
        g = q_diag * (xbar[:, 1:] - Xref)  # cost gradients at dx_{k+1} = 0
        Qs = torch.cat([Q_mat.new_zeros((Bsz, 1, nx, nx)),
                        Q_mat.expand(Bsz, H - 1, nx, nx)], dim=1)
        qs = torch.cat([g.new_zeros((Bsz, 1, nx)), -g[:, :-1]], dim=1)
        K, kff_lqr, _, _ = lqr_backward_associative(A, c, B, Qs, qs, R_f.expand(Bsz, H, nu, nu),
                                                    Q_mat.expand(Bsz, nx, nx), -g[:, -1])
        # LQR law w = -K dx + kff  ->  du = -K dx + (kff - m).
        return kff_lqr - m, -K

    # riccati_backward "auto": the parallel-in-time pass once the horizon is long
    # enough for its O(log H) depth to beat the sequential recursion.
    mode = gp.riccati_backward
    if mode == "auto":
        mode = "associative" if H >= 24 else "sequential"
    backward = backward_associative if mode == "associative" else backward_sequential

    def forward(x0, Ubar, xbar, kff, Kfb, feet_traj, contact_seq, Xref, Uref, wrench, p):
        """All step sizes at once: arrays gain an axis of len(ALPHAS) after B."""
        a = alphas[:, None]
        x = x0[:, None].expand(-1, len(ALPHAS), -1)
        p4 = SRBDParams(mass=p.mass[:, None], inertia=p.inertia[:, None],
                        inertia_inv=p.inertia_inv[:, None], gravity=p.gravity)
        cost, Us = x.new_zeros(x.shape[:-1]), []
        for k in range(H):
            u = Ubar[:, None, k] + a * kff[:, None, k] + _mv(Kfb[:, None, k], x - xbar[:, None, k])
            c = contact_seq[:, None, :, k]
            u = project_cone(u, c, mu, grf_min, grf_max)
            x = step_fn(x, u, feet_traj[:, None, k], c, p4, dts[k], integrator,
                        wrench[:, None, k])
            cost = cost + stage_costs(x, u, Xref[:, None, k], Uref[:, None, k])
            Us.append(u)
        return cost, torch.stack(Us, dim=2)  # (B, 4), (B, 4, H, nu)

    def solve(x0, feet_traj, contact_seq, Xref, Uref, U_warm, ext_wrench=None, srbd_rt=None):
        p = srbd if srbd_rt is None else srbd_rt
        if p.mass.dim() == 0:
            Bsz = x0.shape[0]
            p = SRBDParams(mass=p.mass.expand(Bsz), inertia=p.inertia.expand(Bsz, 3, 3),
                           inertia_inv=p.inertia_inv.expand(Bsz, 3, 3), gravity=p.gravity)
        wrench = x0.new_zeros((x0.shape[0], H, 6)) if ext_wrench is None else ext_wrench
        # Start from the cone-projected warm start so the first linearization is
        # feasible.
        U = project_cone(U_warm, contact_seq.transpose(-1, -2), mu, grf_min, grf_max)
        ar = torch.arange(U.shape[0], device=U.device)
        for _ in range(ddp_iters):
            xbar = rollout_nominal(x0, U, feet_traj, contact_seq, p, dts, integrator, wrench)
            lin = linearize_dynamics(xbar, U, feet_traj, contact_seq, p, dts, integrator, wrench)
            kff, Kfb = backward(lin.A, lin.B, xbar, U, Xref, Uref)
            costs, Us = forward(x0, U, xbar, kff, Kfb, feet_traj, contact_seq, Xref, Uref,
                                wrench, p)
            costs = torch.where(torch.isfinite(costs), costs, COST_NONFINITE)
            best = torch.argmin(costs, dim=1)
            U, cost = Us[ar, best], costs[ar, best]
        xs = rollout_nominal(x0, U, feet_traj, contact_seq, p, dts, integrator, wrench)
        zero = cost.new_zeros(cost.shape)
        return RTISolution(U, U[:, 0].reshape(-1, 4, 3), xs[:, 1], cost, zero, zero)

    return solve, dims
