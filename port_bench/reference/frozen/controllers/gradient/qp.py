"""Dense primal-dual interior-point QP solvers, fixed iteration count, batched.

Counterpart of ``quadruped_pympc_tamols_tpu/controllers/gradient/qp.py`` (the
reference's HPIPM role, centroidal_nmpc_nominal.py:202, :242-251): one Cholesky
factorization of the condensed Newton matrix per iteration, a fixed iteration
budget, static shapes. Every array carries a leading batch dimension B (B = 1
for one solve, B = K for the gait candidates), where the JAX package vmaps; the
iterations are a Python loop, so the whole solve can be captured in one CUDA
graph (``utils/graphs.py``).

Problem form:  min 0.5 z^T H z + g^T z   s.t.  C z <= d, with slacks:
  C z + s = d,  s > 0,  lam > 0,  s o lam -> 0.

Two points where torch differs from ``jnp.linalg.cholesky`` and are made to agree:
the Newton matrix, a float32 matmul result that is not exactly symmetric, is
symmetrized before the factorization as JAX does (``symmetrize_input``); and a
matrix that is not positive definite yields a NaN factor, as in JAX, instead of
torch's error (``cholesky_ex`` and a mask on its ``info``, which is never read on
the host), so a failed solve reaches ``GradientMPC``'s fallback.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QPSolution(NamedTuple):
    z: torch.Tensor  # (B, n)
    lam: torch.Tensor  # (B, m)
    s: torch.Tensor  # (B, m)
    gap: torch.Tensor  # (B,) final complementarity mu
    primal_res: torch.Tensor  # (B,) max(C z - d, 0) infinity norm


def cholesky(K):
    """Lower Cholesky factor of each (n, n) matrix of K (B, n, n), symmetrized
    first as ``jnp.linalg.cholesky`` does; NaN where a matrix is not positive
    definite."""
    K = (K + K.transpose(-1, -2)) / 2
    L, info = torch.linalg.cholesky_ex(K, check_errors=False)
    return torch.where((info > 0)[:, None, None], torch.nan, L)


def cho_solve(L, b):
    """Solve (L L^T) x = b for each batch element, b (B, n): two batched
    triangular solves, as ``jax.scipy.linalg.cho_solve`` computes it."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _rmv(M, v):
    """M^T v for M (B, m, n), v (B, m)."""
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _cascade_mv(M, v):
    """M v as an elementwise product and a sum, which torch reduces in cascade
    (pairwise) order instead of the matmul's running float32 sum."""
    return (M * v[..., None, :]).sum(-1)


def _cascade_rmv(M, v):
    return (M * v[..., :, None]).sum(-2)


def _matvecs(cascade: bool):
    return (_cascade_mv, _cascade_rmv) if cascade else (_mv, _rmv)


def max_step(v, dv):
    """Fraction-to-boundary step (B,): the largest step in (0, 1] that keeps v + a dv
    positive, times 0.995."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
    return torch.clamp(0.995 * ratio.amin(dim=-1), max=1.0)


def _init(Hm, g, C, d, z0, lam0, mv):
    z = torch.zeros_like(g) if z0 is None else z0
    s = torch.clamp(d - mv(C, z), min=1.0)
    lam = torch.ones_like(d) if lam0 is None else lam0.expand_as(d)
    return z, s, lam


def _factor(Hm, C, w, reg, w_cap):
    """Factor of K = Hm + C^T diag(w) C + reg I, Jacobi-equilibrated when w_cap >
    1e5 (the soft path's stiff rows); returns (L, Dinv or None)."""
    n = Hm.shape[-1]
    I = torch.eye(n, dtype=Hm.dtype, device=Hm.device) * reg
    K = Hm + (C.transpose(-1, -2) * w[:, None, :]) @ C + I
    if w_cap > 1e5:
        Dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1), min=1e-12))
        return cholesky(K * Dinv[:, :, None] * Dinv[:, None, :] + I), Dinv
    return cholesky(K), None


def _finish(z, lam, s, C, d):
    m = d.shape[-1]
    gap = (lam * s).sum(-1) / m
    primal_res = torch.clamp(_mv(C, z) - d, min=0.0).amax(-1)
    return QPSolution(z, lam, s, gap, primal_res)


def pdip_solve(Hm, g, C, d, iters: int = 18, reg: float = 1e-7, sigma: float = 0.2,
               z0=None, mu_floor: float = 1e-4, sl_min: float = 1e-6, lam0=None,
               w_cap: float = 1e4, cascade: bool = False):
    """Solve a batch of dense QPs: Hm (B, n, n), g (B, n), C (B, m, n), d (B, m).

    Fixed ``iters`` Newton steps on the perturbed KKT system with fraction-to-boundary
    step sizes, no early exit. Float32-safe: the barrier target is floored at
    ``mu_floor`` and slack/dual magnitudes at ``sl_min``; the active-constraint
    stiffness lam/s is clamped at ``w_cap`` (see the JAX package on why). With
    ``cascade`` the residuals' matrix-vector products sum in cascade order
    (``_cascade_mv``): the variant core's larger QPs need it (controllers/
    gradient/variants.py), the nominal keeps the JAX package's matmuls."""
    m = d.shape[-1]
    _mv, _rmv = _matvecs(cascade)
    z, s, lam = _init(Hm, g, C, d, z0, lam0, _mv)
    for _ in range(iters):
        r_d = _mv(Hm, z) + g + _rmv(C, lam)
        r_p = _mv(C, z) + s - d
        mu = (lam * s).sum(-1) / m
        r_c = lam * s - sigma * torch.clamp(mu, min=mu_floor)[:, None]
        s_safe = torch.clamp(s, min=sl_min)
        w = torch.clamp(lam / s_safe, 0.0, w_cap)
        rhs = -r_d - _rmv(C, (lam * r_p - r_c) / s_safe)
        L, Dinv = _factor(Hm, C, w, reg, w_cap)
        dz = cho_solve(L, rhs) if Dinv is None else Dinv * cho_solve(L, Dinv * rhs)
        ds = -r_p - _mv(C, dz)
        dlam = -(r_c + lam * ds) / s_safe
        alpha = torch.minimum(max_step(s, ds), max_step(lam, dlam))[:, None]
        z = z + alpha * dz
        s = torch.clamp(s + alpha * ds, min=sl_min)
        lam = torch.clamp(lam + alpha * dlam, min=sl_min)
    return _finish(z, lam, s, C, d)


def pdip_solve_mehrotra(Hm, g, C, d, iters: int = 8, reg: float = 1e-7, z0=None,
                        mu_floor: float = 1e-5, sl_min: float = 1e-6, lam0=None,
                        w_cap: float = 1e4, cascade: bool = False):
    """Mehrotra predictor-corrector variant of :func:`pdip_solve`: one factorization
    serves the affine predictor and the corrector, with the adaptive centering
    sigma = (mu_aff / mu)^3; the step freezes once mu reaches 2 mu_floor.
    ``cascade`` as in :func:`pdip_solve`."""
    m = d.shape[-1]
    _mv, _rmv = _matvecs(cascade)
    z, s, lam = _init(Hm, g, C, d, z0, lam0, _mv)
    for _ in range(iters):
        r_d = _mv(Hm, z) + g + _rmv(C, lam)
        r_p = _mv(C, z) + s - d
        mu = (lam * s).sum(-1) / m
        s_safe = torch.clamp(s, min=sl_min)
        w = torch.clamp(lam / s_safe, 0.0, w_cap)
        L, Dinv = _factor(Hm, C, w, reg, w_cap)

        def kkt_solve(r_c):
            rhs = -r_d - _rmv(C, (lam * r_p - r_c) / s_safe)
            dz = cho_solve(L, rhs) if Dinv is None else Dinv * cho_solve(L, Dinv * rhs)
            ds = -r_p - _mv(C, dz)
            return dz, ds, -(r_c + lam * ds) / s_safe

        # Predictor: pure Newton on complementarity (sigma = 0).
        dz_a, ds_a, dlam_a = kkt_solve(lam * s)
        a_aff = torch.minimum(max_step(s, ds_a), max_step(lam, dlam_a))[:, None]
        mu_aff = ((lam + a_aff * dlam_a) * (s + a_aff * ds_a)).sum(-1) / m
        mu_c = torch.clamp(mu, min=mu_floor)
        ratio = mu_aff / mu_c
        sigma = torch.clamp(ratio * ratio * ratio, 0.0, 1.0)
        # Corrector: centered, with the second-order term, same factorization.
        r_c = lam * s - (sigma * mu_c)[:, None] + dlam_a * ds_a
        dz, ds, dlam = kkt_solve(r_c)
        alpha = torch.minimum(max_step(s, ds), max_step(lam, dlam))
        # Freeze once converged: further float32 steps at the floor drift the iterate.
        alpha = (alpha * (mu > 2.0 * mu_floor))[:, None]
        z = z + alpha * dz
        s = torch.clamp(s + alpha * ds, min=sl_min)
        lam = torch.clamp(lam + alpha * dlam, min=sl_min)
    return _finish(z, lam, s, C, d)


def soft_qp_solve(Hm, g, C, d, S, zl: float = 1000.0, Zl: float = 1.0, solver=None,
                  iters: int = 8):
    """Solve the QP with L1/L2-penalized slacks on the rows selected by S (m, ns),
    the acados soft h-constraints (reference centroidal_nmpc_nominal.py:147-163):
    rows i with slack t_j (S[i, j] = 1) relax to C_i z <= d_i + t_j, t >= 0, and
    the objective gains zl t + 0.5 Zl t^2. Augmented problem over v = [z; t] with
    the nonnegativity rows scaled by zl and the slacked rows' multipliers started
    at zl / 2 (the JAX package documents both). Returns the solution of the
    original variables z (B, n)."""
    solver = solver or pdip_solve_mehrotra
    B, n = g.shape
    S = torch.as_tensor(S, dtype=C.dtype, device=C.device)
    ns = S.shape[1]
    H_aug = Hm.new_zeros((B, n + ns, n + ns))
    H_aug[:, :n, :n] = Hm
    idx = torch.arange(n, n + ns, device=Hm.device)
    H_aug[:, idx, idx] = Hm.new_full((ns,), Zl)  # a device value: capturable
    g_aug = torch.cat([g, g.new_full((B, ns), zl)], dim=-1)
    C_top = torch.cat([C, (-S).expand(B, -1, -1)], dim=-1)
    C_bot = torch.cat([C.new_zeros((ns, n)), -zl * torch.eye(ns, dtype=C.dtype,
                                                               device=C.device)], dim=-1)
    C_aug = torch.cat([C_top, C_bot.expand(B, -1, -1)], dim=-2)
    d_aug = torch.cat([d, d.new_zeros((B, ns))], dim=-1)
    has_slack = (S.sum(dim=1) > 0).to(C.dtype)
    lam0 = torch.cat([1.0 + (0.5 * zl - 1.0) * has_slack, C.new_ones(ns)])
    sol = solver(H_aug, g_aug, C_aug, d_aug, iters=iters, mu_floor=1e-4, lam0=lam0, w_cap=1e7)
    return QPSolution(sol.z[:, :n], sol.lam, sol.s, sol.gap, sol.primal_res)
