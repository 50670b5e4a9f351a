"""Parallel-in-time LQR: the Riccati backward pass as an associative scan, in torch.

Counterpart of ``quadruped_pympc_tamols_tpu/controllers/gradient/parallel_riccati.py``
(Sarkka & Garcia-Fernandez, "Temporal Parallelization of Dynamic Programming and
Linear Quadratic Control", 2021): the conditional value functions between stages
form a monoid, so the backward pass runs in O(log H) depth. Torch has no public
associative scan, so ``_suffix_scan`` is written out: an up-sweep and a down-sweep
(Brent-Kung) over the H + 1 elements, each level one batched combination of all
its pairs.

Element of stages i..j of the LTV problem

    x_{k+1} = F_k x_k + c_k + G_k u_k,
    cost    = sum_k 0.5 (x_k - xr_k)' Q_k (x_k - xr_k) + 0.5 u_k' R_k u_k
              + 0.5 (x_N - xr_N)' Q_N (x_N - xr_N)

is the 5-tuple (A, b, C, eta, J) of the conditional value function. Every
function takes leading batch dimensions; the stage axis is the one before the
matrix (or vector) axes. Linear solves use ``torch.linalg.solve_ex`` without its
error check, which would read the device's status on the host.
"""
from __future__ import annotations

import torch


def _solve(A, B):
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _gains(F, c, G, R, S1, s1):
    """Stage-wise gains from V_{k+1} = (S1, s1): u_k = -K_k x_k + kff_k."""
    Gt = G.transpose(-1, -2)
    GS = Gt @ S1
    M = R + GS @ G
    return _solve(M, GS @ F), _solve(M, _mv(Gt, s1 - _mv(S1, c))[..., None])[..., 0]


def lqr_backward_sequential(F, c, G, Q, q, R, QN, qN):
    """Standard backward Riccati for the tracking LQR above.

    Args (H = horizon, n = state dim, m = input dim, after any batch dims):
        F (H, n, n), c (H, n), G (H, n, m): dynamics.
        Q (H, n, n), q (H, n): stage state cost 0.5 x'Qx - q'x (q = Q @ xref).
        R (H, m, m): input cost.
        QN (n, n), qN (n,): terminal cost.

    Returns (K (H, m, n), kff (H, m), S (H+1, n, n), s (H+1, n)) with the control
    law u_k = -K_k x_k + kff_k and value V_k(x) = 0.5 x'S_k x - s_k'x + const.
    """
    H = F.shape[-3]
    S, s = QN, qN
    Ks, kffs, Ss, ss = [], [], [S], [s]
    for k in reversed(range(H)):
        Fk, ck, Gk = F[..., k, :, :], c[..., k, :], G[..., k, :, :]
        K, kff = _gains(Fk, ck, Gk, R[..., k, :, :], S, s)
        FGK = Fk - Gk @ K
        S_new = Q[..., k, :, :] + Fk.transpose(-1, -2) @ S @ FGK
        S_new = 0.5 * (S_new + S_new.transpose(-1, -2))
        s = q[..., k, :] + _mv(FGK.transpose(-1, -2), s - _mv(S, ck))
        S = S_new
        Ks.append(K)
        kffs.append(kff)
        Ss.append(S)
        ss.append(s)
    return (torch.stack(Ks[::-1], dim=-3), torch.stack(kffs[::-1], dim=-2),
            torch.stack(Ss[::-1], dim=-3), torch.stack(ss[::-1], dim=-2))


def _combine(e2, e1):
    """Associative combination of conditional-value elements: e1 spans stages
    i..k, e2 spans k..j (the later one), the result spans i..j."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    I = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    L = I + C1 @ J2
    Li_A1 = _solve(L, A1)
    Li_b = _solve(L, b1[..., None] + C1 @ eta2[..., None])[..., 0]
    Lt = I + J2 @ C1
    Lti_eta = _solve(Lt, eta2[..., None] - J2 @ b1[..., None])[..., 0]
    Lti_J2A1 = _solve(Lt, J2 @ A1)
    A = A2 @ Li_A1
    b = _mv(A2, Li_b) + b2
    C = A2 @ _solve(L, C1) @ A2.transpose(-1, -2) + C2
    eta = _mv(A1.transpose(-1, -2), Lti_eta) + eta1
    J = A1.transpose(-1, -2) @ Lti_J2A1 + J1
    J = 0.5 * (J + J.transpose(-1, -2))
    return (A, b, C, eta, J)


_STAGE_AXIS = (-3, -2, -3, -2, -3)  # of A, b, C, eta, J


def _suffix_scan(elems):
    """out[k] = e_k (+) e_{k+1} (+) ... (+) e_last for each k, in 2 log2(L) levels.

    The stages are reversed (position p holds stage L - 1 - p), so the suffixes
    become prefixes; the up-sweep combines pairs at distance 1, 2, 4, ... into
    the right element of each pair, the down-sweep hands the finished prefixes
    on to the positions between them. The left operand of each combination
    covers the later stages."""
    es = [torch.flip(e.movedim(ax, 0), [0]).clone() for e, ax in zip(elems, _STAGE_AXIS)]
    L = es[0].shape[0]

    def level(left, right, stride):
        rights = [e[right::stride] for e in es]
        n = rights[0].shape[0]
        if n == 0:
            return
        lefts = [e[left::stride][:n] for e in es]
        for e, v in zip(es, _combine(lefts, rights)):
            e[right::stride] = v

    offset = 1
    while offset < L:  # up-sweep
        level(offset - 1, 2 * offset - 1, 2 * offset)
        offset *= 2
    offset //= 2
    while offset >= 1:  # down-sweep
        level(2 * offset - 1, 3 * offset - 1, 2 * offset)
        offset //= 2
    return [torch.flip(e, [0]).movedim(0, ax) for e, ax in zip(es, _STAGE_AXIS)]


def lqr_backward_associative(F, c, G, Q, q, R, QN, qN):
    """O(log H)-depth Riccati; the same returns as ``lqr_backward_sequential``.

    Each stage element: A = F, b = c, C = G R^{-1} G', eta = q, J = Q; the
    terminal element (0, 0, 0, qN, QN). The suffix combination of elements k..N
    gives (eta_k, J_k) = (s_k, S_k), from which the gains follow for all stages
    at once."""
    Rinv_Gt = _solve(R, G.transpose(-1, -2))
    C = G @ Rinv_Gt
    zeros_nn = F.new_zeros(F.shape[:-3] + (1,) + F.shape[-2:])
    zeros_n = c.new_zeros(c.shape[:-2] + (1,) + c.shape[-1:])
    elems = (torch.cat([F, zeros_nn], dim=-3), torch.cat([c, zeros_n], dim=-2),
             torch.cat([C, zeros_nn], dim=-3), torch.cat([q, qN[..., None, :]], dim=-2),
             torch.cat([Q, QN[..., None, :, :]], dim=-3))
    scanned = _suffix_scan(elems)
    S_all, s_all = scanned[4], scanned[3]  # (H+1, n, n), (H+1, n)
    K, kff = _gains(F, c, G, R, S_all[..., 1:, :, :], s_all[..., 1:, :])
    return K, kff, S_all, s_all
