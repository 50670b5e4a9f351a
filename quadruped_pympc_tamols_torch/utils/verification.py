"""Solver-accuracy verification ladder: the float32 fixed-iteration interior point
against a float64 reference on the same QPs.

The port's own copy of the QP ladder of
``quadruped_pympc_tamols_tpu/utils/verification.py``: ``pdip_solve_np_f64``, a
float64 numpy Mehrotra predictor-corrector run to machine-precision
complementarity; ``capture_tick_qps``, the inputs of real closed-loop MPC ticks
of the SRB harness with the nominal gradient MPC; ``qp_ladder_report``, the gap
of the production solve to the reference on the QPs those ticks assemble
(``make_rti_solver_split(..., return_assembler=True)``: the matrices the feedback
phase solves).
"""
from __future__ import annotations

import numpy as np
import torch


def pdip_solve_np_f64(Hm, g, C, d, iters: int = 200, tol: float = 1e-12):
    """Reference-grade dense QP solve: min 0.5 z'Hz + g'z s.t. Cz <= d.

    Float64 Mehrotra predictor-corrector (the algorithm family of the production
    ``qp.pdip_solve_mehrotra`` and HPIPM) run until the complementarity and primal
    residuals fall below ``tol`` (or ``iters``). Host numpy. Returns (z, mu).
    """
    Hm = np.asarray(Hm, np.float64)
    g = np.asarray(g, np.float64)
    C = np.asarray(C, np.float64)
    d = np.asarray(d, np.float64)
    n, m = g.shape[0], d.shape[0]
    z = np.zeros(n)
    s = np.maximum(d - C @ z, 1.0)
    lam = np.ones(m)
    I = np.eye(n) * 1e-12

    def max_step(v, dv):
        neg = dv < 0
        if not np.any(neg):
            return 1.0
        return min(1.0, 0.995 * np.min(-v[neg] / dv[neg]))

    for _ in range(iters):
        r_d = Hm @ z + g + C.T @ lam
        r_p = C @ z + s - d
        mu = float(lam @ s) / m
        if mu < tol and np.max(np.maximum(r_p, 0.0), initial=0.0) < tol \
                and np.max(np.abs(r_d)) < 1e-8:
            break
        w = lam / s
        K = Hm + (C.T * w[None, :]) @ C + I
        # Adaptive, scale-aware primal regularization for near-degenerate active
        # sets; convergence is judged on the unregularized residuals.
        reg = 1e-14 * float(np.max(np.diag(K)))
        while True:
            try:
                L = np.linalg.cholesky(K + reg * np.eye(n))
                break
            except np.linalg.LinAlgError:
                reg *= 1e3
                if reg > 1e-2 * float(np.max(np.diag(K))):
                    raise

        def kkt(r_c):
            rhs = -r_d - C.T @ ((lam * r_p - r_c) / s)
            dz = np.linalg.solve(L.T, np.linalg.solve(L, rhs))
            ds = -r_p - C @ dz
            dlam = -(r_c + lam * ds) / s
            return dz, ds, dlam

        dz_a, ds_a, dlam_a = kkt(lam * s)
        a_aff = min(max_step(s, ds_a), max_step(lam, dlam_a))
        mu_aff = float((lam + a_aff * dlam_a) @ (s + a_aff * ds_a)) / m
        sigma = np.clip((mu_aff / max(mu, 1e-300)) ** 3, 0.0, 1.0)
        dz, ds, dlam = kkt(lam * s - sigma * mu + dlam_a * ds_a)
        alpha = min(max_step(s, ds), max_step(lam, dlam))
        z = z + alpha * dz
        s = np.maximum(s + alpha * ds, 1e-300)
        lam = np.maximum(lam + alpha * dlam, 1e-300)
    return z, float(lam @ s) / m


def capture_tick_qps(cfg, n_ticks: int = 20, duration: float = 3.0, vel=(0.3, 0.0, 0.0),
                     seed: int = 0, device="cuda"):
    """The inputs (x0, feet_traj, seq, Xref, Uref, U_warm) of ``n_ticks`` real
    closed-loop MPC ticks: the SRB harness on ``device`` with the nominal gradient
    MPC, every ``solve`` intercepted; the first 5 ticks (standing start, interior
    QPs) are skipped."""
    from ..sim.srb_harness import SRBClosedLoopHarness

    h = SRBClosedLoopHarness(cfg, seed=seed, device=device)
    mpc = h.ctrl.controller
    orig_solve = mpc.solve
    records = []

    def recording_solve(x0, feet_traj, seq, Xref, Uref, U_warm, wrench, srbd_rt):
        records.append(dict(
            x0=np.array(x0, np.float32), feet_traj=np.array(feet_traj, np.float32),
            seq=np.array(seq, np.float32), Xref=np.array(Xref, np.float32),
            Uref=np.array(Uref, np.float32), U_warm=np.array(U_warm, np.float32)))
        return orig_solve(x0, feet_traj, seq, Xref, Uref, U_warm, wrench, srbd_rt)

    mpc.solve = recording_solve
    v = np.asarray(vel, np.float64)
    for _ in range(int(duration / cfg.sim.dt)):
        h.step(v)
        if len(records) >= n_ticks + 5:
            break
    mpc.solve = orig_solve
    return records[5:5 + n_ticks]


def qp_ladder_report(cfg, ticks=None, n_ticks: int = 20, device="cuda", iters=None):
    """The production float32 solve on ``device`` (at its iteration budget there,
    or ``iters``) against the float64 reference on real tick QPs assembled on ``device``: max and
    mean first-stage GRF deviation [N], the max relative to the robot's weight,
    the float64 complementarity reached, and the budget."""
    from ..controllers.gradient.sqp import make_rti_solver_split, qp_solver_for

    if ticks is None:
        ticks = capture_tick_qps(cfg, n_ticks=n_ticks, device=device)
    *_, assemble_qp = make_rti_solver_split(cfg, return_assembler=True, device=device)
    qp_fn, budget = qp_solver_for(cfg.mpc.gradient, device)
    iters = budget if iters is None else iters

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)[None]

    grf_dev, mu_ref = [], []
    for t in ticks:
        Hm, g, C, d = assemble_qp(dev(t["x0"]), dev(t["feet_traj"]), dev(t["seq"]),
                                  dev(t["Xref"]), dev(t["Uref"]), dev(t["U_warm"]))
        z32 = qp_fn(Hm, g, C, d, iters=iters).z[0].cpu().numpy()
        z64, mu = pdip_solve_np_f64(*(x[0].cpu().numpy() for x in (Hm, g, C, d)))
        mu_ref.append(mu)
        u0_32 = t["U_warm"][0] + z32[:12]
        u0_64 = t["U_warm"][0].astype(np.float64) + z64[:12]
        grf_dev.append(np.max(np.abs(u0_32 - u0_64)))
    total_load = float(cfg.robot.mass * cfg.gravity)
    return {"n_ticks": len(ticks), "qp_iters": iters,
            "qp_gap_vs_f64_max_N": float(np.max(grf_dev)),
            "qp_gap_vs_f64_mean_N": float(np.mean(grf_dev)),
            "qp_gap_vs_f64_rel": float(np.max(grf_dev) / total_load),
            "f64_mu_max": float(np.max(mu_ref))}


def _golden_feet():
    return dict(foot_FL=np.array([0.25, 0.15, 0.0]), foot_FR=np.array([0.25, -0.15, 0.0]),
                foot_RL=np.array([-0.25, 0.15, 0.0]), foot_RR=np.array([-0.25, -0.15, 0.0]))


def golden_nominal_scenarios(cfg):
    """The five nominal ticks of the JAX package's golden traces
    (tests/test_golden_traces.py): name -> (state, reference, contact sequence),
    in the controller's dict schema. "push" is the hard one: its float32 iterate
    is chaotic near the interior point's floor."""
    H = cfg.mpc.horizon

    def state(pos=(0, 0, 0.32), vel=(0, 0, 0), rpy=(0, 0, 0), feet=None):
        s = dict(position=np.asarray(pos, float), linear_velocity=np.asarray(vel, float),
                 orientation=np.asarray(rpy, float), angular_velocity=np.zeros(3))
        s.update(feet or _golden_feet())
        return s

    def ref(vel=(0, 0, 0), rpy=(0, 0, 0), feet=None):
        feet = feet or _golden_feet()
        return dict(ref_position=np.array([0.0, 0.0, cfg.sim.ref_z]),
                    ref_linear_velocity=np.asarray(vel, float),
                    ref_orientation=np.asarray(rpy, float), ref_angular_velocity=np.zeros(3),
                    **{f"ref_foot_{leg}": feet[f"foot_{leg}"][None]
                       for leg in ("FL", "FR", "RL", "RR")})

    full = np.ones((4, H))
    trot = np.ones((4, H))
    trot[1, : H // 2] = trot[2, : H // 2] = 0.0
    trot[0, H // 2:] = trot[3, H // 2:] = 0.0
    three = np.ones((4, H))
    three[1, :] = 0.0
    slope = _golden_feet()
    for leg, dz in (("foot_FL", 0.07), ("foot_FR", 0.07), ("foot_RL", -0.07),
                    ("foot_RR", -0.07)):
        slope[leg] = slope[leg] + np.array([0.0, 0.0, dz])
    return {"stand_nominal": (state(pos=(0, 0, 0.29)), ref(), full),
            "trot_nominal": (state(vel=(0.2, 0, 0)), ref(vel=(0.3, 0, 0)), trot),
            "three_stance_nominal": (state(), ref(), three),
            "push_nominal": (state(vel=(0, 0.4, 0), rpy=(0.1, 0, 0)), ref(), full),
            "slope_nominal": (state(rpy=(0, -0.15, 0), feet=slope),
                              ref(rpy=(0, -0.15, 0), feet=slope), full)}
