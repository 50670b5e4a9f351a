"""Solver-accuracy verification ladders: the float32 production paths against
float64 references on the same inputs.

The port's own copy of ``quadruped_pympc_tamols_tpu/utils/verification.py``:

* ``pdip_solve_np_f64``, a float64 numpy Mehrotra predictor-corrector run to
  machine-precision complementarity;
* the nominal QP ladder: ``capture_tick_qps``, the inputs of real closed-loop
  ticks of the SRB harness with the nominal gradient MPC, and
  ``qp_ladder_report``, the production solve's gap to the reference on the QPs
  those ticks assemble (``make_rti_solver_split(..., return_assembler=True)``:
  the matrices the feedback phase solves);
* the soft-constrained QP ladder of the variant core: ``soft_qp_augment_np``
  (the slack augmentation of ``qp.soft_qp_solve`` in float64),
  ``capture_variant_ticks`` and ``soft_qp_ladder_report``;
* the sampling rollout ladder: ``srb_rollout_cost_np_f64`` (the rollout cost of
  one parameter vector in float64), ``capture_sampling_ticks`` and
  ``rollout_ladder_report``.
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


def soft_qp_augment_np(Hm, g, C, d, S, zl: float = 1000.0, Zl: float = 1.0):
    """Float64 numpy twin of ``qp.soft_qp_solve``'s slack augmentation (the same
    zl row scaling), so that the float64 reference solves the exact augmented
    problem the production float32 path solves."""
    Hm, g, C, d, S = (np.asarray(a, np.float64) for a in (Hm, g, C, d, S))
    n, ns = g.shape[0], S.shape[1]
    H_aug = np.zeros((n + ns, n + ns))
    H_aug[:n, :n] = Hm
    H_aug[np.arange(n, n + ns), np.arange(n, n + ns)] = Zl
    g_aug = np.concatenate([g, np.full(ns, zl)])
    C_aug = np.concatenate([np.concatenate([C, -S], axis=1),
                            np.concatenate([np.zeros((ns, n)), -zl * np.eye(ns)], axis=1)],
                           axis=0)
    d_aug = np.concatenate([d, np.zeros(ns)])
    return H_aug, g_aug, C_aug, d_aug


def _harness_records(cfg, seam, record, n_ticks, duration, vel, seed, device):
    """Drive the SRB harness on ``device``, intercepting its controller's
    ``seam`` method with ``record(args, out) -> dict``; returns (controller,
    records of ticks 5 .. 5 + n_ticks), skipping the standing start."""
    from ..sim.srb_harness import SRBClosedLoopHarness

    h = SRBClosedLoopHarness(cfg, seed=seed, device=device)
    mpc = h.ctrl.controller
    orig = getattr(mpc, seam)
    records = []

    def recording(*a):
        out = orig(*a)
        records.append(record(a, out))
        return out

    setattr(mpc, seam, recording)
    v = np.asarray(vel, np.float64)
    for _ in range(int(duration / cfg.sim.dt)):
        h.step(v)
        if len(records) >= n_ticks + 5:
            break
    setattr(mpc, seam, orig)
    return mpc, records[5:5 + n_ticks]


def capture_variant_ticks(cfg, n_ticks: int = 10, duration: float = 3.0,
                          vel=(0.3, 0.0, 0.0), seed: int = 0, device="cuda"):
    """The solver inputs (x0, feet_traj, seq, Xref, Uref, U_warm, wrench) of real
    closed-loop ticks of a variant controller (the soft-slacked QP path of the
    stability knobs and the augmented-state families): the SRB harness on
    ``device``, ``VariantGradientMPC.solve`` intercepted. Returns (controller,
    records)."""
    names = ("x0", "feet_traj", "seq", "Xref", "Uref", "U_warm", "wrench")
    return _harness_records(
        cfg, "solve", lambda a, out: {k: np.array(x, np.float32) for k, x in zip(names, a)},
        n_ticks, duration, vel, seed, device)


def soft_qp_ladder_report(cfg=None, n_ticks: int = 10, device="cuda", ticks=None, iters=None):
    """Float64 ladder of the soft-slacked QP path (L1/L2 slack penalties,
    ``qp.soft_qp_solve``): real ticks of the variant controller on ``device``
    (by default the nominal variant with the ZMP band, the stone-crossing
    configuration), the exact condensed QP of each tick re-assembled at its warm
    start on ``device``, the production float32 soft solve (at the device's
    budget, or ``iters``) against the float64 Mehrotra reference of the same
    augmented matrices. Also counts the ticks with an active slack (t > 1e-4 in
    the float64 solution). ``ticks`` (controller, records) skips the capture."""
    from ..config import make_config
    from ..controllers.gradient.qp import soft_qp_solve
    from ..controllers.gradient.variants import make_variant_solver, variant_qp_solver

    if cfg is None:
        cfg = make_config("aliengo", mpc_type="nominal",
                          **{"sim.visual_foothold_adaptation": "blind",
                             "mpc.gradient.use_zmp_stability": True})
    mpc, ticks = ticks or capture_variant_ticks(cfg, n_ticks=n_ticks, device=device)
    _, _, assemble, S_big = make_variant_solver(cfg, mpc.spec, return_assembler=True,
                                                device=device)
    if S_big is None:
        raise ValueError("the configuration does not produce a soft-slacked QP")
    qp_fn, budget = variant_qp_solver(cfg.mpc.gradient, device)
    iters = budget if iters is None else iters
    S_dev = torch.as_tensor(S_big, device=device)

    def dev(x):
        return torch.as_tensor(x, device=device)

    grf_dev, mu_ref, active = [], [], 0
    for t in ticks:
        q = assemble(*(dev(t[k]) for k in ("x0", "feet_traj", "seq", "Xref", "Uref",
                                           "U_warm", "wrench")))
        z32 = soft_qp_solve(*(a[None] for a in q), S_dev, zl=cfg.mpc.gradient.slack_l1,
                            Zl=cfg.mpc.gradient.slack_l2, solver=qp_fn,
                            iters=iters).z[0].cpu().numpy()
        Hm, g, C, d = (a.cpu().numpy() for a in q)
        z64_aug, mu = pdip_solve_np_f64(*soft_qp_augment_np(
            Hm, g, C, d, S_big, cfg.mpc.gradient.slack_l1, cfg.mpc.gradient.slack_l2))
        mu_ref.append(mu)
        n = g.shape[0]
        active += int(np.max(z64_aug[n:]) > 1e-4)
        # The first stage's GRFs: the nominal's u, the last 12 inputs otherwise.
        sl = slice(n // cfg.mpc.horizon - 12, n // cfg.mpc.horizon)
        u0_32 = t["U_warm"][0, sl] + z32[sl]
        u0_64 = t["U_warm"][0, sl].astype(np.float64) + z64_aug[sl]
        grf_dev.append(np.max(np.abs(u0_32 - u0_64)))
    total_load = float(cfg.robot.mass * cfg.gravity)
    return {"n_ticks": len(ticks), "qp_iters": iters, "n_active_slack_ticks": active,
            "soft_qp_gap_vs_f64_max_N": float(np.max(grf_dev)),
            "soft_qp_gap_vs_f64_mean_N": float(np.mean(grf_dev)),
            "soft_qp_gap_vs_f64_rel": float(np.max(grf_dev) / total_load),
            "f64_mu_max": float(np.max(mu_ref))}


def srb_rollout_cost_np_f64(state12, feet, ref12, raw_steps, contact_seq, share, dts, q_diag,
                            mass, gravity, inertia, fm):
    """Float64 numpy twin of the sampling rollout cost of one parameter vector
    (``controllers/sampling/rollout.rollout_costs_soa`` at N = 1): the same force
    model (gravity share, contact mask, friction clamp), Newton-Euler SRB Euler
    integration and quadratic state cost, without float32 rounding."""
    x = np.asarray(state12, np.float64).copy()
    feet = np.asarray(feet, np.float64)
    ref = np.asarray(ref12, np.float64)
    I = np.asarray(inertia, np.float64)
    Iinv = np.linalg.inv(I)
    cost = 0.0
    for n in range(raw_steps.shape[0]):
        raw = np.asarray(raw_steps[n], np.float64)  # (12,)
        F, T = np.zeros(3), np.zeros(3)
        for leg in range(4):
            c = float(contact_seq[leg, n])
            sh = share[n][leg] if np.ndim(share[n]) else share[n]
            fz = np.clip((sh + raw[leg * 3 + 2]) * c, fm.grf_min, fm.grf_max)
            lim = fm.mu * fz
            fx = np.clip(raw[leg * 3 + 0] * (c * fm.scale_x), -lim, lim)
            fy = np.clip(raw[leg * 3 + 1] * (c * fm.scale_y), -lim, lim)
            f = np.array([fx, fy, fz])
            F += f
            T += np.cross(feet[leg] - x[0:3], f)
        acc = F / mass - np.array([0.0, 0.0, gravity])
        sr, cr = np.sin(x[6]), np.cos(x[6])
        sp, cp = np.sin(x[7]), np.cos(x[7])
        sy, cy = np.sin(x[8]), np.cos(x[8])
        Einv = np.array([[1, sr * sp / cp, cr * sp / cp], [0, cr, -sr], [0, sr / cp, cr / cp]])
        Rwb = np.array([[cp * cy, cp * sy, -sp],
                        [sr * sp * cy - cr * sy, sr * sp * sy + cr * cy, sr * cp],
                        [cr * sp * cy + sr * sy, cr * sp * sy - sr * cy, cr * cp]])
        w = x[9:12]
        wd = Iinv @ (Rwb @ T - np.cross(w, I @ w))
        dt = float(dts[n])
        x[0:3] += x[3:6] * dt
        x[3:6] += acc * dt
        x[6:9] += (Einv @ w) * dt
        x[9:12] += wd * dt
        e = x - ref
        cost += float(np.sum(np.asarray(q_diag, np.float64) * e * e))
    return cost


def capture_sampling_ticks(cfg, n_ticks: int = 12, duration: float = 3.0,
                           vel=(0.3, 0.0, 0.0), seed: int = 0, device="cuda"):
    """Real sampling-MPC tick inputs and each tick's solved incumbent parameters,
    from the SRB harness on ``device`` (the ``SamplingMPC.solve`` seam)."""
    def record(a, out):
        state12, feet, ref12, ref_feet, seq, cur = a[:6]
        return dict(state12=np.array(state12, np.float32), feet=np.array(feet, np.float32),
                    ref12=np.array(ref12, np.float32), ref_feet=np.array(ref_feet, np.float32),
                    seq=np.array(seq, np.float32), cur=np.array(cur, np.float32),
                    params=out[1].best_parameters.cpu().numpy().astype(np.float32))

    return _harness_records(cfg, "solve", record, n_ticks, duration, vel, seed, device)[1]


def rollout_ladder_report(cfg=None, n_ticks: int = 12, device="cuda"):
    """Float64 ladder of the sampling rollout cost: on real captured tick states and
    their solved incumbents, the production float32 rollout (``rollout_costs_soa``
    on ``device``, the plain version of the sampling kernels' rollout pass)
    against ``srb_rollout_cost_np_f64``. Reports the largest and mean relative
    cost gap, the float32 rounding the optimizer's argmin and softmax see."""
    from ..config import make_config, replace_config
    from ..controllers.sampling.rollout import ForceModelParams, rollout_costs_soa
    from ..controllers.sampling.splines import make_step_major_basis
    from ..dynamics.srbd import make_params

    if cfg is None:
        cfg = replace_config(make_config("aliengo", mpc_type="sampling"),
                             **{"mpc.sampling.num_samples": 512,
                                "sim.visual_foothold_adaptation": "blind"})
    ticks = capture_sampling_ticks(cfg, n_ticks=n_ticks, device=device)
    sp, H = cfg.mpc.sampling, cfg.mpc.horizon
    params = make_params(cfg, device=device)
    mass = float(np.float32(cfg.robot.mass))
    dts = cfg.mpc.dts()
    q_diag = np.asarray(cfg.mpc.cost.as_vector())
    fm = ForceModelParams(sp.max_force_x / sp.max_force_z, sp.max_force_y / sp.max_force_z,
                          cfg.mpc.grf_min, cfg.mpc.grf_max, cfg.mpc.mu)
    W = make_step_major_basis(sp.parametrization, H, sp.num_splines)  # (H*12, P)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    rels = []
    for t in ticks:
        feet_eff = np.where(t["cur"][:, None] == 0.0, t["ref_feet"], t["feet"])
        share = (np.float32(mass) * np.float32(9.81)
                 / np.maximum(t["seq"].sum(axis=0), 1.0)).astype(np.float32)
        raw32 = (W.astype(np.float32) @ t["params"]).reshape(H, 12, 1)
        c32 = float(rollout_costs_soa(dev(t["state12"]), dev(feet_eff), dev(t["ref12"]),
                                      dev(raw32), dev(t["seq"]), dev(share), dts, q_diag,
                                      params, fm)[0])
        raw64 = (W.astype(np.float64) @ t["params"].astype(np.float64)).reshape(H, 12)
        c64 = srb_rollout_cost_np_f64(t["state12"], feet_eff, t["ref12"], raw64, t["seq"],
                                      share.astype(np.float64), dts, q_diag, mass,
                                      float(params.gravity), params.inertia.cpu().numpy(), fm)
        rels.append(abs(c32 - c64) / max(abs(c64), 1e-9))
    return {"rollout_ladder_n_ticks": len(ticks), "rollout_gap_vs_f64_rel": float(np.max(rels)),
            "rollout_gap_vs_f64_mean_rel": float(np.mean(rels))}


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
