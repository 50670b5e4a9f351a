"""Plain reference of one nominal gradient-MPC call, and the judge that holds the
program's calls to it.

A call (the semantics of the port's ``GradientMPC.compute_control`` with one
Gauss-Newton iteration, no RTI split, no integral action): the state vector and
per-stage feet from the controller's dict schema, the state reference tiled over
the horizon and the gravity-share force reference, the warm start (the previous
solution shifted one stage, or the force reference when there is none), the
nominal SRB rollout at the warm start, its stage Jacobians, the condensed
Gauss-Newton Hessian and gradient with the Levenberg-Marquardt term, the friction
cones, and the QP solved by the Mehrotra predictor-corrector at the configuration's
fixed iteration budget (the frozen copy of the plain solver,
``frozen/controllers/gradient/qp.py``). The solution is U = warm start + z; the
call's GRFs are its first stage times the stance mask.

Float64 on the CPU by default. The control (``tf32``): the same computation in
float32 with TF32 matmuls on the card, and the condensed QP's Hessian and gradient,
the products of the OCP's matmuls, rounded to TF32's 10-bit mantissa, since cuBLAS
runs these small GEMMs on its SIMT kernels whatever the TF32 setting.
"""
from __future__ import annotations

import numpy as np
import torch

from .precision import matmul_precision, round_tf32
from .frozen.config import make_config
from .frozen.controllers.gradient.ocp import (OCPDims, build_feet_trajectory, condense,
                                              friction_cone_bounds, friction_cone_rows,
                                              input_operator, linearize_dynamics,
                                              q_diag_gradient, r_diag_gradient, rollout_nominal)
from .frozen.controllers.gradient.qp import pdip_solve_mehrotra
from .frozen.dynamics.srbd import make_params

LEGS = ("FL", "FR", "RL", "RR")


def state_vector(state: dict) -> np.ndarray:
    return np.concatenate([np.asarray(state[k], np.float64).reshape(3) for k in
                           ("position", "linear_velocity", "orientation", "angular_velocity")])


class GradientReference:
    """The nominal call's QP built and solved in plain torch in ``dtype`` on
    ``device`` (``tf32`` for the control)."""

    def __init__(self, make_config_args: dict, iterations: int, device="cpu",
                 dtype=torch.float64, tf32: bool = False):
        cfg = make_config(**make_config_args)
        gp = cfg.mpc.gradient
        if gp.use_RTI or gp.use_DDP or gp.use_integrators or gp.num_qp_iterations != 1 \
                or cfg.mpc.type != "nominal":
            raise NotImplementedError("the gradient reference covers the nominal solve with one "
                                      "Gauss-Newton iteration and no integral action")
        self.cfg, self.dev, self.dtype, self.tf32 = cfg, torch.device(device), dtype, tf32
        self.iterations = int(iterations)
        self.H = H = cfg.mpc.horizon
        self.dims = OCPDims(horizon=H)
        self.p = make_params(cfg, dtype=dtype, device=self.dev)
        self.dts = self._t(cfg.mpc.dts())
        self.q, self.r = self._t(q_diag_gradient()), self._t(r_diag_gradient(cfg.robot.name))
        self.Qw, self.Rw = self.q.repeat(H), self.r.repeat(H)
        C_single, _ = friction_cone_rows(cfg.mpc.mu, cfg.mpc.grf_min, cfg.mpc.grf_max,
                                         torch.ones(4, H), self.dims)
        self.C = self._t(np.kron(np.eye(H), C_single[0].numpy()))
        self.lm = gp.levenberg_marquardt
        self.stance_min_force = gp.stance_min_force

    def _t(self, x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=self.dtype, device=self.dev)

    def inputs(self, state: dict, reference: dict, contact_sequence) -> tuple:
        """(x0, feet_traj (H, 4, 3), seq (4, H), Xref (H, 12), Uref (H, 12)), float32
        numpy as the controller takes them."""
        cfg, H = self.cfg, self.H
        seq = np.asarray(contact_sequence, np.float32)[:, :H]
        feet_now = np.stack([np.asarray(state[f"foot_{leg}"]).reshape(3) for leg in LEGS])
        ref_feet = np.stack([np.asarray(reference[f"ref_foot_{leg}"]).reshape(-1, 3)
                             for leg in LEGS])
        feet_traj = build_feet_trajectory(feet_now, ref_feet, seq, H).astype(np.float32)
        xref1 = np.concatenate([np.asarray(reference[k]).reshape(3) for k in
                                ("ref_position", "ref_linear_velocity", "ref_orientation",
                                 "ref_angular_velocity")]).astype(np.float32)
        Xref = np.tile(xref1, (H, 1))
        share = cfg.robot.mass * cfg.gravity / np.maximum(seq.sum(axis=0), 1.0)
        Uref = np.zeros((H, 12), np.float32)
        for leg in range(4):
            Uref[:, leg * 3 + 2] = share * seq[leg]
        return state_vector(state).astype(np.float32), feet_traj, seq, Xref, Uref

    def qp(self, x0, feet_traj, seq, Xref, Uref, U_warm) -> tuple:
        """(Hm, g, C, d, U_lin): the call's QP, min 0.5 z'Hm z + g'z s.t. C z <= d
        with U = U_lin + z, linearized at the warm start (the force reference where
        there is none)."""
        H, nu = self.H, 12
        U_ws = np.asarray(Uref if not np.any(U_warm) else U_warm, np.float32)
        x0_t, ft, sq = self._t(x0)[None], self._t(feet_traj)[None], self._t(seq)[None]
        Xr, Ur, Ub = self._t(Xref)[None], self._t(Uref)[None], self._t(U_ws)[None]
        xbar = rollout_nominal(x0_t, Ub, ft, sq, self.p, self.dts)
        lin = linearize_dynamics(xbar, Ub, ft, sq, self.p, self.dts)
        Fm, Gm = condense(lin, self.dims)
        Gt = input_operator(Gm)[0]
        Hm = (Gt * self.Qw) @ Gt.T + torch.diag(self.Rw) \
            + self.lm * torch.eye(H * nu, dtype=self.dtype, device=self.dev)
        e = xbar[0, 1:] + torch.einsum("kij,j->ki", Fm[0], x0_t[0] - xbar[0, 0]) - Xr[0]
        g = Gt @ (self.Qw * e.reshape(-1)) + self.Rw * (Ub[0] - Ur[0]).reshape(-1)
        d = friction_cone_bounds(self.cfg.mpc.grf_min, self.cfg.mpc.grf_max, sq,
                                 stance_min_force=self.stance_min_force)
        d = d.to(self.dtype).reshape(-1) - self.C @ Ub[0].reshape(-1)
        return Hm, g, self.C, d, Ub[0]

    def solve(self, x0, feet_traj, seq, Xref, Uref, U_warm) -> tuple:
        """(U (H, 12) float64 numpy, the QP's final complementarity) of one call from
        its inputs and the warm start it linearizes at."""
        with matmul_precision(self.tf32):
            Hm, g, C, d, U_lin = self.qp(x0, feet_traj, seq, Xref, Uref, U_warm)
            if self.tf32:
                Hm, g = round_tf32(Hm), round_tf32(g)
            sol = pdip_solve_mehrotra(Hm[None], g[None], C[None], d[None], iters=self.iterations)
            U = U_lin + sol.z[0].reshape(self.H, 12)
        return U.double().cpu().numpy(), float(sol.gap[0])


def judge_calls(ref: GradientReference, records: list) -> dict:
    """The numbers by which sampled calls of the program are held to the reference.
    Each record holds the call's state, reference and contact sequence, the
    program's warm start before the call (``U_warm``) and after it (``U_warm_next``,
    the solution shifted one stage), and the call's GRFs and status. Per call:

    * the GRF gap: the largest difference, in N, between the call's GRFs and the
      reference solution's first stage times the stance mask;
    * the plan gap: the largest difference between the rest of the program's
      solution (its next warm start, stages 1 to H-1) and the reference's; a call
      that took its fallback has no plan and reads infinite.

    ``grf_gap_med_N`` and ``plan_gap_med_N`` are their medians over the calls,
    ``grf_gap_N`` and ``plan_gap_N`` their largest values. At the fixed Mehrotra
    budget some calls' QPs are not yet converged, and there the float32 and
    float64 iterates part (the step freezes once mu reaches 2 mu_floor, at another
    iteration on either side): the largest gaps are of those calls, in the program
    and in a lower precision alike, and only the medians tell the two apart.
    """
    grf, plan = [], []
    for rec in records:
        x0, feet_traj, seq, Xref, Uref = ref.inputs(rec["state"], rec["reference"], rec["seq"])
        U, _ = ref.solve(x0, feet_traj, seq, Xref, Uref, rec["U_warm"])
        grfs = (U[0].reshape(4, 3) * seq[:, 0:1])
        g = np.abs(np.asarray(rec["grfs"], np.float64).reshape(4, 3) - grfs)
        grf.append(float(np.nan_to_num(g, nan=np.inf).max()))
        if rec["status"] != 0:
            plan.append(float("inf"))
            continue
        p = np.abs(np.asarray(rec["U_warm_next"], np.float64)[:-1] - U[1:])
        plan.append(float(np.nan_to_num(p, nan=np.inf).max()))
    return {"grf_gap_med_N": float(np.median(grf)), "plan_gap_med_N": float(np.median(plan)),
            "grf_gap_N": max(grf), "plan_gap_N": max(plan)}
