"""RTI-SQP gradient MPC on the condensed interior-point QP, in torch.

Counterpart of ``quadruped_pympc_tamols_tpu/controllers/gradient/sqp.py``
(reference Acados_NMPC_Nominal, controllers/gradient/nominal/
centroidal_nmpc_nominal.py): Gauss-Newton SQP on the shared SRB dynamics with the
real-time-iteration split (prepare = linearize + condense at the predicted
state; feedback = refresh the gradient with the measured x0 and solve the QP,
acados' rti_phase 1/2), gravity-share z-force references, per-stage feet
advanced at in-horizon touch-downs, the previous-GRF fallback on a failed
solve, integral action, and the gait candidates as one batched solve. With
``mpc.gradient.use_DDP`` the solve is the DDP solver of ``ddp.py`` instead, with
no prepare/feedback split.

Where it runs: the device functions of ``make_rti_solver_split`` are torch ops
with a leading batch dimension. ``GradientMPC`` packs a tick's host inputs
into one flat buffer and, on a CUDA device, runs each phase (solve, prepare,
feedback; the batched solve at its own batch size) as the replay of one captured
CUDA graph (``utils/graphs.py``): one host-to-device copy, one replay and one
device-to-host copy of one flat result [U, first-stage GRFs, predicted state,
cost, QP gap, QP residual] a tick. ``prepare`` returns without waiting, so it
overlaps the plant step. On the CPU the same functions run eagerly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...config import Config
from ...dynamics.srbd import SRBDParams, make_params
from ...utils.device import resolve_device
from ...utils.graphs import GraphedFunction
from .ocp import (OCPDims, build_feet_trajectory, condense, friction_cone_bounds,
                  friction_cone_rows, input_operator, linearize_dynamics, q_diag_gradient,
                  r_diag_gradient, rollout_nominal)
from .qp import pdip_solve, pdip_solve_mehrotra

_LEGS = ("FL", "FR", "RL", "RR")


class RTISolution(NamedTuple):
    U: object  # (..., H, nu) optimal GRF sequence
    grfs: object  # (..., 4, 3) first-stage GRFs
    predicted_state: object  # (..., 12) state after the first stage
    cost: object  # (...,) nonlinear objective of the returned trajectory
    qp_gap: object
    qp_primal_res: object


class PrepState(NamedTuple):
    """Products of the RTI preparation phase (linearize + condense + Hessian) at the
    PREDICTED state, the acados rti_phase=1 equivalent; device tensors (B, ...)."""

    xbar: torch.Tensor  # (B, H+1, nx) nominal rollout at the predicted state
    Ubar: torch.Tensor  # (B, H, nu) inputs the linearization was taken at
    Fm: torch.Tensor  # (B, H, nx, nx) prediction operator for the dx0 term
    Gt: torch.Tensor  # (B, H*nu, H*nx) transposed input-prediction operator
    Hm: torch.Tensor  # (B, H*nu, H*nu) condensed Gauss-Newton Hessian


def build_stage_wrench(cfg: Config, external_wrenches, H: int) -> np.ndarray:
    """Per-stage (H, 6) compensated wrench: the estimate applies only to the first
    external_wrenches_compensation_num_step stages (reference
    centroidal_nmpc_input_rates.py:1360-1373)."""
    gp = cfg.mpc.gradient
    if external_wrenches is None or not gp.external_wrenches_compensation:
        return np.zeros((H, 6), np.float32)
    w6 = np.asarray(external_wrenches, np.float32).reshape(6)
    mask = (np.arange(H) < gp.external_wrenches_compensation_num_step)[:, None]
    return (w6[None, :] * mask).astype(np.float32)


def _qp_iters(gp) -> int:
    return {"balance": gp.qp_iters, "robust": gp.qp_iters + 6,
            "speed": gp.qp_iters_speed, "crazy_speed": gp.qp_iters_crazy_speed}[gp.solver_mode]


def qp_solver_for(gp, device="cuda"):
    """(solver_fn, iters) for the configured QP algorithm and mode.

    The Mehrotra budgets are set per backend by the float64 verification ladder
    (``utils/verification.py``), as in the JAX package: 14 iterations in "balance"
    on the CPU, 10 on the card."""
    if gp.qp_algorithm == "mehrotra":
        on_cpu = torch.device(device).type == "cpu"
        iters = {"balance": 14 if on_cpu else 10,
                 "robust": 18 if on_cpu else 14,
                 "speed": 6, "crazy_speed": 4}[gp.solver_mode]
        return pdip_solve_mehrotra, iters
    return pdip_solve, _qp_iters(gp)


def sqp_iterations(gp) -> int:
    """Gauss-Newton iterations a tick: one for RTI, plus as_rti_iter for AS-RTI-A..D
    (arXiv:2403.07101); num_qp_iterations otherwise."""
    if gp.use_RTI:
        extra = gp.as_rti_iter if gp.as_rti_type != "Standard" else 0
        return 1 + max(0, extra)
    return max(1, gp.num_qp_iterations)


def make_rti_solver(cfg: Config, integrator: str = "euler", device="cuda"):
    """The one-shot RTI solve and the dims (JAX ``make_rti_solver``): ``(solve,
    dims)`` of ``make_rti_solver_split``, whose docstring gives the arguments."""
    solve, _, _, dims = make_rti_solver_split(cfg, integrator, device=device)
    return solve, dims


def make_rti_solver_split(cfg: Config, integrator: str = "euler",
                          return_assembler: bool = False, device="cuda"):
    """The RTI machinery as eager torch functions on ``device``: ``(solve, prepare,
    feedback, dims)``, and with ``return_assembler=True`` a fifth,
    ``assemble_qp(x0, feet_traj, contact_seq, Xref, Uref, U_warm) -> (Hm, g, C,
    d)``, the exact dense QP the feedback phase hands to the interior point (min
    0.5 z'Hz + g'z s.t. Cz <= d, U = U_warm + z.reshape(H, nu)), the seam of the
    float64 verification ladder.

    Every argument has a leading batch dimension B: x0 (B, 12), feet_traj (B, H, 4,
    3), contact_seq (B, 4, H), Xref, Uref and U_warm (B, H, 12), ext_wrench (B, H,
    6) or None, srbd_rt an SRBDParams of (B,), (B, 3, 3) and (B, 3, 3) tensors or
    None (the static parameters).

    * ``solve(x0, feet_traj, contact_seq, Xref, Uref, U_warm, ext_wrench, srbd_rt)
      -> RTISolution``: the one-shot SQP/RTI solve;
    * ``prepare(x_pred, ...same...) -> PrepState``: rti_phase=1 at the predicted
      state (plus the AS-RTI extra iterations);
    * ``feedback(prep, x0, feet_traj, contact_seq, Xref, Uref, ext_wrench,
      srbd_rt) -> RTISolution``: rti_phase=2, the gradient at the measured x0 and
      fresh contact bounds, then one QP solve.

    The solution's rollout is computed once and gives both the cost and the
    predicted state (the JAX package rolls out twice, to the same numbers)."""
    device = resolve_device(device)
    dims = OCPDims(horizon=cfg.mpc.horizon)
    H, nu = dims.horizon, dims.nu
    gp = cfg.mpc.gradient
    srbd = make_params(cfg, device=device)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    dts = dev(cfg.mpc.dts())
    q_diag, r_diag = dev(q_diag_gradient()), dev(r_diag_gradient(cfg.robot.name))
    Qw, Rw = q_diag.repeat(H), r_diag.repeat(H)
    C_single, _ = friction_cone_rows(cfg.mpc.mu, cfg.mpc.grf_min, cfg.mpc.grf_max,
                                     torch.ones(4, H), dims)
    C_big = dev(np.kron(np.eye(H, dtype=np.float32), C_single[0].numpy()))  # (24H, 12H)
    lm_eye = gp.levenberg_marquardt * torch.eye(H * nu, device=device)
    diag_R = torch.diag(Rw)
    qp_fn, iters = qp_solver_for(gp, device)
    sqp_iters = sqp_iterations(gp)

    def _linearize_condense(x_lin, Ubar, feet_traj, contact_seq, wrench, p):
        """Preparation-phase work: rollout + Jacobians + condensing + Hessian."""
        xbar = rollout_nominal(x_lin, Ubar, feet_traj, contact_seq, p, dts, integrator, wrench)
        lin = linearize_dynamics(xbar, Ubar, feet_traj, contact_seq, p, dts, integrator, wrench)
        Fm, Gm = condense(lin, dims)
        Gt = input_operator(Gm)
        Hm = (Gt * Qw) @ Gt.transpose(-1, -2) + diag_R + lm_eye
        return PrepState(xbar, Ubar, Fm, Gt, Hm)

    def _gradient(prep: PrepState, x0, Xref, Uref):
        dx0 = x0 - prep.xbar[:, 0]
        e = prep.xbar[:, 1:] + torch.einsum("bkij,bj->bki", prep.Fm, dx0) - Xref
        B = x0.shape[0]
        return ((prep.Gt @ (Qw * e.reshape(B, -1))[..., None])[..., 0]
                + Rw * (prep.Ubar - Uref).reshape(B, -1))

    def _d_shift(contact_seq, Ubar):
        """Cone bounds (B, 24H) on z = U - Ubar."""
        d = friction_cone_bounds(cfg.mpc.grf_min, cfg.mpc.grf_max, contact_seq,
                                 stance_min_force=gp.stance_min_force)
        B = Ubar.shape[0]
        return d.reshape(B, -1) - (C_big @ Ubar.reshape(B, -1, 1))[..., 0]

    def _feedback_step(prep: PrepState, x0, contact_seq, Xref, Uref):
        """Feedback-phase work: gradient refresh at the measured x0 + IP solve."""
        g = _gradient(prep, x0, Xref, Uref)
        d = _d_shift(contact_seq, prep.Ubar)
        sol = qp_fn(prep.Hm, g, C_big.expand(x0.shape[0], -1, -1), d, iters=iters)
        return prep.Ubar + sol.z.reshape(prep.Ubar.shape), sol

    def _result(x0, U, sol, feet_traj, contact_seq, Xref, Uref, wrench, p):
        xs = rollout_nominal(x0, U, feet_traj, contact_seq, p, dts, integrator, wrench)
        ex, eu = xs[:, 1:] - Xref, U - Uref
        cost = (ex * ex * q_diag).sum((-1, -2)) + (eu * eu * r_diag).sum((-1, -2))
        return RTISolution(U, U[:, 0].reshape(-1, 4, 3), xs[:, 1], cost, sol.gap,
                           sol.primal_res)

    def _defaults(x0, ext_wrench, srbd_rt):
        wrench = x0.new_zeros((x0.shape[0], H, 6)) if ext_wrench is None else ext_wrench
        return wrench, (srbd if srbd_rt is None else srbd_rt)

    def solve(x0, feet_traj, contact_seq, Xref, Uref, U_warm, ext_wrench=None, srbd_rt=None):
        wrench, p = _defaults(x0, ext_wrench, srbd_rt)
        U = U_warm
        for _ in range(sqp_iters):
            prep = _linearize_condense(x0, U, feet_traj, contact_seq, wrench, p)
            U, sol = _feedback_step(prep, x0, contact_seq, Xref, Uref)
        return _result(x0, U, sol, feet_traj, contact_seq, Xref, Uref, wrench, p)

    def prepare(x_pred, feet_traj, contact_seq, Xref, Uref, U_warm, ext_wrench=None,
                srbd_rt=None):
        wrench, p = _defaults(x_pred, ext_wrench, srbd_rt)
        U = U_warm
        # AS-RTI-A..D: the extra approximate iterations refine the linearization point.
        for _ in range(sqp_iters - 1):
            prep = _linearize_condense(x_pred, U, feet_traj, contact_seq, wrench, p)
            U, _ = _feedback_step(prep, x_pred, contact_seq, Xref, Uref)
        return _linearize_condense(x_pred, U, feet_traj, contact_seq, wrench, p)

    def feedback(prep: PrepState, x0, feet_traj, contact_seq, Xref, Uref, ext_wrench=None,
                 srbd_rt=None):
        wrench, p = _defaults(x0, ext_wrench, srbd_rt)
        U, sol = _feedback_step(prep, x0, contact_seq, Xref, Uref)
        return _result(x0, U, sol, feet_traj, contact_seq, Xref, Uref, wrench, p)

    if not return_assembler:
        return solve, prepare, feedback, dims

    def assemble_qp(x0, feet_traj, contact_seq, Xref, Uref, U_warm):
        wrench, p = _defaults(x0, None, None)
        prep = _linearize_condense(x0, U_warm, feet_traj, contact_seq, wrench, p)
        g = _gradient(prep, x0, Xref, Uref)
        return prep.Hm, g, C_big.expand(x0.shape[0], -1, -1), _d_shift(contact_seq, U_warm)

    return solve, prepare, feedback, dims, assemble_qp


class TickLayout:
    """Flat float32 layouts of a tick's inputs and of its result, so a tick moves
    one buffer each way. Inputs: x0 (12), feet_traj (H, 4, 3), contact_seq (4, H),
    Xref, Uref, U_warm (H, 12), wrench (H, 6), mass (1), inertia, inertia_inv (3,
    3). Result: U (H, 12), GRFs (12), predicted state (12), cost, QP gap, QP
    residual."""

    def __init__(self, H: int):
        self.H = H
        shapes = (("x0", (12,)), ("feet_traj", (H, 4, 3)), ("seq", (4, H)), ("Xref", (H, 12)),
                  ("Uref", (H, 12)), ("U_warm", (H, 12)), ("wrench", (H, 6)), ("mass", ()),
                  ("inertia", (3, 3)), ("inertia_inv", (3, 3)))
        self.inputs, o = {}, 0
        for name, shape in shapes:
            n = int(np.prod(shape, dtype=np.int64))
            self.inputs[name] = (o, o + n, shape)
            o += n
        self.n_in = o
        self.n_out = 12 * H + 27

    def pack(self, B, **arrays) -> np.ndarray:
        """(B, n_in) from the named arrays, each (B, *shape) or (*shape) (shared)."""
        flat = np.empty((B, self.n_in), np.float32)
        for name, (a, b, shape) in self.inputs.items():
            flat[:, a:b] = np.broadcast_to(np.asarray(arrays[name], np.float32),
                                           (B,) + shape).reshape(B, b - a)
        return flat

    def unpack(self, flat: torch.Tensor, gravity: torch.Tensor):
        B = flat.shape[0]

        def take(name):
            a, b, shape = self.inputs[name]
            return flat[:, a:b].reshape((B,) + shape)

        p = SRBDParams(mass=take("mass"), inertia=take("inertia"),
                       inertia_inv=take("inertia_inv"), gravity=gravity)
        return (take("x0"), take("feet_traj"), take("seq"), take("Xref"), take("Uref"),
                take("U_warm"), take("wrench"), p)

    @staticmethod
    def pack_result(sol: RTISolution) -> torch.Tensor:
        B = sol.U.shape[0]
        return torch.cat([sol.U.reshape(B, -1), sol.grfs.reshape(B, 12), sol.predicted_state,
                          sol.cost[:, None], sol.qp_gap[:, None], sol.qp_primal_res[:, None]],
                         dim=-1)

    def unpack_result(self, out: np.ndarray) -> RTISolution:
        H = self.H
        return RTISolution(U=out[:, :12 * H].reshape(-1, H, 12),
                           grfs=out[:, 12 * H:12 * H + 12].reshape(-1, 4, 3),
                           predicted_state=out[:, 12 * H + 12:12 * H + 24],
                           cost=out[:, 12 * H + 24], qp_gap=out[:, 12 * H + 25],
                           qp_primal_res=out[:, 12 * H + 26])


def _state_vector(state) -> np.ndarray:
    return np.concatenate([np.asarray(state["position"]).reshape(3),
                           np.asarray(state["linear_velocity"]).reshape(3),
                           np.asarray(state["orientation"]).reshape(3),
                           np.asarray(state["angular_velocity"]).reshape(3)])


class HostIO:
    """Pinned host buffers per call site and the one device-to-host copy of a
    tick's flat result (``self.device``, ``self._host`` a dict)."""

    def _buffer(self, name, shape) -> torch.Tensor:
        """A host float32 buffer per call site and shape, pinned on a CUDA device."""
        key = (name, tuple(shape))
        buf = self._host.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
            self._host[key] = buf
        return buf

    def _to_host(self, out: torch.Tensor) -> np.ndarray:
        """The tick's one device-to-host copy, of the flat result, as a numpy copy."""
        if out.is_cuda:
            host = self._buffer("out", out.shape)
            host.copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            ready.synchronize()
            out = host
        return out.numpy().copy()


class GradientMPC(HostIO):
    """Host-facing nominal gradient MPC (counterpart of Acados_NMPC_Nominal).

    ``compute_control`` takes the reference's state/reference dict schema
    (wb_interface.py:152-166, :275-291) and returns (first-stage GRFs, footholds,
    one-step predicted state, status, cost), with warm starting, integral action and
    the failure fallback. ``solve``, ``prepare`` and ``feedback`` take host arrays,
    as the JAX package's jitted functions do; a batch leads each array when
    ``feet_traj`` is (B, H, 4, 3). ``U_warm``, ``previous_grfs`` and ``integral``
    are host numpy (``interop.set_gradient_state``)."""

    def __init__(self, cfg: Config, integrator: str = "euler", device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.mpc.gradient.use_DDP:
            # The DDP nlp-solver option: a Riccati backward pass and a projected
            # forward rollout instead of the condensed QP; no prepare/feedback split.
            from .ddp import make_ddp_solver
            solve, self.dims = make_ddp_solver(cfg, integrator, device=self.device)
            prepare = feedback = None
        else:
            solve, prepare, feedback, self.dims = make_rti_solver_split(cfg, integrator,
                                                                        device=self.device)
        H = self.dims.horizon
        self.layout = lay = TickLayout(H)
        self.static_params = make_params(cfg)
        gravity = make_params(cfg, device=self.device).gravity

        def to_dev(flat):
            return flat.to(self.device, non_blocking=True)

        def solve_flat(flat):
            return lay.pack_result(solve(*lay.unpack(to_dev(flat), gravity)))

        def prepare_flat(flat):
            return tuple(prepare(*lay.unpack(to_dev(flat), gravity)))

        def feedback_flat(xbar, Ubar, Fm, Gt, Hm, flat):
            x0, feet, seq, Xref, Uref, _, wrench, p = lay.unpack(to_dev(flat), gravity)
            return lay.pack_result(feedback(PrepState(xbar, Ubar, Fm, Gt, Hm), x0, feet, seq,
                                            Xref, Uref, wrench, p))

        # On a CUDA device each phase replays its captured graph; on the CPU it runs
        # eagerly (the graph's plain version).
        self._solve_dev = GraphedFunction(solve_flat, self.device)
        self._prepare_dev = self._feedback_dev = None
        if prepare is not None:
            self._prepare_dev = GraphedFunction(prepare_flat, self.device)
            self._feedback_dev = GraphedFunction(feedback_flat, self.device)
        self._host = {}
        self.U_warm = np.zeros((H, 12), np.float32)
        self.previous_grfs = np.zeros((4, 3), np.float32)
        self.integral = np.zeros(6, np.float32)
        # RTI split state: _prep holds the device PrepState that compute_rti_prepare
        # dispatched (never waited on); _last the tick inputs it linearizes against.
        self._prep = None
        self._last = None

    # -- device calls ---------------------------------------------------------
    def _inputs(self, name, x0, feet_traj, seq, Xref, Uref, U_warm, wrench, srbd_rt):
        feet_traj = np.asarray(feet_traj, np.float32)
        B = feet_traj.shape[0] if feet_traj.ndim == 4 else 1
        p = self.static_params if srbd_rt is None else srbd_rt
        flat = self.layout.pack(
            B, x0=x0, feet_traj=feet_traj, seq=seq, Xref=Xref, Uref=Uref,
            U_warm=np.zeros(12, np.float32) if U_warm is None else U_warm,
            wrench=np.zeros(6, np.float32) if wrench is None else wrench,
            mass=np.asarray(p.mass), inertia=np.asarray(p.inertia),
            inertia_inv=np.asarray(p.inertia_inv))
        buf = self._buffer(name, flat.shape)
        buf.numpy()[:] = flat
        return buf, feet_traj.ndim == 4

    def _fetch(self, out: torch.Tensor, batched: bool) -> RTISolution:
        sol = self.layout.unpack_result(self._to_host(out))
        return sol if batched else RTISolution(*(x[0] for x in sol))

    def solve(self, x0, feet_traj, seq, Xref, Uref, U_warm, wrench=None, srbd_rt=None):
        buf, batched = self._inputs("solve", x0, feet_traj, seq, Xref, Uref, U_warm, wrench,
                                    srbd_rt)
        return self._fetch(self._solve_dev(buf), batched)

    def prepare(self, x_pred, feet_traj, seq, Xref, Uref, U_warm, wrench=None, srbd_rt=None):
        """Dispatch the preparation phase; returns its device PrepState without
        waiting for it."""
        buf, _ = self._inputs("prepare", x_pred, feet_traj, seq, Xref, Uref, U_warm, wrench,
                              srbd_rt)
        return PrepState(*self._prepare_dev(buf))

    def feedback(self, prep: PrepState, x0, feet_traj, seq, Xref, Uref, wrench=None,
                 srbd_rt=None):
        buf, batched = self._inputs("feedback", x0, feet_traj, seq, Xref, Uref, None, wrench,
                                    srbd_rt)
        return self._fetch(self._feedback_dev(*prep, buf), batched)

    # -- reference assembly -------------------------------------------------
    def _build_refs(self, state, reference, contact_seq, commit_integral=True):
        cfg = self.cfg
        H = self.dims.horizon
        xref1 = np.concatenate([
            np.asarray(reference["ref_position"]).reshape(3),
            np.asarray(reference["ref_linear_velocity"]).reshape(3),
            np.asarray(reference["ref_orientation"]).reshape(3),
            np.asarray(reference["ref_angular_velocity"]).reshape(3)]).astype(np.float32)

        if cfg.mpc.gradient.use_integrators:
            # Integral action with the reference's alpha and caps (config.py:111-113)
            # on (z, vx, vy, vz, roll, pitch). commit_integral=False leaves the stored
            # integral untouched: the batched gait optimizer evaluates K candidates a
            # tick and must not accumulate K times.
            err = _state_vector(state) - xref1
            sel = np.array([2, 3, 4, 5, 6, 7])
            alpha = cfg.mpc.gradient.alpha_integrator
            cap = np.asarray(cfg.mpc.gradient.integrator_cap)
            integral = np.clip(self.integral + err[sel] * alpha, -cap, cap)
            if commit_integral:
                self.integral = integral
            xref1 = xref1.copy()
            xref1[sel] -= integral

        Xref = np.tile(xref1, (H, 1))
        # Gravity-share z-force reference per stage (reference :1195-1210).
        seq = np.asarray(contact_seq, np.float32)
        n_st = np.maximum(seq.sum(axis=0), 1.0)
        share = cfg.robot.mass * cfg.gravity / n_st  # (H,)
        Uref = np.zeros((H, 12), np.float32)
        for leg in range(4):
            Uref[:, leg * 3 + 2] = share * seq[leg]
        return Xref, Uref

    def _build_inputs(self, state, reference, contact_seq):
        feet_now = np.stack([np.asarray(state[f"foot_{leg}"]).reshape(3) for leg in _LEGS])
        ref_feet = np.stack([np.asarray(reference[f"ref_foot_{leg}"]).reshape(-1, 3)
                             for leg in _LEGS])
        feet_traj = build_feet_trajectory(feet_now, ref_feet, contact_seq, self.dims.horizon)
        return _state_vector(state).astype(np.float32), np.asarray(feet_traj, np.float32)

    # -- main entry ---------------------------------------------------------
    def compute_control(self, state, reference, contact_sequence, constraint=None,
                        external_wrenches=None, inertia=None, mass=None):
        seq = np.asarray(contact_sequence, np.float32)[:, : self.dims.horizon]
        x0, feet_traj = self._build_inputs(state, reference, seq)
        Xref, Uref = self._build_refs(state, reference, seq)
        wrench = build_stage_wrench(self.cfg, external_wrenches, self.dims.horizon)
        # A fresh warm start seeds from the gravity-share reference: at f = 0 the SRB
        # torque balance has no force/foothold sensitivity (reference :1048-1113).
        U_ws = Uref if not np.any(self.U_warm) else self.U_warm
        srbd_rt = None
        if inertia is not None or mass is not None:
            # Runtime inertia/mass (use_inertia_recomputation) replace the static values.
            base = self.static_params
            I_rt = (np.asarray(inertia, np.float32) if inertia is not None
                    else base.inertia.numpy())
            srbd_rt = SRBDParams(
                mass=np.asarray(mass if mass is not None else base.mass.numpy(), np.float32),
                inertia=I_rt, inertia_inv=np.linalg.inv(I_rt).astype(np.float32),
                gravity=base.gravity)
        if self._prep is not None:
            # RTI feedback phase: the preparation's linearization, with the measured
            # x0 and the fresh contact bounds and references.
            out = self.feedback(self._prep, x0, feet_traj, seq, Xref, Uref, wrench, srbd_rt)
            self._prep = None
        else:
            out = self.solve(x0, feet_traj, seq, Xref, Uref, U_ws, wrench, srbd_rt)
        U = np.asarray(out.U)
        if not np.all(np.isfinite(U)):
            # Failure fallback (reference :1654-1685): previous GRFs, reset warm start.
            grfs = self.previous_grfs
            self.U_warm[:] = 0.0
            status = 1
            predicted = x0
            self._last = None  # never prepare against a failed iterate
        else:
            grfs = np.asarray(out.grfs) * seq[:, 0:1]
            self.previous_grfs = grfs.copy()
            # Shift the warm start one stage (RTI-style).
            self.U_warm = np.concatenate([U[1:], U[-1:]], axis=0)
            status = 0
            predicted = np.asarray(out.predicted_state)
            self._last = (feet_traj, seq, Xref, Uref, wrench, srbd_rt,
                          predicted.astype(np.float32))

        # First touch-down foothold per leg (where the foot stands after its first
        # in-horizon touch-down; its current position if there is none).
        fh = np.empty((4, 3), np.float32)
        for leg in range(4):
            fh[leg] = feet_traj[-1, leg]
            for k in range(1, self.dims.horizon):
                if seq[leg, k] == 1 and seq[leg, k - 1] == 0:
                    fh[leg] = feet_traj[k, leg]
                    break
        return grfs, fh, predicted, status, float(out.cost)

    def compute_rti_prepare(self, *args, **kwargs):
        """RTI preparation phase (reference srbd_controller_interface.py:242-245):
        linearize + condense + build the Hessian at the predicted next state from the
        just-shifted warm start. On the card it is dispatched without waiting, so it
        overlaps the plant step; the next compute_control consumes it."""
        if self._prepare_dev is None or not self.cfg.mpc.gradient.use_RTI or self._last is None:
            return None
        feet_traj, seq, Xref, Uref, wrench, srbd_rt, predicted = self._last
        self._prep = self.prepare(predicted, feet_traj, seq, Xref, Uref, self.U_warm, wrench,
                                  srbd_rt)
        return self._prep

    def reset(self):
        # Rebind (never zero in place): returned arrays may alias these.
        self.U_warm = np.zeros_like(self.U_warm)
        self.integral = np.zeros_like(self.integral)
        self.previous_grfs = np.zeros_like(self.previous_grfs)
        self._prep = None
        self._last = None


class BatchedGradientMPC:
    """Gait-adaptive batch: the K candidate step frequencies as one batched solve
    (B = K; counterpart of Acados_NMPC_GaitAdaptiveRS +
    SRBDBatchedControllerInterface, srbd_batched_controller_interface.py:32-80)."""

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.inner = GradientMPC(cfg, device=device)

    def optimize_gait(self, state, reference, contact_sequences):
        """contact_sequences: (K, 4, H), one per candidate frequency. Returns (costs,
        best_freq); the cost of candidate k carries the frequency penalty
        3 (f_k - f_0)^2 (centroidal_nmpc_gait_adaptive.py:1230-1242)."""
        cfg = self.cfg
        K = len(cfg.mpc.step_freq_available)
        seqs = np.asarray(contact_sequences, np.float32)[:, :, : self.inner.dims.horizon]
        feet, xrefs, urefs = [], [], []
        for k in range(K):
            x0, ft = self.inner._build_inputs(state, reference, seqs[k])
            # commit_integral=False: candidates leave the integral state alone.
            Xref, Uref = self.inner._build_refs(state, reference, seqs[k],
                                                commit_integral=False)
            feet.append(ft)
            xrefs.append(Xref)
            urefs.append(Uref)
        out = self.inner.solve(x0, np.stack(feet), seqs, xrefs[0], np.stack(urefs),
                               self.inner.U_warm)
        costs = np.array(out.cost)
        f0 = cfg.mpc.step_freq_available[0]
        for k in range(1, K):
            costs[k] += 3 * (cfg.mpc.step_freq_available[k] - f0) ** 2
        best = int(np.argmin(costs))
        return costs, cfg.mpc.step_freq_available[best]
