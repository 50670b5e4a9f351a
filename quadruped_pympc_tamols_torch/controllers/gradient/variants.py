"""Gradient-MPC variant family on a generalized augmented-state RTI core, in torch.

Counterpart of ``quadruped_pympc_tamols_tpu/controllers/gradient/variants.py``.
Each variant declares (a) its augmented discrete dynamics on top of the shared SRB
``fd``, (b) cost diagonals and references and (c) a stage inequality residual
c(x, u) <= 0:

* nominal, with the optional support-polygon stability rows (the trot/pace band
  or the crawl's six half-planes; static or ZMP support point), and its full
  form with on-line foothold optimization (``use_foothold_optimization``);
* input_rates (GRFs in the state, GRF rates as inputs);
* lyapunov (transverse states z1/z2, adaptive phi, V_dot <= 0 and a residual
  bound);
* collaborative (a passive-arm wrench state);
* kinodynamic (12 joint positions in the state, joint velocities and GRFs as
  inputs, feet from the leg FK, stance-foot velocity rows).

One Gauss-Newton RTI core linearizes dynamics and constraints with
``torch.func.jacfwd`` under ``torch.func.vmap`` over the stages, condenses to a
dense QP over the input sequence (``ocp.condense``; state rows map through the
prediction operator) and solves it with the interior point of ``qp.py`` (soft
rows through ``qp.soft_qp_solve``). The spec functions take one stage's
unbatched tensors; the solve is one problem. ``VariantGradientMPC`` packs a
tick's host inputs into one flat buffer and, on a CUDA device, replays the solve
from one captured CUDA graph (``utils/graphs.py``) with one device-to-host copy
of one flat result a tick; on the CPU the same function runs eagerly.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from ...config import Config, GaitType
from ...dynamics.srbd import SRBDParams, fd, make_params
from ...kinematics.leg_ik import SIDE_SIGN, LegKinematics
from ...utils.device import resolve_device
from ...utils.frames import euler_xyz_to_rot, euler_xyz_to_rot_np, world_to_body_rot
from ...utils.graphs import GraphedFunction
from .ocp import (Linearization, OCPDims, build_feet_trajectory, condense, input_operator,
                  q_diag_gradient, r_diag_gradient)
from .qp import soft_qp_solve
from .sqp import _LEGS, HostIO, _state_vector, build_stage_wrench, qp_solver_for

_jacfwd, _vmap = torch.func.jacfwd, torch.func.vmap


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """Static description of one gradient-MPC variant."""

    name: str
    nx: int  # augmented state dimension (first 12 = base state)
    nu: int
    # dynamics(x_aug, u, feet, contact, dt, wrench6) -> x_aug_next (discrete);
    # wrench6 is the per-stage external [force, torque] estimate (world frame)
    dynamics: Callable
    # stage_ineq(x_aug, u, contact, fz_max, feet, k) -> residual c <= 0 (fixed
    # length); k is the stage index (for stage-dependent bounds)
    stage_ineq: Callable
    n_ineq: int
    q_diag: np.ndarray  # (nx,)
    r_diag: np.ndarray  # (nu,)
    # grfs(u, x_aug) -> (12,) force vector applied at the feet
    grfs_of: Callable
    # Levenberg-Marquardt scale: rate-scale inputs (O(1000 N/s)) need the base lm
    # (tuned for O(100 N) forces) shrunk.
    lm_scale: float = 1.0
    # Per-stage soft-constraint mask (n_ineq,): True rows get L1/L2 slack penalties
    # (acados zl/Zl soft h-constraints). None = all rows hard.
    soft_mask: np.ndarray | None = None


def _dev(device):
    return lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)


def _add_wrench(d, x, wk, srbd: SRBDParams):
    """Add a world-frame external [force, torque] to the SRB state derivative."""
    tau_b = world_to_body_rot(x[6:9]) @ wk[3:]
    return torch.cat([d[0:3], d[3:6] + wk[:3] / srbd.mass, d[6:9],
                      d[9:12] + srbd.inertia_inv @ tau_b])


def _cone_residual(f12, contact, fz_max, mu, grf_min, stance_min: float = 0.0):
    """Friction-cone and fz-bound residuals of a 12-vector of GRFs: 6 rows a leg.
    ``stance_min`` raises the fz lower bound of stance legs only."""
    f = f12.reshape(4, 3)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    rows = torch.stack([grf_min + stance_min * contact - fz, fz - fz_max, fx - mu * fz,
                        -fx - mu * fz, fy - mu * fz, -fy - mu * fz], dim=-1)
    return rows.reshape(24)


def _legs3(v4):
    """(4,) -> (12,): each leg's value repeated for its three components."""
    return v4[:, None].expand(4, 3).reshape(12)


def _dot(a, b):
    return (a * b).sum(-1)


def _clip01(t):
    # jnp.clip is minimum(maximum(.)), whose derivative splits 0.5/0.5 at a tie;
    # torch.clamp would pass it whole. The stability rows are differentiated.
    return torch.minimum(torch.maximum(t, torch.zeros_like(t)), torch.ones_like(t))


# ---------------------------------------------------------------------------
def make_input_rates_spec(cfg: Config, srbd: SRBDParams) -> VariantSpec:
    """GRFs in the state, inputs are GRF rates (reference input_rates family)."""
    mu, grf_min = cfg.mpc.mu, cfg.mpc.grf_min
    smf = cfg.mpc.gradient.stance_min_force
    q = np.concatenate([q_diag_gradient(), r_diag_gradient(cfg.robot.name)])  # force states
    # Rate cost: stance transitions need O(1e3 N/s) ramps, so rate^2 * r stays well
    # below the state-error terms.
    r = np.full(12, 1e-5, dtype=np.float32)

    def dynamics(x, u, feet, contact, dt, wk):
        base, f = x[:12], x[12:]
        d = _add_wrench(fd(base, feet, f.reshape(4, 3), contact, srbd), base, wk, srbd)
        return torch.cat([base + dt * d, f + dt * u])

    def stage_ineq(x, u, contact, fz_max, feet, k):
        return _cone_residual(x[12:], contact, fz_max, mu, grf_min, smf)

    return VariantSpec("input_rates", 24, 12, dynamics, stage_ineq, 24, q, r,
                       grfs_of=lambda u, x: x[12:], lm_scale=1e-3)


def make_collaborative_spec(cfg: Config, srbd: SRBDParams,
                            arm_stiffness=(30.0, 30.0, 0.0)) -> VariantSpec:
    """SRB + passive-arm wrench state (reference collaborative family): the arm's
    linear x/y components follow -K_bar v_base_xy, its angular z component
    -K_yaw omega_z. With passive_arm_compensation the predicted wrench state
    enters the dynamics; without it the stage wrench estimate does."""
    mu, grf_min = cfg.mpc.mu, cfg.mpc.grf_min
    smf = cfg.mpc.gradient.stance_min_force
    Kx, Ky, _ = arm_stiffness
    K_yaw = 5.0
    passive_arm = cfg.mpc.gradient.passive_arm_compensation
    q = np.concatenate([q_diag_gradient(), np.zeros(6, np.float32)])
    r = r_diag_gradient(cfg.robot.name)

    def dynamics(x, u, feet, contact, dt, wk):
        base, w_arm = x[:12], x[12:]
        d = fd(base, feet, u.reshape(4, 3), contact, srbd)
        if passive_arm:
            d = torch.cat([d[0:3], d[3:6] + w_arm[:3] / srbd.mass, d[6:9],
                           d[9:12] + srbd.inertia_inv @ w_arm[3:]])
        else:
            d = _add_wrench(d, base, wk, srbd)
        zero = torch.zeros_like(base[0])
        w_dot = torch.stack([-Kx * base[3], -Ky * base[4], zero, zero, zero, -K_yaw * base[11]])
        return torch.cat([base + dt * d, w_arm + dt * w_dot])

    def stage_ineq(x, u, contact, fz_max, feet, k):
        return _cone_residual(u, contact, fz_max, mu, grf_min, smf)

    return VariantSpec("collaborative", 18, 12, dynamics, stage_ineq, 24, q, r,
                       grfs_of=lambda u, x: u)


def make_lyapunov_spec(cfg: Config, srbd: SRBDParams) -> VariantSpec:
    """SRB + transverse states z1/z2 + adaptive phi, with the V_dot <= 0 and
    eta^T eta <= ub constraints (reference lyapunov family)."""
    gp = cfg.mpc.gradient
    mu, grf_min = cfg.mpc.mu, cfg.mpc.grf_min
    smf = gp.stance_min_force
    dev = _dev(srbd.mass.device)
    K1, K2 = dev(gp.K_z1), dev(gp.K_z2)
    ub_res = gp.residual_dynamics_upper_bound
    g_vec = dev([0.0, 0.0, -cfg.gravity])
    q = np.concatenate([q_diag_gradient(), np.zeros(9, np.float32)])
    r = r_diag_gradient(cfg.robot.name)
    use_decay = gp.use_residual_dynamics_decay

    def _f_star(z1, z2, phi):
        # F* = m(-(K1+K2) z2 + K1^2 z1 - g) - phi (model :216-237)
        return srbd.mass * (-(K1 + K2) * z2 + K1 * K1 * z1 - g_vec) - phi

    def dynamics(x, u, feet, contact, dt, wk):
        base, z1, z2, phi = x[:12], x[12:15], x[15:18], x[18:21]
        f = u.reshape(4, 3)
        F_star = _f_star(z1, z2, phi)
        n_st = torch.clamp_min(contact.sum(), 1.0)
        # The stabilizing force redistributed to the stance legs (model :240-245).
        f_final = (f + F_star[None, :] / n_st) * contact[:, None]
        d = fd(base, feet, f_final, torch.ones_like(contact), srbd)
        d = torch.cat([d[0:3], d[3:6] - phi, d[6:12]])  # linear_com_acc - phi (:262)
        d = _add_wrench(d, base, wk, srbd)
        F_delta = (f * contact[:, None]).sum(0)
        z1_dot = -K1 * z1 + z2
        z2_dot = -K2 * z2 + (F_delta + F_star) / srbd.mass + g_vec + phi
        return torch.cat([base + dt * d, z1 + dt * z1_dot, z2 + dt * z2_dot, phi + dt * -z2])

    def stage_ineq(x, u, contact, fz_max, feet, k):
        cone = _cone_residual(u, contact, fz_max, mu, grf_min, smf)
        z1, z2 = x[12:15], x[15:18]
        F_delta = (u.reshape(4, 3) * contact[:, None]).sum(0)
        v_dot = (-_dot(z1, K1 * z1) - _dot(z2, K2 * z2) + _dot(z1, z2)
                 + _dot(z2, F_delta) / srbd.mass)  # V_dot <= 0 (controller :299-328)
        # eta^T eta <= ub, eta = (rpy, omega); with use_residual_dynamics_decay the
        # bound tightens 1/(k+1) along the horizon.
        ub_k = ub_res / (k + 1.0) if use_decay else ub_res
        eta = x[6:12]
        return torch.cat([cone, v_dot[None], (_dot(eta, eta) - ub_k)[None]])

    return VariantSpec("lyapunov", 21, 12, dynamics, stage_ineq, 26, q, r,
                       grfs_of=lambda u, x: u)


def make_kinodynamic_spec(cfg: Config, srbd: SRBDParams) -> VariantSpec:
    """SRB + joints (reference kinodynamic family): states add 12 joint positions,
    inputs are 12 joint velocities + 12 GRFs; the feet come from the leg FK
    (``LegKinematics.fk`` on tensors) instead of stage parameters, and stance
    feet get world-velocity rows, whose foot Jacobians are ``jacfwd`` inside
    ``stage_ineq`` (the solver differentiates them again)."""
    kin = LegKinematics(cfg.robot)
    mu, grf_min = cfg.mpc.mu, cfg.mpc.grf_min
    smf = cfg.mpc.gradient.stance_min_force
    dev = _dev(srbd.mass.device)
    side, hip_off = dev(SIDE_SIGN), dev(kin.hip_offsets_b)
    q = np.concatenate([q_diag_gradient(), np.full(12, 10.0, np.float32)])
    r = np.concatenate([np.full(12, 1e-3, np.float32),  # joint velocity cost
                        r_diag_gradient(cfg.robot.name)])

    def feet_world(base_pos, rpy, q12):
        R = euler_xyz_to_rot(rpy)
        p_hip = kin.fk(q12.reshape(4, 3), side)  # (4, 3) hip frame
        return base_pos + (hip_off + p_hip) @ R.T

    def dynamics(x, u, feet_unused, contact, dt, wk):
        base, q12 = x[:12], x[12:]
        qd, grf = u[:12], u[12:]
        feet = feet_world(base[0:3], base[6:9], q12)
        d = _add_wrench(fd(base, feet, grf.reshape(4, 3), contact, srbd), base, wk, srbd)
        return torch.cat([base + dt * d, q12 + dt * qd])

    def stage_ineq(x, u, contact, fz_max, feet_unused, k):
        qd, grf = u[:12], u[12:]
        cone = _cone_residual(grf, contact, fz_max, mu, grf_min, smf)
        # Stance-foot world velocity ~ 0: v = d(feet)/dt along the trajectory.
        base, q12 = x[:12], x[12:]

        def feet_flat(bp, rpy, qq):
            return feet_world(bp, rpy, qq).reshape(-1)

        Jq = _jacfwd(lambda qq: feet_flat(base[0:3], base[6:9], qq))(q12)
        Jp = _jacfwd(lambda bp: feet_flat(bp, base[6:9], q12))(base[0:3])
        Jr = _jacfwd(lambda rr: feet_flat(base[0:3], rr, q12))(base[6:9])
        v_feet = Jq @ qd + Jp @ base[3:6] + Jr @ x[9:12]  # omega ~ rpy rates, first order
        relax = (1.0 - _legs3(contact)) * 100.0 + 0.05
        return torch.cat([cone, v_feet - relax, -v_feet - relax])

    return VariantSpec("kinodynamic", 24, 24, dynamics, stage_ineq, 48, q, r,
                       grfs_of=lambda u, x: u[12:])


def make_foothold_spec(cfg: Config, srbd: SRBDParams) -> VariantSpec:
    """Nominal SRB with on-line foothold optimization (the reference nominal OCP's
    full form, use_foothold_optimization): 12 foot-position states, 12 foot
    velocity inputs gated by (1 - stance)(1 - stance proximity), so stance feet
    are pinned and swing feet settle on the optimized touchdown. The per-stage
    feet array is (4, 4): columns 0:3 the reference foothold (box centers),
    column 3 the stance-proximity flag (1 on the last swing stage before a
    touch-down). With use_foothold_constraints the foot xy states are boxed
    around the reference foothold; the stability rows use the optimized feet."""
    gp = cfg.mpc.gradient
    mu, grf_min = cfg.mpc.mu, cfg.mpc.grf_min
    smf = gp.stance_min_force
    hw_x, hw_y = gp.foothold_box_halfwidth
    use_stab = gp.use_static_stability or gp.use_zmp_stability
    support_residual, n_stab = make_support_residual(cfg, srbd)
    q = np.concatenate([q_diag_gradient(), np.full(12, 300.0, np.float32)])
    r = np.concatenate([np.full(12, 1e-4, np.float32),  # foot velocity cost
                        r_diag_gradient(cfg.robot.name)])

    def dynamics(x, u, feet_aux, contact, dt, wk):
        base, feet12 = x[:12], x[12:]
        v_feet, grf = u[:12], u[12:]
        d = fd(base, feet12.reshape(4, 3), grf.reshape(4, 3), contact, srbd)
        d = _add_wrench(d, base, wk, srbd)
        gate = _legs3((1.0 - contact) * (1.0 - feet_aux[:, 3]))
        return torch.cat([base + dt * d, feet12 + dt * gate * v_feet])

    def stage_ineq(x, u, contact, fz_max, feet_aux, k):
        feet_ref = feet_aux[:, :3]
        rows = [_cone_residual(u[12:], contact, fz_max, mu, grf_min, smf)]
        if gp.use_foothold_constraints:
            feet = x[12:].reshape(4, 3)
            dx = feet[:, 0] - feet_ref[:, 0]
            dy = feet[:, 1] - feet_ref[:, 1]
            rows.append(torch.cat([dx - hw_x, -dx - hw_x, dy - hw_y, -dy - hw_y]))
        if use_stab:
            rows.append(support_residual(x[:12], u[12:], contact, x[12:].reshape(4, 3)))
        return torch.cat(rows)

    n_ineq = 24 + (16 if gp.use_foothold_constraints else 0) + (n_stab if use_stab else 0)
    # Foothold-box and stability rows are soft (acados slacks them, zl/Zl =
    # 1000/1, centroidal_nmpc_nominal.py:147-163); the friction cones stay hard.
    soft = np.zeros(n_ineq, bool)
    soft[24:] = True
    return VariantSpec("foothold", 24, 24, dynamics, stage_ineq, n_ineq, q, r,
                       grfs_of=lambda u, x: u[12:], soft_mask=soft if n_ineq > 24 else None)


def make_support_residual(cfg: Config, srbd: SRBDParams):
    """Support-polygon stability residuals (reference
    centroidal_nmpc_nominal.py:277-381, :880-985). The support point is the CoM xy
    (use_static_stability) or the ZMP approximation com_xy - (com_z / g) a_xy with
    a_xy = sum(c_i f_xy,i) / m (use_zmp_stability). By gait type:

    * trot/pace/bound, one row: in 2-stance phases the support point stays within
      ``margin`` of the stance segment (the reference's two-sided band);
    * crawl gaits, six rows, one per foot pair (4 perimeter edges + 2 diagonals):
      in 3-stance phases the support point sits at least ``margin`` inside each
      edge of the stance triangle ("inside" = the stance centroid's side).

    Full stance deactivates every row. Returns ``(residual_fn, n_rows)`` with
    ``residual_fn(x, grf12, contact, feet) -> (n_rows,)`` (<= 0 when satisfied)."""
    gp = cfg.mpc.gradient
    gait = int(cfg.gait_params.gait_type)
    crawl_like = gait in (int(GaitType.CIRCULARCRAWL), int(GaitType.BFDIAGONALCRAWL),
                          int(GaitType.BACKDIAGONALCRAWL), int(GaitType.FRONTDIAGONALCRAWL),
                          int(GaitType.REGISTERCRAWL))
    margin = {0: gp.trot_stability_margin, 1: gp.pace_stability_margin}.get(
        gait, gp.crawl_stability_margin)
    m_robot = float(srbd.mass)
    grav = float(srbd.gravity)

    def support_point(x, grf12, contact):
        p = x[0:2]
        if gp.use_zmp_stability:
            a_xy = (grf12.reshape(4, 3)[:, :2] * contact[:, None]).sum(0) / m_robot
            p = p - (x[2] / grav) * a_xy
        return p

    if crawl_like:
        # FL-FR, FR-RR, RR-RL, RL-FL perimeter + FL-RR, FR-RL diagonals.
        pairs = ((0, 1), (1, 3), (3, 2), (2, 0), (0, 3), (1, 2))

        def residual(x, grf12, contact, feet):
            p = support_point(x, grf12, contact)
            n_st = contact.sum()
            cen = (feet[:, :2] * contact[:, None]).sum(0) / torch.clamp_min(n_st, 1.0)
            three_stance = (n_st > 2.5) & (n_st < 3.5)
            rows = []
            for i, j in pairs:
                a, b = feet[i, :2], feet[j, :2]
                e = b - a
                nvec = torch.stack([-e[1], e[0]]) / torch.clamp_min(torch.sqrt(_dot(e, e)), 1e-6)
                sd_p = _dot(nvec, p - a)
                # "Inside" toward the stance centroid; the sign carries no gradient,
                # so each row linearizes as a fixed half-plane.
                sgn = torch.where(_dot(nvec, cen - a) >= 0.0, 1.0, -1.0)
                act = (contact[i] * contact[j] > 0.5) & three_stance
                rows.append(torch.where(act, margin - sgn * sd_p, -1.0))
            return torch.stack(rows)

        return residual, len(pairs)

    def residual(x, grf12, contact, feet):
        p = support_point(x, grf12, contact)

        def seg_dist(i, j):
            a, b = feet[i, :2], feet[j, :2]
            v = b - a
            t = _clip01(_dot(p - a, v) / torch.clamp_min(_dot(v, v), 1e-9))
            d = p - (a + t * v)
            return torch.sqrt(_dot(d, d) + 1e-12)

        c = contact
        pair_masks = ((0, 3, c[0] * c[3] * (1 - c[1]) * (1 - c[2])),
                      (1, 2, c[1] * c[2] * (1 - c[0]) * (1 - c[3])),
                      (0, 2, c[0] * c[2] * (1 - c[1]) * (1 - c[3])),
                      (1, 3, c[1] * c[3] * (1 - c[0]) * (1 - c[2])),
                      (0, 1, c[0] * c[1] * (1 - c[2]) * (1 - c[3])),
                      (2, 3, c[2] * c[3] * (1 - c[0]) * (1 - c[1])))
        res = torch.full_like(p[0], -1.0)  # inactive by default (3+ stance feet)
        for i, j, mask in pair_masks:
            res = torch.where(mask > 0.5, seg_dist(i, j) - margin, res)
        return res[None]

    return residual, 1


def make_nominal_spec(cfg: Config, srbd: SRBDParams) -> VariantSpec:
    """Plain SRB nominal OCP on the generalized core, with the optional soft
    support-polygon stability rows (see make_support_residual)."""
    gp = cfg.mpc.gradient
    mu, grf_min = cfg.mpc.mu, cfg.mpc.grf_min
    smf = gp.stance_min_force
    use_stab = gp.use_static_stability or gp.use_zmp_stability
    support_residual, n_stab = make_support_residual(cfg, srbd)

    def dynamics(x, u, feet, contact, dt, wk):
        d = fd(x, feet, u.reshape(4, 3), contact, srbd)
        return x + dt * _add_wrench(d, x, wk, srbd)

    def stage_ineq(x, u, contact, fz_max, feet, k):
        cone = _cone_residual(u, contact, fz_max, mu, grf_min, smf)
        if not use_stab:
            return cone
        return torch.cat([cone, support_residual(x, u, contact, feet)])

    n_ineq = 24 + (n_stab if use_stab else 0)
    soft = None
    if use_stab:
        soft = np.zeros(n_ineq, bool)
        soft[24:] = True
    return VariantSpec("nominal", 12, 12, dynamics, stage_ineq, n_ineq, q_diag_gradient(),
                       r_diag_gradient(cfg.robot.name), grfs_of=lambda u, x: u,
                       soft_mask=soft)


SPEC_BUILDERS = {"input_rates": make_input_rates_spec, "collaborative": make_collaborative_spec,
                 "lyapunov": make_lyapunov_spec, "kinodynamic": make_kinodynamic_spec}


def make_spec(cfg: Config, variant: str, srbd: SRBDParams) -> VariantSpec:
    """The spec ``VariantGradientMPC(cfg, variant)`` solves."""
    if variant == "nominal":
        return (make_foothold_spec if cfg.mpc.gradient.use_foothold_optimization
                else make_nominal_spec)(cfg, srbd)
    if variant not in SPEC_BUILDERS:
        raise ValueError(variant)
    return SPEC_BUILDERS[variant](cfg, srbd)


# ---------------------------------------------------------------------------
class VariantSolution(NamedTuple):
    U: object  # (H, nu)
    X: object  # (H+1, nx) optimized rollout
    grfs: object  # (4, 3)
    predicted_state: object  # (12,)
    cost: object
    qp_gap: object


def soft_selection(spec: VariantSpec, H: int):
    """The (H m, H ns) block-diagonal slack selection of the soft rows, or None."""
    if spec.soft_mask is None or not np.any(spec.soft_mask):
        return None
    ns = int(np.sum(spec.soft_mask))
    single = np.zeros((spec.n_ineq, ns), np.float32)
    single[np.where(spec.soft_mask)[0], np.arange(ns)] = 1.0
    return np.kron(np.eye(H, dtype=np.float32), single)


def variant_qp_solver(gp, device="cuda"):
    """(solver_fn, iters) of the variant QPs: the nominal's algorithm and budget
    (``sqp.qp_solver_for``) with cascade-summed residuals. With the plain
    matmuls' running float32 sums the Mehrotra iterate stalls up to 0.64 N off
    float64 on kinodynamic ticks of a MuJoCo walk (288 variables, 576 rows)
    where the JAX package's lands within 0.07 N; summed in cascade order it
    lands within 0.07 N too (``python tests/test_torch_variants_loop.py f64``)."""
    fn, iters = qp_solver_for(gp, device)
    return functools.partial(fn, cascade=True), iters


def make_variant_solver(cfg: Config, spec: VariantSpec, return_assembler: bool = False,
                        device="cuda"):
    """The generalized condensed RTI solve of a variant, as a torch function on
    ``device``: ``solve(x0_aug, feet_traj, contact_seq, Xref, Uref, U_warm,
    wrench) -> VariantSolution`` on one problem (x0 (nx,), feet_traj (H, 4, 3) or
    (H, 4, 4), contact_seq (4, H), Xref (H, nx), Uref and U_warm (H, nu), wrench
    (H, 6)), with ``dims``. With ``return_assembler`` also ``assemble(x0, ...,
    U_warm, wrench) -> (Hm, g, Cb, d)``, the dense QP the first Gauss-Newton step
    solves (min 0.5 z'Hz + g'z s.t. Cb z <= d, U = U_warm + z.reshape(H, nu)), and
    ``S_big``, the host slack selection (None without soft rows): the seam of the
    float64 soft-QP ladder (``utils/verification.py``)."""
    device = resolve_device(device)
    H = cfg.mpc.horizon
    nx, nu, m = spec.nx, spec.nu, spec.n_ineq
    dims = OCPDims(nx=nx, nu=nu, horizon=H)
    gp = cfg.mpc.gradient
    qp_fn, iters = variant_qp_solver(gp, device)
    lm = gp.levenberg_marquardt * spec.lm_scale
    sqp_iters = 1 if gp.use_RTI else max(1, gp.num_qp_iterations)
    grf_max = cfg.mpc.grf_max
    dev = _dev(device)
    dts, stage_idx = dev(cfg.mpc.dts()), dev(np.arange(H))
    q_diag, r_diag = dev(spec.q_diag), dev(spec.r_diag)
    Qw, Rw = q_diag.repeat(H), r_diag.repeat(H)
    diag_R, lm_eye = torch.diag(Rw), lm * torch.eye(H * nu, device=device)
    stages = torch.arange(H, device=device)
    S_np = soft_selection(spec, H)
    S_big = None if S_np is None else dev(S_np)
    grf_from_x2 = spec.name == "input_rates" and gp.use_input_prediction

    def rollout(x0, U, feet_traj, contact_seq, w):
        xs = [x0]
        for k in range(H):
            xs.append(spec.dynamics(xs[-1], U[k], feet_traj[k], contact_seq[:, k], dts[k], w[k]))
        return torch.stack(xs)

    # Forward mode carries the tangent of a 0-d tensor combined with a Python
    # scalar in float64 (torch promotes the scalar's zero tangent as a tensor);
    # the Jacobians come back to the primal's dtype.
    def jac(x, u, feet, c, dt, wk):
        A = _jacfwd(lambda xx: spec.dynamics(xx, u, feet, c, dt, wk))(x)
        B = _jacfwd(lambda uu: spec.dynamics(x, uu, feet, c, dt, wk))(u)
        return A.to(x.dtype), B.to(x.dtype)

    def lin_con(x, u, c, fzm, feet, k):
        cval = spec.stage_ineq(x, u, c, fzm, feet, k)
        Cx = _jacfwd(lambda xx: spec.stage_ineq(xx, u, c, fzm, feet, k))(x)
        Cu = _jacfwd(lambda uu: spec.stage_ineq(x, uu, c, fzm, feet, k))(u)
        return cval, Cx.to(x.dtype), Cu.to(x.dtype)

    def build_qp(x0, Ubar, feet_traj, contact_seq, Xref, Uref, w):
        xbar = rollout(x0, Ubar, feet_traj, contact_seq, w)
        seq_t = contact_seq.T
        A, B = _vmap(jac)(xbar[:-1], Ubar, feet_traj, seq_t, dts, w)
        # Condensed with dx0 = 0: x_{k+1} deviation = (G dU)_k.
        _, Gm = condense(Linearization(A, B, xbar), dims)
        Gt = input_operator(Gm)
        e = (xbar[1:] - Xref).reshape(-1)
        g = Gt @ (Qw * e) + Rw * (Ubar - Uref).reshape(-1)
        Hm = (Gt * Qw) @ Gt.T + diag_R + lm_eye
        # Stage inequalities linearized at (xbar_k, ubar_k); the state rows of
        # stage k >= 1 map through row k - 1 of the prediction operator.
        fz_max = grf_max * seq_t + 1e-3
        cval, Cx, Cu = _vmap(lin_con)(xbar[:-1], Ubar, seq_t, fz_max, feet_traj, stage_idx)
        Cb = torch.cat([Cx.new_zeros((1, m, H, nu)),
                        torch.einsum("kmx,kjxu->kmju", Cx[1:], Gm[:-1])])
        Cb[stages, :, stages, :] += Cu  # the block diagonal
        return Hm, g, Cb.reshape(H * m, H * nu), (-cval).reshape(-1)

    def gn_step(x0, Ubar, feet_traj, contact_seq, Xref, Uref, w):
        Hm, g, Cb, d = (a[None] for a in build_qp(x0, Ubar, feet_traj, contact_seq, Xref,
                                                   Uref, w))
        if S_big is not None:
            sol = soft_qp_solve(Hm, g, Cb, d, S_big, zl=gp.slack_l1, Zl=gp.slack_l2,
                                solver=qp_fn, iters=iters)
        else:
            sol = qp_fn(Hm, g, Cb, d, iters=iters)
        return Ubar + sol.z[0].reshape(H, nu), sol

    def solve(x0, feet_traj, contact_seq, Xref, Uref, U_warm, w):
        U = U_warm
        for _ in range(sqp_iters):
            U, sol = gn_step(x0, U, feet_traj, contact_seq, Xref, Uref, w)
        X = rollout(x0, U, feet_traj, contact_seq, w)
        ex, eu = X[1:] - Xref, U - Uref
        cost = (ex * ex * q_diag).sum() + (eu * eu * r_diag).sum()
        # Variants with force states report the post-first-stage force X[1] (X[2]
        # under use_input_prediction, compensating control latency).
        grfs = spec.grfs_of(U[0], X[2] if grf_from_x2 else X[1]).reshape(4, 3) \
            * contact_seq[:, 0:1]
        return VariantSolution(U, X, grfs, X[1][:12], cost, sol.gap[0])

    if not return_assembler:
        return solve, dims

    def assemble(x0, feet_traj, contact_seq, Xref, Uref, U_warm, wrench=None):
        w = x0.new_zeros((H, 6)) if wrench is None else wrench
        return build_qp(x0, U_warm, feet_traj, contact_seq, Xref, Uref, w)

    return solve, dims, assemble, S_np


class FlatLayout:
    """A flat float32 layout of named arrays, so a tick moves one buffer each way."""

    def __init__(self, fields):
        self.fields, o = {}, 0
        for name, shape in fields:
            n = int(np.prod(shape, dtype=np.int64))
            self.fields[name] = (o, o + n, tuple(shape))
            o += n
        self.size = o

    def pack(self, out: np.ndarray, **arrays) -> np.ndarray:
        for name, (a, b, _) in self.fields.items():
            out[a:b] = np.asarray(arrays[name], np.float32).reshape(-1)
        return out

    def unpack(self, flat):
        return {name: flat[a:b].reshape(shape) for name, (a, b, shape) in self.fields.items()}


class VariantGradientMPC(HostIO):
    """Host wrapper of the variant controllers (counterpart of the JAX package's).

    Same dict-based API as GradientMPC; the extra augmented states initialize
    from the current state and reference each tick (z1/z2 from the tracking
    errors for lyapunov, the foot states from the current feet, the joints from
    the state's joint angles for kinodynamic) or carry over (the force, wrench
    and phi states). ``solve`` takes host arrays and returns host arrays;
    ``U_warm``, ``extra_state`` and ``previous_grfs`` are host numpy
    (``interop.set_variant_state``)."""

    def __init__(self, cfg: Config, variant: str, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.spec = spec = make_spec(cfg, variant, make_params(cfg, device=self.device))
        solve, self.dims = make_variant_solver(cfg, spec, device=self.device)
        H, nx, nu = self.dims.horizon, spec.nx, spec.nu
        self._feet_cols = 4 if spec.name == "foothold" else 3
        self.inputs = lay_in = FlatLayout((
            ("x0", (nx,)), ("feet_traj", (H, 4, self._feet_cols)), ("seq", (4, H)),
            ("Xref", (H, nx)), ("Uref", (H, nu)), ("U_warm", (H, nu)), ("wrench", (H, 6))))
        self.outputs = FlatLayout((
            ("U", (H, nu)), ("X", (H + 1, nx)), ("grfs", (4, 3)), ("predicted_state", (12,)),
            ("cost", ()), ("qp_gap", ())))

        def solve_flat(flat):
            sol = solve(*lay_in.unpack(flat.to(self.device, non_blocking=True)).values())
            return torch.cat([x.reshape(-1) for x in sol])

        # On a CUDA device the solve replays its captured graph; on the CPU it runs
        # eagerly (the graph's plain version).
        self._solve_dev = GraphedFunction(solve_flat, self.device)
        self._host = {}
        self._kin = LegKinematics(cfg.robot)
        self.U_warm = np.zeros((H, nu), np.float32)
        self.extra_state = np.zeros(nx - 12, np.float32)
        self.previous_grfs = np.zeros((4, 3), np.float32)
        self.last_X = None  # optimized rollout of the last successful solve

    def solve(self, x0, feet_traj, seq, Xref, Uref, U_warm, wrench) -> VariantSolution:
        """One solve from host arrays: one copy in, one graph replay, one copy out."""
        buf = self._buffer("in", (self.inputs.size,))
        self.inputs.pack(buf.numpy(), x0=x0, feet_traj=feet_traj, seq=seq, Xref=Xref,
                         Uref=Uref, U_warm=U_warm, wrench=wrench)
        out = self.outputs.unpack(self._to_host(self._solve_dev(buf)))
        return VariantSolution(**{k: out[k] for k in VariantSolution._fields})

    def compute_control(self, state, reference, contact_sequence, constraint=None,
                        external_wrenches=None):
        cfg = self.cfg
        H = self.dims.horizon
        name = self.spec.name
        seq = np.asarray(contact_sequence, np.float32)[:, :H]
        feet_now = np.stack([np.asarray(state[f"foot_{leg}"]).reshape(3) for leg in _LEGS])
        ref_feet = np.stack([np.asarray(reference[f"ref_foot_{leg}"]).reshape(-1, 3)
                             for leg in _LEGS])
        feet_traj = build_feet_trajectory(feet_now, ref_feet, seq, H)

        x_base = _state_vector(state).astype(np.float32)
        xref_base = np.concatenate([
            np.asarray(reference["ref_position"]).reshape(3),
            np.asarray(reference["ref_linear_velocity"]).reshape(3),
            np.asarray(reference["ref_orientation"]).reshape(3),
            np.asarray(reference["ref_angular_velocity"]).reshape(3)]).astype(np.float32)

        extra = self.extra_state.copy()
        if name == "input_rates":
            # The carried force state goes stale across contact switches: zero it
            # for swing legs and re-seed newly-stance legs at their gravity share.
            n0 = max(seq[:, 0].sum(), 1.0)
            share0 = cfg.robot.mass * cfg.gravity / n0
            f = extra.reshape(4, 3)
            for leg in range(4):
                if seq[leg, 0] == 0:
                    f[leg] = 0.0
                elif f[leg, 2] < 1.0:
                    f[leg] = [0.0, 0.0, share0]
            extra = f.reshape(12)
        if name == "foothold":
            extra = feet_now.reshape(12).astype(np.float32)
        if name == "kinodynamic":
            extra = np.concatenate([np.asarray(state[f"joint_{leg}"]).reshape(3)
                                    for leg in _LEGS]).astype(np.float32)
        if name == "lyapunov":
            # z1 = p - p_ref; z2 = (v - v_ref) + K1 z1 (float64, stored into the
            # float32 state); phi (6:9) carries across ticks.
            z1 = x_base[0:3] - xref_base[0:3]
            z2 = (x_base[3:6] - xref_base[3:6]) + np.asarray(cfg.mpc.gradient.K_z1) * z1
            extra[0:3], extra[3:6] = z1, z2
        x0 = np.concatenate([x_base, extra])

        Xref = np.tile(np.concatenate([xref_base, np.zeros(self.spec.nx - 12, np.float32)]),
                       (H, 1))
        n_st = np.maximum(seq.sum(axis=0), 1.0)
        share = cfg.robot.mass * cfg.gravity / n_st
        if name == "kinodynamic":
            # Joint reference from the analytic IK of the reference footholds, the
            # base at (x, y) of the state and the reference height.
            R = euler_xyz_to_rot_np(xref_base[6:9].astype(np.float32))
            base = np.array([x_base[0], x_base[1], xref_base[2]], np.float32)
            Xref[:, 12:24] = self._kin.ik_world(ref_feet[:, 0, :].astype(np.float32), base,
                                                R).reshape(12)
            Uref = np.zeros((H, 24), np.float32)
            for leg in range(4):
                Uref[:, 12 + leg * 3 + 2] = share * seq[leg]
        elif name == "foothold":
            # The foot-state reference tracks the per-stage reference footholds;
            # the GRF references carry the gravity share.
            Xref[:, 12:24] = feet_traj.reshape(H, 12)
            Uref = np.zeros((H, 24), np.float32)
            for leg in range(4):
                Uref[:, 12 + leg * 3 + 2] = share * seq[leg]
        elif name == "input_rates":
            # Force references live in the state reference; the rate reference is 0.
            for leg in range(4):
                Xref[:, 12 + leg * 3 + 2] = share * seq[leg]
            Uref = np.zeros((H, 12), np.float32)
        else:
            Uref = np.zeros((H, 12), np.float32)
            for leg in range(4):
                Uref[:, leg * 3 + 2] = share * seq[leg]
            if name == "lyapunov":
                Uref[:] = 0.0  # forces are deltas over the stabilizing F*

        # A fresh (all-zero) warm start linearizes at f = 0, where the SRB torque
        # has no force/foothold sensitivity: seed from the gravity-share reference.
        U_ws = Uref if not np.any(self.U_warm) else self.U_warm
        feet_solver = np.asarray(feet_traj, np.float32)
        if name == "foothold":
            # The stance-proximity column (1 on the last swing stage before a
            # touch-down): the spec freezes the foot states there.
            prox = np.zeros((H, 4), np.float32)
            for k in range(H - 1):
                prox[k] = (seq[:, k] == 0) & (seq[:, k + 1] == 1)
            feet_solver = np.concatenate([feet_solver, prox[:, :, None]], axis=2)
        wrench = build_stage_wrench(cfg, external_wrenches, H)
        out = self.solve(np.asarray(x0, np.float32), feet_solver, seq, Xref, Uref,
                         np.asarray(U_ws, np.float32), wrench)
        U = np.asarray(out.U)
        if not np.all(np.isfinite(U)):
            # Failure fallback: the previous GRFs, the warm start reset.
            grfs, status, predicted = self.previous_grfs, 1, x_base
            self.U_warm[:] = 0.0
        else:
            grfs = np.asarray(out.grfs)
            if name == "lyapunov":
                # Applied force = delta + the redistributed F* (model :240-245).
                z1, z2, phi = extra[0:3], extra[3:6], extra[6:9]
                K1 = np.asarray(cfg.mpc.gradient.K_z1)
                K2 = np.asarray(cfg.mpc.gradient.K_z2)
                F_star = cfg.robot.mass * (-(K1 + K2) * z2 + K1 * K1 * z1
                                           - np.array([0, 0, -cfg.gravity])) - phi
                n0 = max(seq[:, 0].sum(), 1.0)
                grfs = (grfs + (F_star / n0)[None, :]) * seq[:, 0:1]
                self.extra_state[6:9] = phi + cfg.mpc.dt * (-z2)  # phi's adaptive law
            if name in ("collaborative", "input_rates"):
                self.extra_state = np.asarray(out.X[1][12:])
            if name == "kinodynamic":
                # Joint trajectories for the swing controller (reference
                # srbd_controller_interface.py:184-207).
                self.nmpc_joints_pos = np.asarray(out.X[1:, 12:24])
                self.nmpc_joints_vel = np.asarray(out.U[:, :12])
            self.previous_grfs = grfs.copy()
            self.U_warm = np.concatenate([U[1:], U[-1:]], axis=0)
            status = 0
            predicted = np.asarray(out.predicted_state)
            self.last_X = np.asarray(out.X)

        fh = np.empty((4, 3), np.float32)
        X_opt = np.asarray(out.X) if status == 0 else None
        hw = np.asarray(cfg.mpc.gradient.foothold_box_halfwidth)
        for leg in range(4):
            fh[leg] = feet_traj[-1, leg]
            for k in range(1, H):
                if seq[leg, k] == 1 and seq[leg, k - 1] == 0:
                    fh[leg] = feet_traj[k, leg]
                    if name == "foothold" and X_opt is not None:
                        # The optimized touch-down from the foot state, clipped to
                        # the constraint box.
                        opt = X_opt[k, 12 + leg * 3: 12 + leg * 3 + 3]
                        fh[leg, :2] = np.clip(opt[:2], feet_traj[k, leg, :2] - hw,
                                              feet_traj[k, leg, :2] + hw)
                    break
        return grfs, fh, predicted, status, float(out.cost)

    def reset(self):
        # Rebind (never zero in place): returned arrays may alias these.
        self.U_warm = np.zeros_like(self.U_warm)
        self.extra_state = np.zeros_like(self.extra_state)
        self.previous_grfs = np.zeros_like(self.previous_grfs)
        self.last_X = None
