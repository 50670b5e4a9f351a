"""TAMOLS-inspired terrain-aware foothold adaptation (torch).

Counterpart of ``quadruped_pympc_tamols_tpu/planner/tamols.py``, a re-design of
the reference VisualFootholdAdaptation 'tamols' strategy
(helpers/visual_foothold_adaptation.py:153-714), which scores every heightmap cell
of each leg in a Python loop once per swing apex. Here all candidate cells of all
four legs are scored at once: the legs are a leading axis of 4 (the JAX package
``vmap``s one leg's program over them), hard masks and soft costs broadcast over
the (4, M) candidates, and an argmin per leg picks the foothold. Also the
'height' strategy (z-snap only, visual_foothold_adaptation.py:104-108).

Cost terms (weights from config ``tamols``, reference config.py:209-243):
  hard: search radius (an ellipse in the yaw-aligned frame); kinematic reach at
        touch-down and predicted lift-off (:375-395); leg-terrain collision along
        5 points of the hip-foot segment (:397-420); and, by their knobs,
        flight-time reach, lateral lane, foot separation, full-foot support and
        the stability gate.
  soft: edge avoidance (:422-466); roughness, the plane-detrended variance of a
        3 x 3 patch (:468-521); deviation from the seed (:341-345); nominal
        kinematics (:523-553); reference-velocity tracking (:555-609); trot
        stability against the diagonal support segment (:611-714); and, by their
        knobs, the support ring and lattice progression.

Every knob is a Python branch on the config, as in the JAX package, and the
arithmetic keeps its float32 order. Every lookup of a call (the 3 x 3 patch, the
support ring, the leg segment) is one batched gather.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..utils.device import device_constant, resolve_device
from .heightmap import GridHeightMap, lookup_nearest

_BIG = 1.0e10

# Trot diagonal partners: FL<->RR, FR<->RL (reference :640-645).
_DIAG = np.array([3, 2, 1, 0])

# Lateral side sign per leg (FL, FR, RL, RR): left legs at +y in the yaw-aligned
# frame, right legs at -y (gait/foothold_reference.py).
_Y_OFFSET_SIGN = np.array([1.0, -1.0, 1.0, -1.0], dtype=np.float32)

# For each leg, the indices of the other three.
_OTHERS = np.array([[j for j in range(4) if j != i] for i in range(4)])

# Points of the hip -> foot segment probed for collision: jnp.linspace(0.2, 0.8, 5)
# in float32, bit for bit (numpy's and torch's linspace round two of them apart).
_ALPHAS = np.array([0.2, 0.35, 0.5, 0.65000004, 0.8], dtype=np.float32)

# The 3 x 3 patch: offsets (i, j) in {-1, 0, 1}^2, row-major; its center is
# index 4 and the +-x / +-y neighbours the edge term differentiates are 7 / 1
# and 5 / 3.
_PATCH_IJ = np.array([[i, j] for i in (-1, 0, 1) for j in (-1, 0, 1)], dtype=np.float64)


class TamolsResult(NamedTuple):
    footholds: torch.Tensor  # (4, 3) adapted footholds (world)
    constraints_lo: torch.Tensor  # (4, 3) box lower vertex
    constraints_hi: torch.Tensor  # (4, 3) box upper vertex
    best_cost: torch.Tensor  # (4,)
    feasible: torch.Tensor  # (4,) bool: any candidate passed the hard constraints
    cell_costs: torch.Tensor  # (4, M) every cell's cost, _BIG where infeasible ('height': (4, 0))


def _detrend_projection(delta: float) -> np.ndarray:
    """9 x 9 residual projector of the 3 x 3 plane fit: r = (I - A (A^T A)^-1 A^T) h.

    The patch geometry is fixed (offsets i, j in {-1, 0, 1} * delta), so the
    least-squares plane fit of the reference (:503-515) is one constant matrix."""
    pos = _PATCH_IJ * delta
    A = np.column_stack([pos[:, 0], pos[:, 1], np.ones(9)])
    P = np.eye(9) - A @ np.linalg.solve(A.T @ A, A.T)
    return P.astype(np.float32)


def _sq3(d):
    """Sum of squares over a last axis of 3, in the order ((x^2 + y^2) + z^2)."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _sq2(d):
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]


# Rows of the packed per-call inputs (one host-to-device copy): per leg
# seed, hip, foot, anchor (3 each), contact, t_remain; then base_pos, base_vel.
_LEG_COLS = 14


def _pack_inputs(seeds, hips, base_pos, base_vel, current_contact, feet, own_anchor,
                t_remain) -> np.ndarray:
    """The scorer's per-call inputs as one float32 host array (62,)."""
    legs = np.concatenate([np.asarray(seeds, np.float32), np.asarray(hips, np.float32),
                           np.asarray(feet, np.float32), np.asarray(own_anchor, np.float32),
                           np.asarray(current_contact, np.float32).reshape(4, 1),
                           np.asarray(t_remain, np.float32).reshape(4, 1)], axis=1)
    return np.concatenate([legs.reshape(-1), np.asarray(base_pos, np.float32).reshape(3),
                           np.asarray(base_vel, np.float32).reshape(3)])


def make_tamols_scorer(cfg: Config, strategy: str | None = None, device="cuda"):
    """Build the foothold-adaptation function on ``device``.

    Returns ``adapt(hms, seeds, hips, base_pos, base_vel, current_contact, feet,
    own_anchor, t_remain=None) -> TamolsResult`` (tensors on the device), where
    ``hms`` is a leg-stacked GridHeightMap on the device (leaves with a leading 4)
    and seeds/hips/feet/own_anchor are (4, 3) host arrays; the host inputs cross
    in one copy. ``t_remain`` (4,) defaults to 1e3 (no flight-time gate)."""
    tp = cfg.tamols
    strategy = strategy or cfg.sim.visual_foothold_adaptation
    dev = resolve_device(device)
    l_min, l_max = cfg.robot.l_min, cfg.robot.l_max
    z_off = tp.sensor_z_offset  # +0.02 of FastHeightMap.get_height (:35)
    delta = tp.gradient_delta

    def const(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    p_t = const(_detrend_projection(delta).T.copy())
    offs = const(_PATCH_IJ * delta)  # (9, 2)
    ring_offs = 2.0 * offs
    alphas = const(_ALPHAS)
    one_minus_alphas = 1 - alphas
    sides = const(_Y_OFFSET_SIGN)
    box = const([tp.constraint_box_dx, tp.constraint_box_dy, 0.0])
    h_des = const([0.0, 0.0, tp.h_des])
    support = tp.support_margin < 1.0
    support_soft = support and tp.weight_support > 0.0
    rx_f = min(tp.search_radius_forward, tp.search_radius)
    rx_b = min(tp.search_radius_back, tp.search_radius)

    def leg_maps(L: int):
        """(diag (L,), others (L, 3)): each leg's trot partner and its robot's other
        three legs, for L = 4 * robots legs in robot-major order."""
        base = 4 * (np.arange(L) // 4)
        return (device_constant(base + _DIAG[np.arange(L) % 4], dev, torch.int64),
                device_constant(base[:, None] + _OTHERS[np.arange(L) % 4], dev, torch.int64))

    leg_maps(4)  # the one-robot maps reach the device now, not in a call

    def score(hms: GridHeightMap, x: torch.Tensor) -> TamolsResult:
        """Score every cell of every leg; ``x`` is ``_pack_inputs`` on the device."""
        legs = x[:4 * _LEG_COLS].reshape(4, _LEG_COLS)
        return score_legs(hms, legs[:, 0:3], legs[:, 3:6], x[4 * _LEG_COLS:4 * _LEG_COLS + 3],
                          x[4 * _LEG_COLS + 3:], legs[:, 12], legs[:, 6:9], legs[:, 9:12],
                          legs[:, 13])

    def score_legs(hms: GridHeightMap, seed, hip, base_pos, base_vel, in_stance, foot_now, own,
                   t_remain=None) -> TamolsResult:
        """Score every cell of L legs (robot-major, 4 a robot): hms a GridHeightMap
        with leaves of leading shape (L,), seed/hip/foot_now/own (L, 3), in_stance
        and t_remain (L,) (t_remain None: 1e3, no flight-time gate), base_pos and
        base_vel (3,) for one robot or (L, 3), each leg's robot's; all on the
        device."""
        L = seed.shape[0]
        if t_remain is None:
            t_remain = torch.full((L,), 1e3, device=dev)
        diag, others = leg_maps(L)

        if strategy == "height":
            h = lookup_nearest(hms, seed[:, None, :2])[:, 0] + z_off
            fh = torch.cat([seed[:, :2], h[:, None]], dim=1)
            return TamolsResult(fh, fh - _BIG, fh + _BIG, torch.zeros(L, device=dev),
                                torch.ones(L, dtype=torch.bool, device=dev),
                                torch.zeros((L, 0), device=dev))

        cand_xy = hms.cell_world_xy().reshape(L, -1, 2)  # (L, M, 2)
        yaw = hms.yaw.reshape(L, 1)
        c_r, s_r = torch.cos(yaw), torch.sin(yaw)

        # One gather for every lookup of the call: the 3 x 3 patch (its center is
        # the candidate itself), the +-2 delta support ring, and the xy of the
        # five hip -> candidate segment points (whose z needs no lookup).
        leg_xy = (hip[:, None, None, :2] * one_minus_alphas[None, None, :, None]
                  + cand_xy[:, :, None, :] * alphas[None, None, :, None])  # (4, M, 5, 2)
        pts = [cand_xy[:, :, None, :] + offs]
        if support_soft:
            pts.append(cand_xy[:, :, None, :] + ring_offs)
        pts.append(leg_xy)
        looked = lookup_nearest(hms, torch.cat(pts, dim=2))  # (4, M, 9 [+ 9] + 5)
        patch = looked[..., :9] + z_off
        ground = looked[..., -5:]  # raw grid z under the segment points
        # Candidate z: grid height + sensor offset + 0.005 (reference :192).
        cand_z = patch[..., 4] + 0.005
        cand = torch.cat([cand_xy, cand_z[..., None]], dim=-1)  # (4, M, 3)

        # --- hard: search radius around the seed, an ellipse in the yaw-aligned
        # frame (reference :245-259 builds its candidates within it).
        rel = cand_xy - seed[:, None, :2]
        dx_h = c_r * rel[..., 0] + s_r * rel[..., 1]
        dy_h = -s_r * rel[..., 0] + c_r * rel[..., 1]
        rx = torch.where(dx_h > 0, rx_f, rx_b)
        in_radius = (dx_h / rx) ** 2 + (dy_h / tp.search_radius) ** 2 <= 1.0

        # --- hard: kinematic reach at touch-down and predicted lift-off (:375-395),
        # at the predicted hip at touch-down with predict_hip_at_touchdown.
        if tp.predict_hip_at_touchdown:
            hip_td = hip + base_vel * torch.clamp(t_remain, max=1.0)[:, None]
        else:
            hip_td = hip
        d_td = torch.sqrt(_sq3(cand - hip_td[:, None, :]))
        hip_lo = hip_td + base_vel * 0.3  # stance_duration 0.3 s (:387-390)
        d_lo = torch.sqrt(_sq3(cand - hip_lo[:, None, :]))
        feas = in_radius & (d_td >= l_min) & (d_td <= l_max) & (d_lo >= l_min) & (d_lo <= l_max)

        # --- hard: flight-time reach (max_foot_speed): the remaining swing must
        # cover the xy distance from the foot's current position.
        if tp.max_foot_speed > 0.0:
            d_fly = torch.sqrt((cand_xy[..., 0] - foot_now[:, None, 0]) ** 2
                               + (cand_xy[..., 1] - foot_now[:, None, 1]) ** 2)
            feas = feas & (d_fly <= tp.max_foot_speed * t_remain[:, None])

        # --- hard: lateral lane (leg-crossing guard).
        if tp.lateral_margin > 0.0:
            rel_b = cand_xy - base_pos[..., None, :2]
            y_h = -s_r * rel_b[..., 0] + c_r * rel_b[..., 1]
            feas = feas & (sides[:, None] * y_h >= tp.lateral_margin)

        # --- hard: foot separation from the other legs' current feet.
        if tp.foot_separation > 0.0:
            d_feet = torch.sqrt(_sq2(cand_xy[:, :, None, :]
                                     - foot_now[others][:, None, :, :2]))  # (4, M, 3)
            feas = feas & torch.all(d_feet >= tp.foot_separation, dim=2)

        # --- hard: leg-terrain collision along the hip -> foot segment (:397-420).
        leg_z = (hip[:, None, None, 2] * one_minus_alphas
                 + cand[..., None, 2] * alphas)  # (4, M, 5)
        collide = torch.any(leg_z < ground + 0.02, dim=2)
        feas = feas & ~collide

        # --- soft: edge avoidance (:422-466), central differences of the patch.
        hpx, hmx, hpy, hmy = patch[..., 7], patch[..., 1], patch[..., 5], patch[..., 3]
        grad = torch.sqrt(((hpx - hmx) / (2 * delta)) ** 2 + ((hpy - hmy) / (2 * delta)) ** 2)
        edge = torch.clamp(grad - tp.slope_threshold, min=0.0) * tp.weight_edge_avoidance

        # --- soft: roughness = detrended variance of the 3 x 3 patch (:468-521).
        resid = patch @ p_t
        rough = torch.mean(resid * resid, dim=2) * tp.weight_roughness

        # --- hard: full-foot support: the detrended patch's span.
        if support:
            span = torch.amax(resid, dim=2) - torch.amin(resid, dim=2)
            feas = feas & (span <= tp.support_margin)

        # --- soft: rim proximity, the detrended span of the +-2 delta ring.
        if support_soft:
            resid2 = (looked[..., 9:18] + z_off) @ p_t
            span2 = torch.amax(resid2, dim=2) - torch.amin(resid2, dim=2)
            support_cost = torch.clamp(span2 - tp.support_margin, min=0.0) * tp.weight_support

        # --- soft: deviation from the seed (3D, reference :344).
        dev_cost = _sq3(cand - seed[:, None, :]) * tp.weight_deviation

        # --- soft: nominal kinematics (:523-553).
        diffn = hip[:, None, :] - (cand + h_des)
        nominal = _sq3(diffn) * tp.weight_nominal_kinematic

        # --- soft: reference-velocity tracking (x only, :555-609).
        vx = base_vel[..., None, 0]
        dx = cand[..., 0] - seed[:, None, 0]
        vel_mag = torch.sqrt(_sq2(base_vel[..., None, :2]))
        oppose = ((vx > 0) & (dx < 0)) | ((vx < 0) & (dx > 0))
        track = torch.where(vel_mag < 0.01, 0.0, torch.where(oppose, dx * dx, 0.0)) \
            * tp.weight_reference_tracking

        # --- soft: trot stability against the diagonal-support segment (:611-714).
        com_pred = base_pos[..., None, :2] + base_vel[..., None, :2] * tp.estimated_swing_time
        p1 = cand[..., :2]
        p2 = foot_now[diag][:, :2]
        v = p2[:, None, :] - p1
        w = com_pred - p1
        vv = _sq2(v)
        t = torch.clamp((w[..., 0] * v[..., 0] + w[..., 1] * v[..., 1])
                        / torch.clamp(vv, min=1e-8), 0.0, 1.0)
        t = torch.where(vv < 1e-8, 0.0, t)
        closest = p1 + t[..., None] * v
        dist = torch.sqrt(_sq2(com_pred - closest))
        stab_pen = torch.clamp(dist - tp.stability_margin, min=0.0) ** 2
        stance = (in_stance == 1.0)[:, None]
        stab = torch.where(stance, 0.0, stab_pen) * tp.weight_stability
        if not tp.stability_soft:
            stab = stab * 0.0  # soft penalty off (the hard gate may still apply)
        if tp.stability_hard:
            feas = feas & ((dist <= tp.stability_margin) | stance)

        # --- soft: lattice progression (min_advance), gated per leg on the
        # height span of the cells near the leg's current foot.
        if tp.min_advance > 0.0:
            d_foot2 = (cand_xy[..., 0] - own[:, None, 0]) ** 2 \
                + (cand_xy[..., 1] - own[:, None, 1]) ** 2
            near_foot = d_foot2 < tp.progression_foot_radius ** 2
            z_hi = torch.amax(torch.where(near_foot, cand_z, -_BIG), dim=1)
            z_lo = torch.amin(torch.where(near_foot, cand_z, _BIG), dim=1)
            on_lattice = (z_hi - z_lo) > tp.progression_gate_range
            dx_own = c_r * (cand_xy[..., 0] - own[:, None, 0]) \
                + s_r * (cand_xy[..., 1] - own[:, None, 1])
            short = torch.clamp(tp.min_advance - dx_own, 0.0, tp.min_advance)
            prog = torch.where(on_lattice[:, None], short * short * tp.weight_progression, 0.0)

        # The JAX sum's order; its absent terms add an exact 0.0.
        cost = edge + rough + dev_cost + nominal + track + stab
        if support_soft:
            cost = cost + support_cost
        if tp.min_advance > 0.0:
            cost = cost + prog
        cost = torch.where(feas, cost, _BIG)

        best = torch.argmin(cost, dim=1)  # the first minimum, as jnp.argmin
        best_cost = cost.gather(1, best[:, None])[:, 0]
        any_feas = best_cost < _BIG
        best_cand = cand.gather(1, best[:, None, None].expand(L, 1, 3))[:, 0]

        # Fallback when nothing is feasible: the height-snapped seed (reference
        # :223-228) or, with fallback 'foot', the leg's own anchor (known ground).
        fb_xy = own[:, :2] if tp.fallback == "foot" else seed[:, :2]
        fb = torch.cat([fb_xy, lookup_nearest(hms, fb_xy[:, None, :])[:, 0:1] + z_off], dim=1)
        fh = torch.where(any_feas[:, None], best_cand, fb)
        return TamolsResult(fh, fh - box, fh + box, best_cost, any_feas, cost)

    def adapt(hms: GridHeightMap, seeds, hips, base_pos, base_vel, current_contact, feet,
              own_anchor, t_remain=None) -> TamolsResult:
        if t_remain is None:
            t_remain = np.full(4, 1e3, np.float32)
        x = _pack_inputs(seeds, hips, base_pos, base_vel, current_contact, feet, own_anchor,
                        t_remain)
        return score(hms, torch.from_numpy(x).to(dev))

    adapt.legs = score_legs
    return adapt


class TamolsPlanner:
    """Host wrapper mirroring VisualFootholdAdaptation's API surface (initialized
    flag, reset at full stance, get_footholds_adapted;
    visual_foothold_adaptation.py:59-72). One apex call crosses to the device in
    one copy and back in one."""

    def __init__(self, cfg: Config, strategy: str | None = None, device="cuda"):
        self.cfg = cfg
        self.strategy = strategy or cfg.sim.visual_foothold_adaptation
        self.device = resolve_device(device)
        self.adapt_fn = (make_tamols_scorer(cfg, self.strategy, self.device)
                         if self.strategy != "blind" else None)
        self.initialized = False
        self.footholds_adaptation = None
        self.footholds_constraints = None

    def reset(self):
        self.initialized = False

    def compute_adaptation(self, hms, seeds, hips, base_pos, base_vel, current_contact, feet,
                           own_anchor=None, t_remain=None) -> TamolsResult:
        """Score, then copy footholds, boxes, costs and flags to the host at once;
        returns the result as host numpy arrays. Grids sensed on the host move to
        the planner's device here, so a loop that senses every tick while the
        planner waits touches the card only at the apex."""
        if hms.heights.device != self.device:
            hms = GridHeightMap(*(getattr(hms, f).to(self.device)
                                  for f in ("center", "yaw", "resolution", "heights")))
        anchor = feet if own_anchor is None else own_anchor
        res = self.adapt_fn(hms, seeds, hips, base_pos, base_vel, current_contact, feet,
                            anchor, t_remain)
        host = torch.cat([res.footholds, res.constraints_lo, res.constraints_hi,
                          res.best_cost[:, None], res.feasible[:, None].float(),
                          res.cell_costs], dim=1).cpu().numpy()
        fh, lo, hi = host[:, 0:3], host[:, 3:6], host[:, 6:9]
        feasible = host[:, 10] > 0.5
        self.footholds_adaptation = fh
        self.footholds_constraints = (lo, hi)
        self.last_seeds = np.asarray(seeds)  # observability (loggers, tests)
        self.last_feasible = feasible
        self.initialized = True
        return TamolsResult(fh, lo, hi, host[:, 9], feasible, host[:, 11:])

    def get_footholds_adapted(self, reference_footholds):
        if not self.initialized:
            return reference_footholds, None
        return self.footholds_adaptation, self.footholds_constraints
