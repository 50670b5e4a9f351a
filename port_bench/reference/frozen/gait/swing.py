"""Swing-foot trajectory generation and Cartesian tracking control (host numpy).

Counterpart of ``quadruped_pympc_tamols_tpu/gait/swing.py``. Generators mirror
the reference's options (helpers/swing_trajectory_controller.py:15-23):

* ``bezier_ref`` (default): 6th-degree Bezier with P0=P1=P2=lift_off and
  P4=P5=P6=touch_down (zero velocity/acceleration at both ends) and P3 solved so
  the curve midpoint reaches max(z0, zf) + step_height (reference
  bezier_ref_swing_trajectory_generator.py:62-122);
* ``explicit``: two chained cubic Beziers with a step-height apex (reference
  explicit_swing_trajectory_generator.py:57-74);
* ``scipy``: an alias of ``bezier_ref`` with reflex re-planning.

The per-tick swing math is ~1k scalar flops, so it stays on the host for one
robot. The scenario fleet evaluates its swing feet on the device with the float32
twin ``bezier_swing_refs_torch``, and ``make_swing_ik_step`` fuses all four legs'
references and the whole-body IK into one device function (one CUDA graph on the
card), the counterpart of the JAX package's jitted step.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import device_constant
from ..utils.float32 import F32, fmaf, powf

# Binomial coefficients of the degree-6 Bernstein basis.
_C6 = np.array([1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0], dtype=np.float32)


def _bernstein6(s):
    """s (...,) -> (b, db, d2b), each (..., 7): the basis and its first and second
    derivatives with respect to s."""
    i = np.arange(7, dtype=np.float64)
    s_ = np.asarray(s, np.float64)[..., None]
    si = s_ ** i
    ti = (1.0 - s_) ** (6 - i)
    b = _C6 * si * ti
    si_m1 = np.where(i > 0, s_ ** np.maximum(i - 1, 0), 0.0)
    ti_m1 = np.where(i < 6, (1.0 - s_) ** np.maximum(5 - i, 0), 0.0)
    db = _C6 * (i * si_m1 * ti - (6 - i) * si * ti_m1)
    si_m2 = np.where(i > 1, s_ ** np.maximum(i - 2, 0), 0.0)
    ti_m2 = np.where(i < 5, (1.0 - s_) ** np.maximum(4 - i, 0), 0.0)
    d2b = _C6 * (i * (i - 1) * si_m2 * ti - 2 * i * (6 - i) * si_m1 * ti_m1
                 + (6 - i) * (5 - i) * si * ti_m2)
    return b, db, d2b


def bezier_swing_refs(swing_time, swing_period, step_height, lift_off, touch_down,
                      liftoff_boost: float = 0.0, v0=None, v0_mask=None):
    """Desired foot (pos, vel, acc), each (..., 3), on the degree-6 Bezier curve.

    swing_time (...,), swing_period and step_height scalar or (...,), lift_off
    and touch_down (..., 3). ``liftoff_boost`` raises P1/P2 by (boost/2, boost) *
    step_height so the foot leaves with an upward velocity; ``v0`` (..., 3) with
    ``v0_mask`` (...,) starts the curve at a given velocity instead (velocity-
    matched re-planning). P3 compensates both so the apex height is preserved."""
    p0 = np.asarray(lift_off, np.float64)
    pf = np.asarray(touch_down, np.float64)
    period = np.asarray(swing_period, np.float64)
    sh = np.asarray(step_height, np.float64)
    s = np.clip(np.asarray(swing_time, np.float64) / period, 0.0, 1.0)
    d = liftoff_boost * sh
    up = np.zeros_like(p0)
    up[..., 2] = 1.0
    e = 3.0 * np.asarray(d)[..., None] * up  # e = v(0) * T
    if v0 is not None:
        m = np.asarray(v0_mask, np.float64)[..., None]
        e = m * (np.asarray(v0, np.float64) * period[..., None]) + (1.0 - m) * e
    z_mid = np.maximum(p0[..., 2], pf[..., 2]) + sh
    # z(0.5) = (p0 + 6 p1 + 15 p2 + 20 p3 + 22 pf)/64; the shifted P1/P2 add 6 e_z/64.
    p3_z = (64.0 * z_mid - 22.0 * p0[..., 2] - 22.0 * pf[..., 2]) / 20.0 - 6.0 * e[..., 2] / 20.0
    p3 = np.concatenate([0.5 * (p0[..., :2] + pf[..., :2]), p3_z[..., None]], axis=-1)
    p1 = p0 + e / 6.0
    p2 = p0 + e / 3.0
    cp = np.stack([p0, p1, p2, p3, pf, pf, pf], axis=-2)  # (..., 7, 3)
    b, db, d2b = _bernstein6(s)
    pos = np.einsum("...i,...ij->...j", b, cp)
    vel = np.einsum("...i,...ij->...j", db, cp) / period[..., None]
    acc = np.einsum("...i,...ij->...j", d2b, cp) / (period ** 2)[..., None]
    return pos, vel, acc


def bezier_swing_refs_torch(swing_time, swing_period, step_height, lift_off, touch_down,
                            liftoff_boost: float = 0.0):
    """``bezier_swing_refs`` on the device in float32, in the JAX package's order of
    operations: swing_time (...,), swing_period and step_height floats or (...,)
    tensors, lift_off and touch_down (..., 3). Returns (pos, vel, acc), each
    (..., 3)."""
    p0, pf = lift_off, touch_down
    s = torch.clamp(swing_time / swing_period, 0.0, 1.0)
    # Python floats enter as scalars, never as host tensors: this runs inside the
    # fleet's CUDA graph.
    e_z = torch.zeros_like(p0[..., 2]) + 3.0 * (liftoff_boost * step_height)
    e = torch.stack([torch.zeros_like(e_z), torch.zeros_like(e_z), e_z], dim=-1)
    z_mid = torch.maximum(p0[..., 2], pf[..., 2]) + step_height
    p3_z = (64.0 * z_mid - 22.0 * p0[..., 2] - 22.0 * pf[..., 2]) / 20.0 - 6.0 * e_z / 20.0
    p3 = torch.cat([0.5 * (p0[..., :2] + pf[..., :2]), p3_z[..., None]], dim=-1)
    cp = torch.stack([p0, p0 + e / 6.0, p0 + e / 3.0, p3, pf, pf, pf], dim=-2)  # (..., 7, 3)
    i = torch.arange(7, dtype=s.dtype, device=s.device)
    c6 = device_constant(_C6, s.device)
    s_ = s[..., None]
    si, ti = s_ ** i, (1.0 - s_) ** (6 - i)
    b = c6 * si * ti
    si_m1 = torch.where(i > 0, s_ ** torch.clamp(i - 1, min=0), 0.0)
    ti_m1 = torch.where(i < 6, (1.0 - s_) ** torch.clamp(5 - i, min=0), 0.0)
    db = c6 * (i * si_m1 * ti - (6 - i) * si * ti_m1)
    si_m2 = torch.where(i > 1, s_ ** torch.clamp(i - 2, min=0), 0.0)
    ti_m2 = torch.where(i < 5, (1.0 - s_) ** torch.clamp(4 - i, min=0), 0.0)
    d2b = c6 * (i * (i - 1) * si_m2 * ti - 2 * i * (6 - i) * si_m1 * ti_m1
                + (6 - i) * (5 - i) * si * ti_m2)
    period = (torch.zeros_like(s) + swing_period)[..., None]
    pos = torch.einsum("...i,...ij->...j", b, cp)
    vel = torch.einsum("...i,...ij->...j", db, cp) / period
    acc = torch.einsum("...i,...ij->...j", d2b, cp) / (period ** 2)
    return pos, vel, acc


def explicit_swing_refs(swing_time, swing_period, step_height, lift_off, touch_down):
    """Two chained cubic Beziers: up to the apex in the first half, down in the
    second (reference explicit_swing_trajectory_generator.py:57-74)."""
    p0 = np.asarray(lift_off, np.float64)
    pf = np.asarray(touch_down, np.float64)
    period = np.asarray(swing_period, np.float64)
    half = period / 2.0
    apex = np.concatenate([0.5 * (p0[..., :2] + pf[..., :2]),
                           (np.maximum(p0[..., 2], pf[..., 2]) + step_height)[..., None]],
                          axis=-1)
    t = np.clip(np.asarray(swing_time, np.float64), 0.0, period)
    t1 = np.clip(t / half, 0.0, 1.0)
    t2 = np.clip((t - half) / half, 0.0, 1.0)

    def cubic(a, b, tt):
        dd = b - a
        return (a + dd * (tt * tt * (3.0 - 2.0 * tt))[..., None],
                dd * (6.0 * tt * (1.0 - tt))[..., None], dd * (6.0 - 12.0 * tt)[..., None])

    pu, vu, au = cubic(p0, apex, t1)
    pd, vd, ad = cubic(apex, pf, t2)
    f = (t < half)[..., None]
    return (np.where(f, pu, pd), np.where(f, vu, vd) / half[..., None],
            np.where(f, au, ad) / (half * half)[..., None])


def _cubic_bezier_torch(p0, pf, t):
    """Cubic Bezier with zero end velocities: (pos, vel, acc) at t in [0, 1]."""
    d = pf - p0
    b = t * t * (3.0 - 2.0 * t)
    db = 6.0 * t * (1.0 - t)
    d2b = 6.0 - 12.0 * t
    return p0 + d * b[..., None], d * db[..., None], d * d2b[..., None]


def explicit_swing_refs_torch(swing_time, swing_period, step_height, lift_off, touch_down):
    """``explicit_swing_refs`` on the device in float32, in the JAX package's order
    of operations; arguments as ``bezier_swing_refs_torch``."""
    half = swing_period / 2.0
    apex = torch.cat([0.5 * (lift_off[..., :2] + touch_down[..., :2]),
                      (torch.maximum(lift_off[..., 2], touch_down[..., 2])
                       + step_height)[..., None]], dim=-1)
    t = torch.minimum(torch.clamp(swing_time, min=0.0), torch.zeros_like(swing_time)
                      + swing_period)
    first = t < half
    t1 = torch.clamp(t / half, 0.0, 1.0)
    t2 = torch.clamp((t - half) / half, 0.0, 1.0)
    p_up, v_up, a_up = _cubic_bezier_torch(lift_off, apex, t1)
    p_dn, v_dn, a_dn = _cubic_bezier_torch(apex, touch_down, t2)
    f = first[..., None]
    half = (torch.zeros_like(t) + half)[..., None]
    return (torch.where(f, p_up, p_dn), torch.where(f, v_up, v_dn) / half,
            torch.where(f, a_up, a_dn) / (half * half))


# The JAX package's names for its jitted references; here the device twins.
bezier_swing_refs_jit = bezier_swing_refs_torch
explicit_swing_refs_jit = explicit_swing_refs_torch


def _powi(x, n):
    """x ** n for a float32 scalar and integer exponents (7,), as XLA's code
    evaluates a constant power: 1, x, x * x, else libm's powf."""
    n = np.asarray(n, F32)
    return np.where(n == 0, F32(1.0), np.where(n == 1, x, np.where(n == 2, x * x, powf(x, n))))


def bezier_swing_refs_f32(swing_time, swing_period, step_height, lift_off, touch_down,
                          liftoff_boost=0.0, v0=None):
    """One leg's degree-6 Bezier (pos, vel, acc), each (3,) float32, with the bits
    of the JAX package's jitted float32 ``bezier_swing_refs`` on the CPU, which
    its per-leg path (the non-analytic IK) evaluates: the same curve as
    ``bezier_swing_refs`` in XLA's order, with its powers (``_powi``), its contracted
    multiply-adds, its folded constants (1/6, 1/3, 1/20 and 6/20 as products) and
    each basis sum as a chain of fused multiply-adds. ``v0`` starts the curve at
    that velocity (mask 1)."""
    f = F32
    t, per, sh, boost = f(swing_time), f(swing_period), f(step_height), f(liftoff_boost)
    lo, td = np.asarray(lift_off, f).reshape(3), np.asarray(touch_down, f).reshape(3)
    k = np.arange(7, dtype=f)
    s = np.clip(t / per, f(0.0), f(1.0))
    u = f(1.0) - s
    si, ti = _powi(s, k), _powi(u, 6 - k)
    si_m1 = np.where(k > 0, _powi(s, np.maximum(k - 1, 0)), f(0.0))
    ti_m1 = np.where(k < 6, _powi(u, np.maximum(5 - k, 0)), f(0.0))
    si_m2 = np.where(k > 1, _powi(s, np.maximum(k - 2, 0)), f(0.0))
    ti_m2 = np.where(k < 5, _powi(u, np.maximum(4 - k, 0)), f(0.0))
    b = (si * _C6) * ti
    db = fmaf(k * si_m1, ti, -(((6 - k) * si) * ti_m1)) * _C6
    d2b = fmaf(((6 - k) * (5 - k)) * si, ti_m2,
               fmaf((k * (k - 1)) * si_m2, ti, -(((2 * k * (6 - k)) * si_m1) * ti_m1))) * _C6
    e = ((boost * sh) * f(3.0)) * np.array([0.0, 0.0, 1.0], f)
    if v0 is not None:  # mask 1: e = 1 * v0 T + 0 * e
        e = fmaf(f(1.0), np.asarray(v0, f).reshape(3) * per, f(0.0) * e)
    z_mid = max(lo[2], td[2]) + sh
    p3_z = fmaf(fmaf(-td[2], f(22.0), fmaf(z_mid, f(64.0), -(lo[2] * f(22.0)))), f(0.05),
                -(e[2] * f(0.3)))
    p3 = np.array([(lo[0] + td[0]) * f(0.5), (lo[1] + td[1]) * f(0.5), p3_z], f)
    cp = np.stack([lo, fmaf(e, f(1.0 / 6.0), lo), fmaf(f(1.0 / 3.0), e, lo), p3, td, td, td])

    def basis_sum(w):
        acc = np.zeros(3, f)
        for i in range(7):
            acc = fmaf(w[i], cp[i], acc)
        return acc

    return basis_sum(b), basis_sum(db) / per, basis_sum(d2b) / (per * per)


def explicit_swing_refs_f32(swing_time, swing_period, step_height, lift_off, touch_down):
    """One leg's two chained cubic Beziers, each (3,) float32, with the bits of the
    JAX package's jitted float32 ``explicit_swing_refs`` on the CPU."""
    f = F32
    t, per, sh = f(swing_time), f(swing_period), f(step_height)
    lo, td = np.asarray(lift_off, f).reshape(3), np.asarray(touch_down, f).reshape(3)
    half = per * f(0.5)
    apex = np.array([(lo[0] + td[0]) * f(0.5), (lo[1] + td[1]) * f(0.5),
                     max(lo[2], td[2]) + sh], f)
    tc = np.clip(t, f(0.0), per)
    first = tc < half
    t1 = np.clip(tc / half, f(0.0), f(1.0))
    t2 = np.clip((tc - half) / half, f(0.0), f(1.0))

    def cubic(a, b, tt):
        d = b - a
        return (fmaf(d, (tt * tt) * (f(3.0) - f(2.0) * tt), a),
                d * ((f(6.0) * tt) * (f(1.0) - tt)), d * fmaf(f(-12.0), tt, f(6.0)))

    p, v, a = cubic(lo, apex, t1) if first else cubic(apex, td, t2)
    return p, v / half, a / (half * half)


def swing_refs_np(generator, swing_time, swing_period, step_height, lift_off, touch_down,
                  liftoff_boost: float = 0.0, v0=None, v0_mask=None):
    """All-leg swing references for the whole-body layer: args (4,) / (4, 3),
    per-leg periods allowed."""
    if generator == "explicit":
        return explicit_swing_refs(swing_time, swing_period, step_height, lift_off, touch_down)
    return bezier_swing_refs(swing_time, swing_period, step_height, lift_off, touch_down,
                             liftoff_boost, v0, v0_mask)


def swing_cartesian_torque(des_pos, des_vel, des_acc, foot_pos, foot_vel, J, J_dot,
                           q_dot, h, mass_matrix, kp, kd, feedback_linearization=True):
    """Cartesian swing-tracking torque for one leg:
    tau = J^T (Kp e_p + Kd e_v) [+ M J^+ (a_des + Kp e_p + Kd e_v - J_dot q_dot) + h]
    (reference swing_trajectory_controller.py:83-91), with a damped inverse."""
    e_p = np.asarray(des_pos).reshape(3) - np.asarray(foot_pos).reshape(3)
    e_v = np.asarray(des_vel).reshape(3) - np.asarray(foot_vel).reshape(3)
    fb = kp * e_p + kd * e_v
    Jm = np.asarray(J)
    tau = Jm.T @ fb
    if feedback_linearization:
        acc = np.asarray(des_acc).reshape(3) + fb
        Jinv = Jm.T @ np.linalg.inv(Jm @ Jm.T + 2e-3 * np.eye(3))
        tau = tau + np.asarray(mass_matrix) @ Jinv @ (
            acc - np.asarray(J_dot) @ np.asarray(q_dot).reshape(3)) + np.asarray(h).reshape(3)
    return tau


class SwingTrajectoryController:
    """Host-side swing clocks, events and torques (reference
    helpers/swing_trajectory_controller.py:4-165)."""

    def __init__(self, step_height, swing_period, position_gain_fb, velocity_gain_fb,
                 generator: str = "bezier_ref", reflex_max_step_height: float | None = None,
                 liftoff_boost: float = 0.0):
        self.generator = "bezier_ref" if generator == "scipy" else generator
        self.step_height = step_height
        self.swing_period = swing_period
        self.position_gain_fb = position_gain_fb
        self.velocity_gain_fb = velocity_gain_fb
        self.reflex_max_step_height = (
            reflex_max_step_height if reflex_max_step_height is not None else 1.6 * step_height)
        self.liftoff_boost = liftoff_boost
        self.swing_time = [0.0, 0.0, 0.0, 0.0]
        self.use_feedback_linearization = True
        self.use_friction_compensation = True
        self.rising_edge_detected = False
        # Mid-swing re-targets: re-plan the remaining swing from this point, with an
        # optional start velocity and apex height.
        self.retarget_points: list = [None] * 4
        self.retarget_moments = [-1.0] * 4
        self.retarget_vels: list = [None] * 4
        self.retarget_apexes: list = [None] * 4

    def retarget(self, leg_id, from_point, at_moment, velocity=None, apex=None):
        """Re-plan leg_id's remaining swing from ``from_point`` (reached
        ``at_moment`` into the swing) toward the touchdown target."""
        self.retarget_points[leg_id] = np.asarray(from_point, np.float64).copy()
        self.retarget_moments[leg_id] = float(at_moment)
        self.retarget_vels[leg_id] = (None if velocity is None
                                      else np.asarray(velocity, np.float64).copy())
        self.retarget_apexes[leg_id] = None if apex is None else float(apex)

    def regenerate_swing_trajectory_generator(self, step_height, swing_period):
        self.step_height = step_height
        self.swing_period = swing_period

    def compute_trajectory_references(self, swing_time, lift_off, touch_down, hitmoment=-1.0,
                                      hitpoint=None, hit_step_height=None, hit_velocity=None):
        """One leg's desired (pos, vel, acc), float32 as in the JAX package (its
        jitted float32 curves, ``bezier_swing_refs_f32``). With an early-stance
        hitpoint the curve restarts from it with a raised apex and the remaining
        time (reference scipy_swing_trajectory_generator.py:25-47)."""
        lift_off = np.asarray(lift_off, np.float64).reshape(3)
        touch_down = np.asarray(touch_down, np.float64).reshape(3)
        step_height, period, t, v0 = self.step_height, self.swing_period, swing_time, None
        if hitpoint is not None and hitmoment >= 0.0:
            lift_off = np.asarray(hitpoint, np.float64).reshape(3)
            step_height = (self.reflex_max_step_height if hit_step_height is None
                           else hit_step_height)
            period = max(self.swing_period - hitmoment, 1e-3)
            t = swing_time - hitmoment
            v0 = hit_velocity
        if self.generator == "explicit":
            return explicit_swing_refs_f32(t, period, step_height, lift_off, touch_down)
        return bezier_swing_refs_f32(t, period, step_height, lift_off, touch_down,
                                     self.liftoff_boost, v0)

    def compute_swing_control_cartesian_space(self, leg_id, q_dot, J, J_dot, lift_off,
                                              touch_down, foot_pos, foot_vel, h, mass_matrix,
                                              early_stance_hitmoment=-1.0,
                                              early_stance_hitpoint=None):
        hm, hp, hit_sh, hit_v = early_stance_hitmoment, early_stance_hitpoint, None, None
        if hp is None and self.retarget_points[leg_id] is not None:
            hm, hp = self.retarget_moments[leg_id], self.retarget_points[leg_id]
            hit_sh = (self.step_height if self.retarget_apexes[leg_id] is None
                      else self.retarget_apexes[leg_id])
            hit_v = self.retarget_vels[leg_id]
        des_pos, des_vel, des_acc = self.compute_trajectory_references(
            self.swing_time[leg_id], lift_off, touch_down, hm, hp, hit_sh, hit_v)
        tau = swing_cartesian_torque(des_pos, des_vel, des_acc, foot_pos, foot_vel, J, J_dot,
                                     q_dot, h, mass_matrix, self.position_gain_fb,
                                     self.velocity_gain_fb, self.use_feedback_linearization)
        return tau, des_pos, des_vel

    def update_swing_time(self, current_contact, dt):
        for leg in range(4):
            if current_contact[leg] == 0:
                if self.swing_time[leg] < self.swing_period:
                    self.swing_time[leg] += dt
            else:
                self.swing_time[leg] = 0.0
                self.retarget_points[leg] = None
                self.retarget_moments[leg] = -1.0
                self.retarget_vels[leg] = None
                self.retarget_apexes[leg] = None

    def check_apex_condition(self, current_contact, interval=0.02, phase=0.5):
        """1 when any swing leg is within +-interval of ``phase``*period into its swing."""
        mid = self.swing_period * phase
        for leg in range(4):
            if current_contact[leg] == 0 and abs(self.swing_time[leg] - mid) < interval:
                return 1
        return 0

    def check_full_stance_condition(self, current_contact):
        return int(all(c != 0 for c in current_contact))

    def check_touch_down_condition(self, current_contact, previous_contact, contact_sequence,
                                   lookahead=3):
        """Rising-edge + stable-stance detector gating gait optimization
        (reference swing_trajectory_controller.py:148-165)."""
        if np.all(np.asarray(current_contact) == 1) and \
                not np.all(np.asarray(previous_contact) == 1):
            self.rising_edge_detected = True
        stable = np.all(contact_sequence[:, 0:lookahead] == 1)
        next_lift = not np.all(contact_sequence[:, lookahead] == 1)
        if self.rising_edge_detected and stable and next_lift:
            self.rising_edge_detected = False
            return 1
        return 0
