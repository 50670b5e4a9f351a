"""Offline analysis utilities (host numpy).

Counterpart of ``quadruped_pympc_tamols_tpu/utils/analysis.py`` (the reference's
offline ZMP-constraint-violation checker, helpers/quadruped_utils.py:101-241):
given a recorded trajectory (base states, feet positions, contact states and
GRFs), compute the ZMP and its margin to the support polygon per tick.
"""
from __future__ import annotations

import numpy as np


def zmp_from_grfs(base_pos, grfs, feet_pos, contact):
    """ZMP (xy) from per-leg ground reaction forces at the foot positions.

    zmp = sum_i c_i * (p_i,xy * f_i,z) / sum_i c_i * f_i,z (height-field-free form).
    """
    fz = grfs[:, 2] * contact
    denom = np.maximum(fz.sum(), 1e-6)
    return (feet_pos[:, :2] * fz[:, None]).sum(axis=0) / denom


def support_polygon_margin(point_xy, feet_pos, contact):
    """Signed distance from a point to the support polygon (positive = inside).

    With two stance feet the "polygon" is the segment between them: returns minus the
    distance to the segment. Mirrors the trot-stability geometry in the reference
    TAMOLS scorer (visual_foothold_adaptation.py:678-714).
    """
    stance = feet_pos[contact > 0.5][:, :2]
    n = len(stance)
    if n == 0:
        return -np.inf
    if n == 1:
        return -float(np.linalg.norm(point_xy - stance[0]))
    if n == 2:
        p1, p2 = stance
        v = p2 - p1
        t = np.clip(np.dot(point_xy - p1, v) / max(np.dot(v, v), 1e-9), 0.0, 1.0)
        return -float(np.linalg.norm(point_xy - (p1 + t * v)))
    # Convex hull margin: min signed distance over hull edges (CCW orientation).
    hull = _convex_hull(stance)
    margins = []
    for i in range(len(hull)):
        a, b = hull[i], hull[(i + 1) % len(hull)]
        e = b - a
        normal = np.array([e[1], -e[0]])
        nn = np.linalg.norm(normal)
        if nn < 1e-9:
            continue
        margins.append(-np.dot(point_xy - a, normal / nn))
    return float(min(margins)) if margins else -np.inf


def _convex_hull(pts):
    pts = sorted(map(tuple, pts))
    if len(pts) <= 2:
        return np.asarray(pts)

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2 and np.cross(np.subtract(out[-1], out[-2]),
                                             np.subtract(p, out[-2])) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(reversed(pts))
    return np.asarray(lower[:-1] + upper[:-1])


def check_zmp_violations(base_pos_hist, grfs_hist, feet_pos_hist, contact_hist,
                         margin: float = 0.0):
    """Per-tick ZMP support margins + violation mask for a recorded episode."""
    T = len(base_pos_hist)
    margins = np.zeros(T)
    for t in range(T):
        zmp = zmp_from_grfs(base_pos_hist[t], grfs_hist[t], feet_pos_hist[t],
                            contact_hist[t])
        margins[t] = support_polygon_margin(zmp, feet_pos_hist[t], contact_hist[t])
    return margins, margins < -abs(margin) if margin else margins < 0
