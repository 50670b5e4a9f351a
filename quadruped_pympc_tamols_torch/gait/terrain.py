"""Terrain slope/height estimation from stance-foot geometry (host numpy).

Counterpart of ``quadruped_pympc_tamols_tpu/gait/terrain.py`` (reference
helpers/terrain_estimator.py:13-104): roll/pitch come from pairwise z-differences
of the (lift-off) foot positions in the horizontal frame, EMA-smoothed 0.99/0.01;
the terrain height is an EMA 0.2/0.8 of the mean foot z.
"""
from __future__ import annotations

import numpy as np

from ..utils.frames import yaw_rot3_np


def estimate_terrain_step(base_position, yaw, feet_pos, prev_roll, prev_pitch, prev_height,
                          roll_activated=False, pitch_activated=True):
    """One estimator update for one robot. feet_pos (4, 3) world, FL/FR/RL/RR.

    Returns the (roll, pitch, height) EMA states."""
    feet = np.asarray(feet_pos, np.float64)
    rel = (feet - np.asarray(base_position)[None, :]) @ yaw_rot3_np(yaw).T
    fl, fr, rl, rr = rel
    front_diff, back_diff = fl - fr, rl - rr
    left_diff, right_diff = fl - rl, fr - rr
    pitch = 0.5 * (np.arctan(abs(left_diff[2]) / abs(left_diff[0] + 0.001))
                   + np.arctan(abs(right_diff[2]) / abs(right_diff[0] + 0.001)))
    roll = 0.5 * (np.arctan(abs(front_diff[2]) / abs(front_diff[1] + 0.001))
                  + np.arctan(abs(back_diff[2]) / abs(back_diff[1] + 0.001)))
    if front_diff[2] * 0.5 + back_diff[2] * 0.5 < 0:
        roll = -roll
    if left_diff[2] * 0.5 + right_diff[2] * 0.5 > 0:
        pitch = -pitch
    new_roll = prev_roll * 0.99 + roll * 0.01 if roll_activated else 0.0
    new_pitch = prev_pitch * 0.99 + pitch * 0.01 if pitch_activated else 0.0
    new_height = prev_height * 0.2 + feet[:, 2].mean() * 0.8
    return float(new_roll), float(new_pitch), float(new_height)


estimate_terrain = estimate_terrain_step  # the JAX package's name for it


class TerrainEstimator:
    """Stateful wrapper mirroring the reference class."""

    def __init__(self):
        self.terrain_roll = 0.0
        self.terrain_pitch = 0.0
        self.terrain_height = 0.0
        self.roll_activated = False
        self.pitch_activated = True
        # Operator-commanded reference-pitch offset, added on top of the estimate.
        self.pitch_offset = 0.0

    def compute_terrain_estimation(self, base_position, yaw, feet_pos, current_contact=None):
        feet = np.asarray(feet_pos.data if hasattr(feet_pos, "data") else feet_pos)
        self.terrain_roll, self.terrain_pitch, self.terrain_height = estimate_terrain_step(
            base_position, yaw, feet, self.terrain_roll, self.terrain_pitch,
            self.terrain_height, self.roll_activated, self.pitch_activated)
        return (self.terrain_roll, self.terrain_pitch + self.pitch_offset, self.terrain_height)
