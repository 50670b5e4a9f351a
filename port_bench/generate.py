"""The benchmark's traffic generators: every input a run hands the program and the
reference, drawn from ``--seed`` and the parameters of a traffic file.

* ``FleetEpisodes``: the scenario fleet's episodes. Each episode draws, for every
  scenario, a perlin heightfield (two octaves of value noise, bilinearly upsampled,
  scaled to ``terrain.height_m`` and blended in from a flat spawn pad), a spawn pose
  near the corridor's start and a Philox seed, on the card from a ``torch.Generator``
  seeded by the run's seed, in a few large calls.
* ``trot_stream``: one robot's calls to the gradient MPC. Call i draws the base
  pose and velocity around the trot's reference and the feet at their stance
  offsets from a numpy generator; its contact sequence follows the trot's timing,
  advanced one MPC period a call.

The robot's geometry and the gait's timing come from the frozen copy of the
configuration (``reference/frozen/config.py``) for the configuration's arguments.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference.frozen.config import GAIT_PHASE_OFFSETS, make_config
from .reference.frozen.gait.periodic import contact_sequence, make_timer_dts

SEED_MASK = (1 << 63) - 1


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of a linear resize along one axis: half-pixel
    sample positions, the triangle kernel, each column normalized by its sum."""
    f = np.float32
    sample = (np.arange(n_out, dtype=f) + f(0.5)) * f(n_in / n_out) - f(0.5)
    w = np.maximum(f(0.0), f(1.0) - np.abs(sample[None, :] - np.arange(n_in, dtype=f)[:, None]))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(total > 0, w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f(0.0)).astype(f)


def terrain_grid(geom: dict, device) -> tuple:
    """World x and y (R, C) of every heightfield cell of the traffic's geometry."""
    R, C, res = int(geom["rows"]), int(geom["cols"]), float(geom["res"])
    cx, cy = (float(c) for c in geom["center"])
    i = (np.arange(R) - (R - 1) / 2) * res + cx
    j = (np.arange(C) - (C - 1) / 2) * res + cy
    gx = np.broadcast_to(i[:, None], (R, C)).astype(np.float32)
    gy = np.broadcast_to(j[None, :], (R, C)).astype(np.float32)
    return torch.as_tensor(gx, device=device), torch.as_tensor(gy, device=device)


class FleetEpisodes:
    """Episode inputs of an S-scenario fleet on ``device``, drawn in order from one
    generator seeded with the run's seed: ``draw()`` returns a dict of tensors
    (``terrain`` (S, R, C), ``x`` (S, 12), ``feet`` (S, 4, 3), ``seed`` (S,) int64)."""

    def __init__(self, make_config_args: dict, traffic: dict, seed: int, device):
        cfg = make_config(**make_config_args)
        self.dev = torch.device(device)
        self.S = int(traffic["scenarios"])
        self.geom = traffic["terrain"]
        self.spawn = traffic["spawn"]
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(int(seed) & SEED_MASK)
        self.gx, self.gy = terrain_grid(self.geom, self.dev)
        R, C = self.gx.shape
        self.octaves = [(int(n), float(a)) for n, a in self.geom["octaves"]]
        self.resize = {n: (torch.as_tensor(linear_resize_matrix(n, R), device=self.dev),
                           torch.as_tensor(linear_resize_matrix(n, C), device=self.dev))
                       for n, _ in self.octaves}
        rp = cfg.robot
        self.stance = torch.tensor([[rp.hip_x, rp.hip_y + 0.1, 0.0], [rp.hip_x, -rp.hip_y - 0.1, 0.0],
                                    [-rp.hip_x, rp.hip_y + 0.1, 0.0],
                                    [-rp.hip_x, -rp.hip_y - 0.1, 0.0]],
                                   dtype=torch.float32, device=self.dev)
        self.ref_z = float(cfg.sim.ref_z)
        self.phase = torch.tensor(GAIT_PHASE_OFFSETS[cfg.gait_params.gait_type],
                                  dtype=torch.float32, device=self.dev)

    def _uniform(self, shape, lo, hi):
        u = torch.rand(shape, generator=self.gen, device=self.dev)
        return u * (hi - lo) + lo

    def heights(self, S: int) -> torch.Tensor:
        g = self.geom
        h = 0.0
        for n, amp in self.octaves:
            wr, wc = self.resize[n]
            h = h + amp * (wr.T @ self._uniform((S, n, n), -1.0, 1.0) @ wc)
        lo = torch.amin(h, dim=(1, 2), keepdim=True)
        hi = torch.amax(h, dim=(1, 2), keepdim=True)
        h = float(g["height_m"]) * (h - lo) / (hi - lo + 1e-6)
        pad, blend = float(g["pad_x"]), float(g["blend_m"])
        return h * torch.clamp((self.gx - pad) / blend, 0.0, 1.0)

    def draw(self) -> dict:
        S, sp = self.S, self.spawn
        xy = self._uniform((S, 2), -float(sp["xy_m"]), float(sp["xy_m"]))
        x = torch.zeros(S, 12, device=self.dev)
        x[:, 0:2] = xy
        x[:, 2] = self.ref_z + self._uniform((S,), -float(sp["z_m"]), float(sp["z_m"]))
        feet = self.stance[None].expand(S, 4, 3).clone()
        feet[..., 0:2] += xy[:, None, :]
        seeds = torch.randint(0, 2 ** 62, (S,), generator=self.gen, device=self.dev,
                              dtype=torch.int64)
        return {"terrain": self.heights(S), "x": x, "feet": feet, "seed": seeds}


def trot_stream(make_config_args: dict, traffic: dict, seed: int):
    """Call i's (state, reference, contact sequence (4, H)) for i = 0, 1, ...: an
    endless generator, the same for the same seed."""
    cfg = make_config(**make_config_args)
    rng = np.random.default_rng(int(seed) & SEED_MASK)
    gait, rp = cfg.gait_params, cfg.robot
    t_off = make_timer_dts(cfg.mpc)
    period = 1.0 / cfg.sim.mpc_frequency
    vel = np.asarray(traffic["velocity"], np.float64)
    noise = traffic["noise"]
    stance = np.array([[rp.hip_x, rp.hip_y + 0.1, 0.0], [rp.hip_x, -rp.hip_y - 0.1, 0.0],
                       [-rp.hip_x, rp.hip_y + 0.1, 0.0], [-rp.hip_x, -rp.hip_y - 0.1, 0.0]])
    step = vel * gait.stance_time / 2.0  # the Raibert offset of the next foothold
    offsets = np.asarray(GAIT_PHASE_OFFSETS[gait.gait_type], np.float32)
    i = 0
    while True:
        phase = np.mod(offsets + np.float32(i * period * gait.step_freq), np.float32(1.0))
        seq = contact_sequence(phase, gait.step_freq, gait.duty_factor, t_off)
        pos = np.array([0.0, 0.0, cfg.sim.ref_z]) + rng.normal(0.0, noise["position_m"], 3)
        lin = vel + rng.normal(0.0, noise["velocity_mps"], 3)
        rpy = rng.normal(0.0, noise["orientation_rad"], 3)
        ang = rng.normal(0.0, noise["angular_velocity_radps"], 3)
        feet = stance + np.concatenate([rng.normal(0.0, noise["feet_m"], (4, 2)),
                                        np.zeros((4, 1))], axis=1)
        feet[:, :2] += pos[:2]
        state = dict(position=pos, linear_velocity=lin, orientation=rpy, angular_velocity=ang)
        reference = dict(ref_position=np.array([pos[0], pos[1], cfg.sim.ref_z]),
                         ref_linear_velocity=vel.copy(), ref_orientation=np.zeros(3),
                         ref_angular_velocity=np.zeros(3))
        for leg, name in enumerate(("FL", "FR", "RL", "RR")):
            state[f"foot_{name}"] = feet[leg]
            reference[f"ref_foot_{name}"] = (stance[leg] + np.array([pos[0], pos[1], 0.0])
                                             + step * np.array([1.0, 1.0, 0.0]))[None]
        yield state, reference, seq
        i += 1
