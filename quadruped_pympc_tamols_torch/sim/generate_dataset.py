"""Dataset generation from simulation episodes.

Counterpart of ``quadruped_pympc_tamols_tpu/sim/generate_dataset.py`` (reference
simulation/generate_dataset.py:24-88): runs recorded episodes, saves one archive
an episode and re-exports a downsampled motion file (base pose and velocity,
feet and joints at a target rate) for imitation-learning consumers, with the
JAX package's file names, keys and layouts.
"""
from __future__ import annotations

import os

import numpy as np

from ..config import Config
from ..observability.logger import EpisodeLogger


def generate_dataset(cfg: Config, out_dir: str, num_episodes: int = 2,
                     episode_duration_s: float = 2.0, vel_range=(0.1, 0.4),
                     seed: int = 0, motion_rate_hz: float = 50.0,
                     h5: bool = False, device="cuda"):
    """Run recorded episodes on ``device``; writes ``episode_<i>.npz`` and
    ``motion_<i>.npz`` (and ``episode_<i>.h5`` with ``h5``, the reference's H5
    recording, simulation/generate_dataset.py:24-41). Returns the episode
    archives' paths."""
    from .simulation import run_simulation

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for ep in range(num_episodes):
        log_path = os.path.join(out_dir, f"episode_{ep}.npz")
        logger = EpisodeLogger(log_path)
        run_simulation(cfg, num_episodes=1, episode_duration_s=episode_duration_s,
                       ref_base_lin_vel=("random", *vel_range), seed=seed + ep,
                       logger=logger, device=device)
        logger.flush()
        if h5:
            logger.save_h5()
        paths.append(log_path)
        # The downsampled motion (reference :55-79 re-exports .npy motions).
        data = np.load(log_path)
        stride = max(1, int(round(1.0 / (motion_rate_hz * cfg.sim.dt))))
        motion = dict(fps=motion_rate_hz, time=data["time"][::stride],
                      base_pos=data["base_pos"][::stride],
                      base_ori_euler_xyz=data["base_ori_euler_xyz"][::stride],
                      base_lin_vel=data["base_lin_vel"][::stride],
                      base_ang_vel=data["base_ang_vel"][::stride],
                      feet_pos=data["feet_pos"][::stride],
                      joints_pos=data["joints_pos"][::stride])
        np.savez_compressed(os.path.join(out_dir, f"motion_{ep}.npz"), **motion)
    return paths
