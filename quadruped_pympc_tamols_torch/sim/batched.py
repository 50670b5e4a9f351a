"""Batched MuJoCo simulations: randomized episodes fanned out over host processes.

Counterpart of ``quadruped_pympc_tamols_tpu/sim/batched.py`` (reference
batched_simulations.py:22-89: processes of randomized, headless episodes with
success-rate and tracking-error aggregation). Each worker is a spawned process
that runs the port's ``run_simulation`` on the ``device`` it is handed: unlike
the JAX package, whose workers force the CPU for the TPU's sake, nothing here
switches device, so every worker solves on the card by default and on the CPU
only when the caller says so. For thousands of scenarios the on-device fleet
(``parallel/scenario_engine.py``) replaces process fan-out.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp

import numpy as np

from ..config import Config


@dataclasses.dataclass
class FleetStats:
    episodes: int
    success_rate: float
    mean_tracking_error: float
    std_tracking_error: float
    mean_distance: float


def _run_worker(args):
    """One worker's episodes: [(upright, mean velocity error, distance), ...]."""
    cfg, n_eps, duration, vel_range, friction_range, seed, device = args
    from .simulation import run_simulation

    results = run_simulation(cfg, num_episodes=n_eps, episode_duration_s=duration,
                             ref_base_lin_vel=("random", *vel_range),
                             friction_range=friction_range, seed=seed, device=device)
    return [(not r.fell, r.mean_vel_error, r.distance) for r in results]


def run_batched_simulations(cfg: Config, num_processes: int = 2,
                            episodes_per_process: int = 4,
                            episode_duration_s: float = 2.0,
                            vel_range=(0.1, 0.4), friction_range=(0.6, 1.0),
                            seed: int = 0, inline: bool = False,
                            device="cuda") -> FleetStats:
    """Randomized-episode success-rate harness (reference batched_simulations.py).

    Worker i runs ``episodes_per_process`` episodes from seed ``seed + i *
    episodes_per_process`` on ``device`` (``run_simulation``'s default, the
    card). With ``num_processes > 1`` the workers are spawned: call this under an
    ``if __name__ == "__main__":`` guard in scripts, or the re-imported main
    module fans out again. ``inline`` (or one process) runs them here."""
    device = str(device)
    jobs = [(cfg, episodes_per_process, episode_duration_s, vel_range, friction_range,
             seed + i * episodes_per_process, device) for i in range(num_processes)]
    if inline or num_processes == 1:
        all_results = [r for job in jobs for r in _run_worker(job)]
    else:
        with mp.get_context("spawn").Pool(num_processes) as pool:
            all_results = [r for chunk in pool.map(_run_worker, jobs) for r in chunk]
    ok = np.array([r[0] for r in all_results], dtype=float)
    err = np.array([r[1] for r in all_results])
    dist = np.array([r[2] for r in all_results])
    return FleetStats(episodes=len(all_results), success_rate=float(ok.mean()),
                      mean_tracking_error=float(err.mean()),
                      std_tracking_error=float(err.std()),
                      mean_distance=float(dist.mean()))
