"""The work of one iteration of kernel K1f (random sampling) for S scenarios of N
samples, by the algorithm's own count from the configuration's shapes:

* per sample, one FMA per nonzero of the parametrization's basis (the dense
  step-major basis of ``reference/frozen/controllers/sampling/splines.py``, not the
  kernel's window layout), ~250 flops per rollout step (force model, torques,
  rotations, gyroscopic term, Euler update, cost) and one compare for the argmin;
* per parameter of a sample, ~30 flops for a Box-Muller normal (the two normal
  bands) or 3 for a uniform draw (the uniform band), none for sample 0, the
  incumbent; Philox's integer rounds are not floating-point work and are not
  counted;
* bytes: the basis's nonzero weights once, and per scenario its tick inputs
  (state, feet, reference: 36 floats; contact and share: 8 H), seed and offset (16
  bytes) and incumbent (P) read once, its N costs and its packed result (26 + P)
  written once.
"""
from __future__ import annotations

import numpy as np

from ..reference.frozen.controllers.sampling.splines import make_step_major_basis
from ..reference.philox import band_edges
from .peaks import least_seconds

STEP_FLOPS = 250
NORMAL_FLOPS = 30
UNIFORM_FLOPS = 3


def random_sampling_work(cfg, S: int, N: int) -> tuple:
    """(flops, bytes) of one K1f random-sampling iteration; ``cfg`` a Config."""
    sp, H = cfg.mpc.sampling, cfg.mpc.horizon
    W = make_step_major_basis(sp.parametrization, H, sp.num_splines)
    nnz, P = int(np.count_nonzero(W)), W.shape[1]
    b1, b2 = band_edges(N)
    per_scenario = N * (2 * nnz + STEP_FLOPS * H + 1) \
        + P * (NORMAL_FLOPS * (b2 - 1) + UNIFORM_FLOPS * (N - b2))
    nbytes = 4 * nnz + S * (4 * (36 + 8 * H + P + N + 26 + P) + 16)
    return S * per_scenario, nbytes


def least_time(cfg, S: int, N: int) -> tuple:
    """(seconds, bound) of one K1f random-sampling iteration on an H100."""
    return least_seconds(*random_sampling_work(cfg, S, N))
