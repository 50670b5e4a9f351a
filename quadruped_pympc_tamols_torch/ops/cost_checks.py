"""How the sampling kernels' costs are held to their plain torch version, on the
card: one policy for ``chip_smoke.py`` and ``tests/test_torch_cuda_cases.py``.

Both versions run in float32; they differ by FMA contraction in the kernels and
by the order of each basis window's sums, so each sample's cost is held to
COST_RTOL of the plain one with a COST_ATOL floor (costs reach 1e3-1e6).

Over a long horizon a sample's rollout can turn chaotic (its body tips over),
and then float32 rounding in either order lands anywhere. Beyond DRIFT_H the
callers pass the plain version's float64 costs (``f64`` promotes its inputs),
and the samples split in two:

* conditioned: the plain float32 cost lies within CONDITIONED times the bound of
  the float64 one. Each is held per sample as above. At least MIN_CONDITIONED
  of the samples must be conditioned and at most MAX_SATURATED saturated (a
  NaN or Inf rollout, cost 1e6), or the input is degenerate and the check
  raises: on tied costs it would test nothing;
* chaotic: the rest. Where there are at least CHAOTIC_HELD of them, at each of
  F64_QUANTILES the kernel's relative gap to the float64 cost is at most
  F64_FACTOR times the plain float32 version's plus F64_FLOOR; fewer are
  reported, not held (a quantile of a handful of chaotic gaps is noise).

``standing_trot_tick`` is an input on which rollouts of 32-85 steps stay
finite and almost all conditioned under the solvers' own noise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..controllers.sampling.rollout import gravity_share
from .sampling_kernel import COST_SATURATION as SATURATION
from .sampling_kernel import TickInputs

COST_RTOL, COST_ATOL = 1e-4, 1e-2
DRIFT_H = 24
CONDITIONED = 0.1
MIN_CONDITIONED, MAX_SATURATED = 0.95, 0.05
CHAOTIC_HELD = 100
F64_QUANTILES, F64_FACTOR, F64_FLOOR = (0.5, 0.9), 2.0, 1e-6


def check_sample_costs(costs_k, costs_p, costs_64=None) -> dict:
    """Kernel costs (..., N) against the plain float32 ones on the same inputs, and
    with ``costs_64`` (the plain version's in float64) the split above. Raises
    AssertionError naming the first failure; returns the figures: the largest
    absolute error over the held samples and, with ``costs_64``, the conditioned
    and saturated shares, the chaotic count and their gap quantiles."""
    k, p = costs_k.double().flatten(), costs_p.double().flatten()
    err = (k - p).abs()
    bound = COST_ATOL + COST_RTOL * p.abs()
    held = torch.ones_like(p, dtype=torch.bool)
    out = {}
    if costs_64 is not None:
        r = costs_64.double().flatten()
        held = (p - r).abs() <= CONDITIONED * (COST_ATOL + COST_RTOL * r.abs())
        out = {"conditioned_share": float(held.double().mean()),
               "saturated_share": float((p == SATURATION).double().mean()),
               "chaotic": int((~held).sum())}
        if not out["saturated_share"] <= MAX_SATURATED:
            raise AssertionError(f"{out['saturated_share']:.4f} of the plain costs saturate at "
                                 f"{SATURATION:g} (at most {MAX_SATURATED}): a degenerate input")
        if not out["conditioned_share"] >= MIN_CONDITIONED:
            raise AssertionError(f"only {out['conditioned_share']:.4f} of the samples are "
                                 f"conditioned (at least {MIN_CONDITIONED}): a chaotic input")
        rest = ~held
        if int(rest.sum()):
            den = r[rest].abs().clamp(min=1.0)
            qs = torch.tensor(F64_QUANTILES, dtype=torch.float64, device=r.device)
            gk = torch.quantile((k[rest] - r[rest]).abs() / den, qs).tolist()
            gp = torch.quantile((p[rest] - r[rest]).abs() / den, qs).tolist()
            out["chaotic_gaps"] = {"quantiles": F64_QUANTILES, "kernel": gk, "plain": gp}
            if out["chaotic"] >= CHAOTIC_HELD:
                for q, a, b in zip(F64_QUANTILES, gk, gp):
                    if not a <= F64_FACTOR * b + F64_FLOOR:
                        raise AssertionError(f"at quantile {q} of the chaotic samples the "
                                             f"kernel's costs lie {a} off float64, the plain "
                                             f"version's {b}")
    bad = held & ~(err <= bound)
    if bool(bad.any()):
        i = int(torch.argmax(torch.where(bad, err - bound, torch.full_like(err, -1.0))))
        raise AssertionError(f"cost {i}: kernel {float(k[i])}, plain {float(p[i])} (bound "
                             f"{float(bound[i])})")
    out["max_abs_err"] = float(err[held].max())
    return out


def standing_trot_tick(cfg, horizon: int):
    """A trot at the gait's timing (1.4 Hz, duty 0.6, the diagonals half a cycle
    apart) with the base at rest 1 cm under its reference, above the nominal
    feet, forces at the gravity share."""
    state12 = np.zeros(12, np.float32)
    state12[2] = cfg.sim.ref_z - 0.01
    ref12 = np.zeros(12, np.float32)
    ref12[2] = cfg.sim.ref_z
    feet = np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0], [-0.25, 0.15, 0.0],
                     [-0.25, -0.15, 0.0]], np.float32)
    phase = np.array([0.0, 0.5, 0.5, 0.0])
    seq = (np.mod(phase[:, None] + 1.4 * 0.02 * np.arange(horizon), 1.0) < 0.6)
    seq = seq.astype(np.float32)
    share = gravity_share(torch.from_numpy(seq), cfg.robot.mass)[:, None].expand(horizon, 4)
    return TickInputs(state12, feet, ref12, seq, np.ascontiguousarray(share.numpy()))


def f64(x):
    """A float32 tensor, or the tensors of a NamedTuple or dataclass (a tick, a
    plan, SRB parameters), in float64; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.dtype == torch.float32 else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(f64(v) for v in x))
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: f64(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x
