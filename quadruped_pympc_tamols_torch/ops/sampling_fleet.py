"""Sampling iterations with a scenario axis: CUDA kernel K1f, its plain version and
wrapper.

The scenario fleet (``parallel/scenario_engine.py``) solves S independent MPC
problems a tick, one a scenario, as the JAX fleet ``jax.vmap``s the XLA solver
(JAX ``parallel/scenario_engine.py:220, 273``). K1a-K1c solve one problem a launch
with the tick's inputs in the launch's by-value argument block, so S scenarios
would cost S launches and S host round trips. K1f (``csrc/sampling_fleet.cu``)
gives the passes a scenario axis instead: one rollout launch whose blocks stage
their scenario's row of a device buffer [state | effective feet | reference |
contact (H, 4) | share (H, 4)] and its Philox seed and offset, then one
extraction (random sampling) or update pass (MPPI, CEM-MPPI) launch over all S.
Nothing of a tick crosses to or from the host, so a fleet tick can be one CUDA
graph. K1f replaces no Pallas kernel; see the source for its design.

K1f has two layouts, one int of its C entry, and the wrapper picks one from S *
N (``fleet_layout``): below ``CROSSOVER`` the four-lane rollout of K1a (grid
(ceil(N/16), S)) and an update pass that reads back the (S, P, N) noise the
rollout wrote; from it the large-batch layout (``LARGE_BATCH``): one thread a
sample in blocks of ``wide_samples(P)`` samples of one scenario, and an update
pass that draws each nonzero-weight sample's noise again from its Philox
counter, so that no (S, P, N) buffer exists. Both form the basis product on each
row's window of nonzero weights (the plan's ``windows``, ``rs.basis_windows``)
and give the same bits on finite inputs.

``fleet_iteration`` is the wrapper: on CUDA tensors it launches K1f (adding one
to ``fleet_iteration.launches[method]`` for the four-lane layout and
``fleet_iteration.launches_wide[method]`` for the large-batch rollout, through
``utils.graphs.count_launch``, so that a launch captured into a CUDA graph counts
at each replay) or raises; on CPU tensors it runs
``fleet_iteration_reference``, the plain torch version (the batched rollout of
``controllers/sampling/rollout.py`` and each scenario's argmin, softmax and
elites), with each scenario's noise from ``cpu_generator(seed, offset)``. There
is no fallback from one to the other, nor from one layout to the other.

For a sample-sharded fleet (``parallel/sharded.py``) K1f takes the plan's
``draw_col0``, as K1a-K1c do: sample 0 of every scenario draws noise.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..controllers.sampling.rollout import apply_force_model_rows, rollout_costs_soa
from ..dynamics.srbd import integrate_euler
from ..utils.graphs import count_launch
from . import build
from . import sampling_kernel as rs
from . import sampling_softmax as sm

METHODS = sm.METHODS

# The layout bits of the C entry (FLEET_WIDE, FLEET_REGEN in sampling_fleet.cu;
# every library's getters are checked against them): 0 is the four-lane rollout
# with the noise read back.
FOUR_LANE = 0
WIDE = 1  # the rollout pass one thread a sample (fleet_rollout_wide_kernel)
REGEN = 2  # the update pass draws the noise again from Philox instead of reading it
LARGE_BATCH = WIDE | REGEN
WIDE_SAMPLES = 128  # samples a block of the large-batch rollout up to P = 288 (FLEET_WIDE_SAMPLES)
# S * N from which fleet_iteration runs LARGE_BATCH: 192 scenarios of 128 samples.
# chip_smoke.py phase 25's crossover sweep (one H100 80GB HBM3, 700.00 W; device
# us of an iteration's two passes in each layout, random sampling and MPPI, at
# S x N from 64 x 128 to 64 x 10 000): the four-lane layout is faster at 64 x 128
# (20.2 / 24.7 us against 25.9 / 31.2), the two tie at 128 x 128, and from 192 x
# 128 on the large-batch one is faster for both (30.7 / 40.1 against 40.9 / 48.0).
CROSSOVER = 24_576


def fleet_layout(num_scenarios: int, num_samples: int) -> int:
    """The layout ``fleet_iteration`` runs for S scenarios of N samples: the
    four-lane one below ``CROSSOVER`` samples in all, where a launch fills the
    card about once and K1a's latency-bound design is the faster; the
    large-batch one from it."""
    return LARGE_BATCH if num_scenarios * num_samples >= CROSSOVER else FOUR_LANE


def wide_samples(num_parameters: int) -> int:
    """Samples a block of the large-batch rollout (``fleet_wide_samples``): its
    parameters take at most WIDE_SAMPLES * 288 floats of shared memory, so
    WIDE_SAMPLES up to P = 288 and fewer whole warps above (32 at P = 1024)."""
    fit = WIDE_SAMPLES * 288 // num_parameters
    return WIDE_SAMPLES if fit >= WIDE_SAMPLES else max(32, fit // 32 * 32)


class FleetArgs(ctypes.Structure):
    """Mirror of ``struct FleetArgs`` in sampling_fleet.cu (checked against its size)."""

    _fields_ = [("num_scenarios", ctypes.c_int), ("scen_stride", ctypes.c_int),
                ("inc_stride", ctypes.c_int), ("iteration", ctypes.c_int),
                ("part_stride", ctypes.c_int), ("key_stride", ctypes.c_int)]


class FleetTick(NamedTuple):
    """One tick's inputs for S scenarios, float32 tensors on one device."""

    state12: torch.Tensor  # (S, 12)
    feet: torch.Tensor  # (S, 4, 3) effective feet (swing feet already substituted)
    ref12: torch.Tensor  # (S, 12)
    contact_seq: torch.Tensor  # (S, 4, H)
    share: torch.Tensor  # (S, H, 4) per-leg gravity shares


def row_floats(horizon: int) -> int:
    """Floats of a scenario's row of the tick buffer (``FLEET_ROW``)."""
    return 36 + 8 * horizon


def tick_buffer(tick: FleetTick) -> torch.Tensor:
    """(S, 36 + 8H) rows [state | feet | ref | contact (H, 4) step-major | share
    (H, 4)], the kernel's per-scenario input; one device concatenation."""
    S = tick.state12.shape[0]
    return torch.cat([tick.state12, tick.feet.reshape(S, 12), tick.ref12,
                      tick.contact_seq.transpose(1, 2).reshape(S, -1),
                      tick.share.reshape(S, -1)], dim=1).contiguous()


class FleetWorkspace(NamedTuple):
    """One iteration's outputs and scratch for S scenarios on the card."""

    costs: torch.Tensor  # (S, N)
    out: torch.Tensor  # (S, 26 + P) packed as K1a's out
    sigma: torch.Tensor | None  # (S, P) CEM refit
    elites: torch.Tensor | None  # (S, K) int32 CEM elite indices
    argmin: torch.Tensor  # (2 S,) int64: each scenario's argmin key and ticket
    partials: torch.Tensor | None  # (S, part_stride) float32 (MPPI, CEM)
    keys: torch.Tensor | None  # (S, key_stride) int64 (CEM)
    # (S, P, N) the noise the rollout pass drew (MPPI, CEM): what a read-back
    # update reads, or kept for a caller that asks for it; None otherwise
    noise: torch.Tensor | None


def _strides(num_samples: int, num_parameters: int, knobs) -> tuple:
    """(part_stride, key_stride): a scenario's partials rounded up to 4 floats and
    its block keys to an even count, so that every scenario's start stays 16-byte
    aligned for the update pass's cp.async."""
    B = -(-num_samples // sm.BLOCK)
    part = B * (num_parameters + 1)
    keys = B * knobs.n_elite if knobs.cem and knobs.n_elite <= sm.LIST_ELITE else 0
    return part + (-part) % 4, keys + keys % 2


def fleet_workspace(plan: rs.RSPlan, knobs, num_scenarios: int, device, layout: int | None = None,
                    keep_noise: bool = False) -> FleetWorkspace:
    """Outputs and scratch of ``fleet_iteration`` in ``layout`` (``fleet_layout``'s
    choice if None). The (S, P, N) noise buffer exists for MPPI and CEM only where
    the update pass reads the noise back (a layout without REGEN) or the caller
    asks to keep the noise the rollout drew (``keep_noise``)."""
    S, P, N = num_scenarios, plan.num_parameters, plan.num_samples
    part, keys = _strides(N, P, knobs)
    softmax, cem = knobs.method != "random_sampling", knobs.cem
    if layout is None:
        layout = fleet_layout(S, N)
    noise = softmax and (keep_noise or not layout & REGEN)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    return FleetWorkspace(
        f32(S, N), f32(S, rs.OUT_WINNER + P), f32(S, P) if cem else None,
        torch.empty(S, knobs.n_elite, dtype=torch.int32, device=device) if cem else None,
        torch.empty(2 * S, dtype=torch.int64, device=device),
        f32(S, part) if softmax else None,
        torch.empty(S, keys, dtype=torch.int64, device=device) if cem else None,
        f32(S, P, N) if noise else None)


# -- the plain version ------------------------------------------------------------

class FleetResult(NamedTuple):
    costs: torch.Tensor  # (S, N)
    out: torch.Tensor  # (S, 26 + P) [best cost or beta, grf(12), state(12), index, params(P)]
    sigma: torch.Tensor | None  # (S, P) refit sigma (CEM), else None
    elites: torch.Tensor | None  # (S, K) elite indices (CEM), else None


def step0_batched(params, W, tick: FleetTick, dts, srbd, fm):
    """Step-0 GRFs (S, 4, 3) and one-step Euler states (S, 12) of parameters (S, P)."""
    raw0 = W[0:12] @ params.T  # (12, S)
    share0 = tick.share[:, 0, :].T  # (4, S)
    rows = apply_force_model_rows(raw0, tick.contact_seq[:, :, 0].T, share0, fm)
    grfs = torch.stack(rows, dim=-1).reshape(-1, 4, 3)
    nxt = integrate_euler(tick.state12, tick.feet, grfs, tick.contact_seq[:, :, 0], srbd,
                          float(np.float32(dts[0])))
    return grfs, nxt


def fleet_iteration_reference(plan: rs.RSPlan, knobs, tick: FleetTick, incumbent, sigma,
                              noise, costs=None) -> FleetResult:
    """Plain torch version of K1f: one iteration of ``knobs.method`` for every
    scenario on the given noise (S, P, N) (column 0 the incumbent's zero), the
    incumbents (S, P) and, for CEM, sigma (S, P). Each scenario's costs, argmin
    (lowest index on ties), softmax update, elites in (cost, index) order and refit
    follow K1a/K1b/K1c's plain versions.
    Given ``costs`` (S, N) (a kernel's own), only the optimizer step and the
    extraction run on them."""
    S, P, N = noise.shape
    H = plan.horizon
    params = incumbent[:, :, None] + noise
    if costs is None:
        raw = torch.matmul(plan.W, params).reshape(S, H, 12, N)
        costs = rollout_costs_soa(tick.state12, tick.feet, tick.ref12, raw, tick.contact_seq,
                                  tick.share, plan.dts, plan.q_diag, plan.srbd, plan.fm,
                                  rs.COST_SATURATION, zmp_weight=plan.zmp_weight,
                                  zmp_margin=plan.zmp_margin)
    best = torch.argmin(costs, dim=1)
    beta = costs.gather(1, best[:, None])[:, 0]
    new_sigma = elites = None
    if knobs.method == "random_sampling":
        new = params.gather(2, best[:, None, None].expand(S, P, 1))[..., 0]
    else:
        w = torch.exp(-(costs - beta[:, None]) / knobs.temperature)
        w = w / torch.sum(w, dim=1, keepdim=True)
        new = incumbent + torch.matmul(noise, w[:, :, None])[..., 0]
        if knobs.cem:
            elites = sm.cem_elites(costs, knobs.n_elite)
            picked = noise.gather(2, elites[:, None, :].expand(S, P, knobs.n_elite))
            var = torch.var(picked, dim=2, unbiased=True) + 1e-8
            new_sigma = torch.clamp(torch.sqrt(var), knobs.sigma_min, knobs.sigma_max)
    grfs, nxt = step0_batched(new, plan.W, tick, plan.dts, plan.srbd, plan.fm)
    out = torch.cat([beta[:, None], grfs.reshape(S, 12), nxt, best[:, None].to(new.dtype), new],
                    dim=1)
    return FleetResult(costs, out, new_sigma, elites)


def sample_noise(plan: rs.RSPlan, knobs, seeds, offsets, sigma=None) -> torch.Tensor:
    """(S, P, N) exploration noise on the CPU, scenario s from
    ``cpu_generator(seeds[s], offsets[s])``; the kernel draws the same distribution
    from Philox keyed on the same pair."""
    out = []
    for s, (seed, offset) in enumerate(zip(seeds.tolist(), offsets.tolist())):
        gen = rs.cpu_generator(seed, offset)
        if knobs.method == "random_sampling":
            out.append(rs.sample_noise_reference(plan, gen))
        else:
            out.append(sm.sample_noise_reference(plan.num_parameters, plan.num_samples, knobs,
                                                 gen, None if sigma is None else sigma[s],
                                                 plan.draw_col0))
    return torch.stack(out)


# -- the kernel ---------------------------------------------------------------------

_LIBS: dict = {}


def load_library(horizon: int, params_per_leg: int) -> ctypes.CDLL:
    """Build (if needed) and load the K1f library of the (horizon, parameters per
    leg) pair; raises on any failure, NotImplementedError for a pair beyond the
    kernels' bounds (``build.check_pair``)."""
    key = (horizon, params_per_leg)
    if key not in _LIBS:
        lib = build.load("sampling_fleet", horizon, params_per_leg)
        rs.int_getters(lib, ("fleet_args_size", "fleet_layout_size", "fleet_knobs_size",
                             "fleet_block", "fleet_rollout_samples", "fleet_list_elite",
                             "fleet_horizon", "fleet_params_per_leg", "fleet_row_floats",
                             "fleet_layout_wide", "fleet_layout_regen", "fleet_wide_samples",
                             "fleet_window", "fleet_window_bytes"))
        if (lib.fleet_args_size() != ctypes.sizeof(rs.args_type(horizon))
                or lib.fleet_layout_size() != ctypes.sizeof(FleetArgs)
                or lib.fleet_knobs_size() != ctypes.sizeof(sm.SMKnobs)
                or lib.fleet_block() != sm.BLOCK
                or lib.fleet_rollout_samples() != rs.ROLLOUT_SAMPLES
                or lib.fleet_list_elite() != sm.LIST_ELITE
                or (lib.fleet_horizon(), lib.fleet_params_per_leg()) != key
                or lib.fleet_row_floats() != row_floats(horizon)
                or (lib.fleet_layout_wide(), lib.fleet_layout_regen()) != (WIDE, REGEN)
                or lib.fleet_wide_samples() != wide_samples(4 * params_per_leg)
                or lib.fleet_window() != rs.WINDOW
                or lib.fleet_window_bytes() != 4 * rs.WINDOW_FLOATS):
            raise RuntimeError(f"sampling_fleet.cu for {key} and its ctypes mirror disagree")
        lib.fleet_error_string.restype = ctypes.c_char_p
        lib.fleet_error_string.argtypes = [ctypes.c_int]
        lib.fleet_launch.restype = ctypes.c_int
        lib.fleet_launch.argtypes = ([ctypes.POINTER(rs.RSArgs), ctypes.POINTER(FleetArgs),
                                      ctypes.POINTER(sm.SMKnobs), ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int] + [ctypes.c_void_p] * 16)
        _LIBS[key] = lib
    return _LIBS[key]


def _check(name, x, shape, dtype=torch.float32):
    if not (x.is_cuda and x.dtype == dtype and tuple(x.shape) == tuple(shape)
            and x.stride(-1) == 1):
        raise ValueError(f"{name} must be a CUDA {dtype} tensor of shape {shape} with unit "
                         f"inner stride, got {x.dtype} {tuple(x.shape)} on {x.device}")


def fleet_iteration(plan: rs.RSPlan, knobs, tick: FleetTick, incumbent: torch.Tensor,
                    sigma: torch.Tensor | None, seeds: torch.Tensor, offsets: torch.Tensor,
                    iteration: int = 0, noise_in: torch.Tensor | None = None,
                    ws: FleetWorkspace | None = None, scen: torch.Tensor | None = None,
                    layout: int | None = None):
    """One iteration of ``knobs.method`` for S scenarios, each around its incumbent
    (S, P) (rows may be strided, as ``out[:, 26:]`` of an earlier iteration is) with
    its Philox seed and ``offsets + iteration`` (seeds, offsets: (S,) int64).

    Returns ``(costs (S, N), out (S, 26 + P), sigma (S, P), elites (S, K))`` on
    the incumbent's device, ``out`` packed as K1a's; for CEM ``sigma`` is the
    refit and ``elites`` the elite indices, else the given ``sigma`` and None.
    ``noise_in`` (S, P, N) replaces the generated noise. On CUDA the outputs live
    in ``ws`` (``fleet_workspace``; a new one if None; the rollout writes the
    noise it drew into ``ws.noise`` where there is one), ``scen`` is the tick
    buffer (``tick_buffer(tick)`` if None) and ``layout`` the kernel's layout
    (``fleet_layout(S, N)`` if None; with ``noise_in`` the update reads it, so
    REGEN is dropped)."""
    S, P, N = incumbent.shape[0], plan.num_parameters, plan.num_samples
    if incumbent.device.type == "cpu":
        noise = noise_in if noise_in is not None else sample_noise(
            plan, knobs, seeds, offsets + iteration, sigma)
        res = fleet_iteration_reference(plan, knobs, tick, incumbent, sigma, noise)
        return res.costs, res.out, res.sigma if knobs.cem else sigma, res.elites
    if incumbent.device.type != "cuda":
        raise ValueError(f"unsupported device {incumbent.device}")
    sm.check_kernel_knobs(plan, knobs)
    _check("incumbent", incumbent, (S, P))
    if knobs.cem:
        _check("sigma", sigma, (S, P))
    _check("seeds", seeds, (S,), torch.int64)
    _check("offsets", offsets, (S,), torch.int64)
    if layout is None:
        layout = fleet_layout(S, N)
    if noise_in is not None:
        _check("noise_in", noise_in, (S, P, N))
        if not noise_in.is_contiguous():
            raise ValueError("noise_in must be contiguous")
        if ws is None:
            ws = fleet_workspace(plan, knobs, S, incumbent.device, layout | REGEN)
        layout &= ~REGEN
    if scen is None:
        scen = tick_buffer(tick)
    _check("scen", scen, (S, scen.shape[1]))
    if ws is None:
        ws = fleet_workspace(plan, knobs, S, incumbent.device, layout)
    if (knobs.method != "random_sampling" and not layout & REGEN and noise_in is None
            and ws.noise is None):
        raise ValueError("this layout's update pass reads the noise back: the workspace needs "
                         "its noise buffer (fleet_workspace with the same layout)")
    part, keys = _strides(N, P, knobs)
    fleet_args = FleetArgs(S, scen.stride(0), incumbent.stride(0), int(iteration), part, keys)
    args = rs.args_type(plan.horizon).from_buffer_copy(plan.args_template)

    def ptr(x):
        return None if x is None else x.data_ptr()

    lib = load_library(plan.horizon, plan.params_per_leg)
    rc = lib.fleet_launch(ctypes.byref(args), ctypes.byref(fleet_args),
                          ctypes.byref(knobs.struct()), METHODS.index(knobs.method),
                          plan.params_per_leg, int(layout),
                          plan.windows.data_ptr(), scen.data_ptr(), seeds.data_ptr(),
                          offsets.data_ptr(), incumbent.data_ptr(),
                          ptr(sigma) if knobs.cem else None, ptr(noise_in),
                          None if noise_in is not None else ptr(ws.noise), ws.costs.data_ptr(),
                          ws.argmin.data_ptr(), ptr(ws.partials), ptr(ws.keys), ws.out.data_ptr(),
                          ptr(ws.sigma), ptr(ws.elites),
                          torch.cuda.current_stream(incumbent.device).cuda_stream)
    if rc != 0:
        msg = ("unsupported shape, knob, layout or alignment" if rc < 0
               else lib.fleet_error_string(rc).decode())
        raise RuntimeError(f"sampling_fleet launch failed ({rc}): {msg}")
    count_launch(fleet_iteration.launches_wide if layout & WIDE else fleet_iteration.launches,
                 knobs.method)
    return ws.costs, ws.out, ws.sigma if knobs.cem else sigma, ws.elites


fleet_iteration.launches = dict.fromkeys(METHODS, 0)
fleet_iteration.launches_wide = dict.fromkeys(METHODS, 0)
