"""MPPI, CEM-MPPI and chained iterations: CUDA kernels K1b, K1c and K1d, their
plain version and wrappers.

The kernels K1b and K1c (``csrc/sampling_softmax.cu``) replace the mppi and
cem_mppi variants of the Pallas TPU kernel ``quadruped_pympc_tamols_tpu/ops/
rollout_pallas.py:make_pallas_iteration(...).kernel``, in the XLA solver's forms
(JAX ``controllers/sampling/sampling_mpc.py:166-176``): the new parameters are
``incumbent + noise @ w`` with softmax weights ``w = exp(-(c - beta)/T)``
normalized, ``beta`` the lowest cost; CEM-MPPI draws its noise with a
per-parameter sigma and refits it from the ``cem_elite`` lowest-cost samples'
noise (variance with ddof 1, + 1e-8, square root, clipped). The elites are
``jax.lax.top_k``'s set, the lowest index first on equal costs (any 2 <= K <= N);
the plain version lists them in (cost, index) order, the kernels too up to
``LIST_ELITE`` and in index order above it. One iteration is a memset and two
launches: the rollout pass and the update pass, whose blocks each sum their
samples' weighted noise and whose last block to arrive (an atomic ticket)
finishes the step; every sum runs in a fixed order, so a run repeats its bits. The step-0 GRFs and one-step state come from
the new parameters (the mean), not from a sample. See the source for the design.

K1d, chained iterations (``num_chained > 1`` in the Pallas kernel), is
``sampling_chain``: iteration i + 1 samples around iteration i's parameters, and
its sigma for CEM, with the Philox offset one higher. On the card, with more than
one iteration, every iteration of the three methods runs in one cooperative,
persistent launch (``csrc/sampling_chain.cu``: the rollout pass and the update
pass, or K1a's extraction, between grid barriers), with the bits of successive
K1a/K1b/K1c launches; each chained solve adds one to
``sampling_chain.launches[knobs.method]`` and nothing to the single iterations'
counts. One iteration stays a K1a/K1b/K1c launch.

The wrapper ``softmax_iteration`` runs K1b or K1c as ``knobs.method`` says and
counts each launch in ``softmax_iteration.launches[knobs.method]``. For a
sample-sharded solve (``parallel/sharded.py``) it takes ``merge_beta``: the C
entry then runs the rollout pass, the wrapper hands the shard's lowest cost to
``merge_beta`` (an all-reduce over the shards) and the update pass weighs the
samples by the beta it returns and hands back the unnormalized sums [S, Z] for
the next all-reduce; with the plan's ``draw_col0`` (``sampling_kernel.
with_drawn_column0``) sample 0 draws noise instead of being the incumbent. On CUDA
tensors the wrappers launch their kernel or raise; on CPU tensors they run the
plain version (``softmax_iteration_reference``, and for K1d the same loop over the
plain single iterations), with noise from ``cpu_generator(seed, offset)``. There
is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from ..config import Config
from ..controllers.sampling.rollout import ForceModelParams
from ..dynamics.srbd import SRBDParams
from . import build
from . import sampling_kernel as rs

BLOCK = 64  # samples per block of the update pass (RS_BLOCK): sizes the partials and keys
PHASE_ROLLOUT, PHASE_UPDATE = 1, 2  # SM_PHASE_*: the phases of an iteration a C entry runs
BOTH_PHASES = PHASE_ROLLOUT | PHASE_UPDATE
# SM_KMAX: up to this many CEM elites the update pass keeps per-block key lists
# and lists the elites in (cost, index) order; above it (up to N) a radix select
# over the N keys takes them, listed in index order.
LIST_ELITE = 32
METHODS = ("random_sampling", "mppi", "cem_mppi")  # the chain kernel's method codes 0, 1, 2


class SMKnobs(ctypes.Structure):
    """Mirror of ``struct SMKnobs`` in sampling_softmax.cu (checked against its size)."""

    _fields_ = [("cem", ctypes.c_int), ("n_elite", ctypes.c_int),
                ("temperature", ctypes.c_float), ("sigma_mppi", ctypes.c_float),
                ("sigma_min", ctypes.c_float), ("sigma_max", ctypes.c_float)]


@dataclasses.dataclass(frozen=True)
class Knobs:
    """The optimizer's constants (config ``mpc.sampling``)."""

    method: str  # "random_sampling", "mppi" or "cem_mppi"
    temperature: float
    sigma_mppi: float
    n_elite: int
    sigma_min: float
    sigma_max: float

    @property
    def cem(self) -> bool:
        return self.method == "cem_mppi"

    def struct(self) -> SMKnobs:
        return SMKnobs(int(self.cem), self.n_elite, self.temperature, self.sigma_mppi,
                       self.sigma_min, self.sigma_max)


def make_knobs(cfg: Config, method: str | None = None) -> Knobs:
    sp = cfg.mpc.sampling
    method = method or sp.method
    if method not in METHODS:
        raise ValueError(f"unknown sampling method {method!r}")
    return Knobs(method, float(sp.mppi_temperature), float(sp.sigma_mppi), int(sp.cem_elite),
                 float(sp.cem_sigma_min), float(sp.cem_sigma_max))


def check_kernel_knobs(plan: rs.RSPlan, knobs: Knobs) -> None:
    """Raise for what the CUDA kernels do not take: a pair beyond their bounds
    (``check_kernel_shape``), a temperature <= 0 (ValueError), or an elite count
    outside [2, N] (the variance of one elite has no ddof-1 estimate)."""
    rs.check_kernel_shape(plan)
    if knobs.method == "random_sampling":
        return
    if not knobs.temperature > 0.0:
        raise ValueError(f"sampling.mppi_temperature must be > 0, got {knobs.temperature}")
    if knobs.cem and not 2 <= knobs.n_elite <= plan.num_samples:
        raise NotImplementedError(f"CEM-MPPI takes 2 to {plan.num_samples} elites (the samples), "
                                  f"not {knobs.n_elite}")


# -- the plain version ------------------------------------------------------------

class SoftmaxResult(NamedTuple):
    costs: torch.Tensor  # (N,)
    beta: torch.Tensor  # 0-d, the lowest cost
    best_index: torch.Tensor  # 0-d int64, the first sample with cost beta
    new_params: torch.Tensor  # (P,)
    sigma: torch.Tensor | None  # (P,) refit sigma (CEM), else None
    elites: torch.Tensor | None  # (K,) elite indices in (cost, index) order (CEM), else None
    grfs: torch.Tensor  # (4, 3) step-0 GRFs of new_params
    next_state: torch.Tensor  # (12,) one-step Euler state under them


def softmax_sums(costs, noise, beta, temperature: float):
    """The unnormalized sums (S (P,), Z) of w = exp(-(c - beta)/T): S = noise @ w,
    Z = sum(w), for a caller that merges them over the shards of a solve."""
    w = torch.exp(-(costs - beta) / temperature)
    return noise @ w, torch.sum(w)


def mppi_update(costs, noise, incumbent, temperature: float):
    """(beta, incumbent + noise @ w) with w the normalized softmax weights
    exp(-(c - beta)/T) (JAX ``sampling_mpc.py:166-170``)."""
    beta = torch.min(costs)
    w = torch.exp(-(costs - beta) / temperature)
    w = w / torch.sum(w)
    return beta, incumbent + noise @ w


def cem_elites(costs, n_elite: int):
    """Indices of the ``n_elite`` lowest costs (..., N) -> (..., n_elite) in (cost,
    index) order: on equal costs the lowest index first, as
    ``jax.lax.top_k(-costs, n_elite)`` takes them."""
    return torch.argsort(costs, dim=-1, stable=True)[..., :n_elite]


def cem_refit(noise, elites, sigma_min: float, sigma_max: float):
    """Sigma from the elites' noise: sqrt(var (ddof 1) + 1e-8), clipped (JAX
    ``sampling_mpc.py:173-176``)."""
    var = torch.var(noise[:, elites], dim=1, unbiased=True) + 1e-8
    return torch.clamp(torch.sqrt(var), sigma_min, sigma_max)


def softmax_combine_reference(costs, noise, incumbent, W, state12, feet, contact_seq, share,
                              dts, srbd: SRBDParams, fm: ForceModelParams, knobs: Knobs,
                              beta=None, sums=None) -> SoftmaxResult:
    """The optimizer step of an MPPI / CEM-MPPI iteration on given costs (N,): the
    softmax update, for CEM the elites and the refit, and the step-0 GRFs and
    one-step state of the new parameters. With ``beta`` (a sharded solve's merged
    lowest cost) the weights are exp(-(c - beta)/T), the new parameters incumbent
    + S / Z as the kernel's finish forms them, and ``sums`` (P + 1), if given,
    receives [S, Z]; the result's beta stays the lowest of ``costs``."""
    if beta is None:
        beta, new_params = mppi_update(costs, noise, incumbent, knobs.temperature)
    else:
        S, Z = softmax_sums(costs, noise, beta, knobs.temperature)
        new_params = incumbent + S / Z
        beta = torch.min(costs)
        if sums is not None:
            sums.copy_(torch.cat([S, Z.reshape(1)]))
    sigma = elites = None
    if knobs.cem:
        elites = cem_elites(costs, knobs.n_elite)
        sigma = cem_refit(noise, elites, knobs.sigma_min, knobs.sigma_max)
    grfs, next_state = rs.step0_reference(new_params, W, state12, feet, contact_seq, share, dts,
                                          srbd, fm)
    return SoftmaxResult(costs, beta, torch.argmin(costs), new_params, sigma, elites, grfs,
                         next_state)


def softmax_iteration_reference(noise, incumbent, W, state12, feet, ref12, contact_seq, share,
                                dts, q_diag, srbd: SRBDParams, fm: ForceModelParams,
                                knobs: Knobs, zmp_weight: float = 0.0,
                                zmp_margin: float = 0.04) -> SoftmaxResult:
    """Plain torch version of kernels K1b (``knobs.method == "mppi"``) and K1c
    (``"cem_mppi"``): one iteration on the given noise.

    Arguments as ``sampling_iteration_reference``: noise (P, N) (column 0 the
    incumbent's zero), incumbent (P,), W (H*12, P), the tick's tensors on one
    device, dts and q_diag host arrays."""
    costs = rs.rollout_costs_reference(incumbent[:, None] + noise, W, state12, feet, ref12,
                                       contact_seq, share, dts, q_diag, srbd, fm, zmp_weight,
                                       zmp_margin)
    return softmax_combine_reference(costs, noise, incumbent, W, state12, feet, contact_seq,
                                     share, dts, srbd, fm, knobs)


def sample_noise_reference(num_parameters: int, num_samples: int, knobs: Knobs,
                           generator: torch.Generator, sigma=None,
                           draw_col0: bool = False) -> torch.Tensor:
    """(P, N) MPPI / CEM exploration noise on the CPU, column 0 zero (reference
    centroidal_nmpc_jax.py:804-812, :951-958) or, with ``draw_col0``, drawn as
    the others; the kernels draw the same distribution from Philox."""
    P, N = num_parameters, num_samples
    scale = sigma.cpu()[:, None] if knobs.cem else knobs.sigma_mppi
    z = torch.randn(P, N - 1, generator=generator) * scale
    col0 = torch.randn(P, 1, generator=generator) * scale if draw_col0 else torch.zeros(P, 1)
    return torch.cat([col0, z], dim=1)


def _plain(plan, knobs, tick, incumbent, sigma, seed, offset, noise_in, noise_out,
           merge_beta=None, sums=None):
    noise = noise_in if noise_in is not None else sample_noise_reference(
        plan.num_parameters, plan.num_samples, knobs, rs.cpu_generator(seed, offset), sigma,
        plan.draw_col0)
    if noise_out is not None:
        noise_out.copy_(noise)
    state12, feet, ref12, contact, share = rs.tick_tensors(tick, incumbent.device)
    costs = rs.rollout_costs_reference(incumbent[:, None] + noise, plan.W, state12, feet, ref12,
                                       contact, share, plan.dts, plan.q_diag, plan.srbd, plan.fm,
                                       plan.zmp_weight, plan.zmp_margin)
    beta = None if merge_beta is None else merge_beta(torch.min(costs).reshape(1))[0]
    res = softmax_combine_reference(costs, noise, incumbent, plan.W, state12, feet, contact,
                                    share, plan.dts, plan.srbd, plan.fm, knobs, beta, sums)
    out = rs.pack_result(res.beta, res.grfs, res.next_state, res.best_index, res.new_params)
    return res.costs, out, res.sigma, res.elites


# -- the kernels ----------------------------------------------------------------------

_LIBS: dict = {}


def load_library(horizon: int, params_per_leg: int) -> ctypes.CDLL:
    """Build (if needed) and load the K1b/K1c library of the (horizon, parameters
    per leg) pair; raises on any failure, NotImplementedError for a pair beyond
    the kernels' bounds (``build.check_pair``)."""
    key = (horizon, params_per_leg)
    if key not in _LIBS:
        lib = build.load("sampling_softmax", horizon, params_per_leg)
        rs.int_getters(lib, ("sm_args_size", "sm_knobs_size", "sm_block", "sm_rollout_samples",
                             "sm_list_elite", "sm_horizon", "sm_params_per_leg",
                             "sm_window_bytes", "sm_phase_rollout", "sm_phase_update"))
        if (lib.sm_args_size() != ctypes.sizeof(rs.args_type(horizon))
                or (lib.sm_phase_rollout(), lib.sm_phase_update()) != (PHASE_ROLLOUT,
                                                                        PHASE_UPDATE)
                or lib.sm_knobs_size() != ctypes.sizeof(SMKnobs)
                or lib.sm_block() != BLOCK or lib.sm_rollout_samples() != rs.ROLLOUT_SAMPLES
                or lib.sm_list_elite() != LIST_ELITE
                or (lib.sm_horizon(), lib.sm_params_per_leg()) != key
                or lib.sm_window_bytes() != 4 * rs.WINDOW_FLOATS):
            raise RuntimeError(f"sampling_softmax.cu for {key} and its ctypes mirror disagree")
        lib.sm_error_string.restype = ctypes.c_char_p
        lib.sm_error_string.argtypes = [ctypes.c_int]
        lib.sm_update_blocks_per_sm.restype = ctypes.c_int
        lib.sm_update_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.sm_launch.restype = ctypes.c_int
        lib.sm_launch.argtypes = ([ctypes.POINTER(rs.RSArgs), ctypes.POINTER(SMKnobs),
                                   ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int]
                                  + [ctypes.c_void_p] * 3)
        _LIBS[key] = lib
    return _LIBS[key]


def update_blocks_per_sm(plan: rs.RSPlan, knobs: Knobs) -> int:
    """Blocks of the update pass one SM of the card holds at once for ``plan``'s
    iteration (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = load_library(plan.horizon, plan.params_per_leg)
    n = lib.sm_update_blocks_per_sm(int(knobs.cem), knobs.n_elite, plan.num_samples)
    if n < 0:
        raise RuntimeError(f"sm_update_blocks_per_sm failed: {lib.sm_error_string(-n).decode()}")
    return n


class Workspace(NamedTuple):
    """One iteration's outputs and scratch on the card (the chain kernel's: each
    output with a leading axis of its iterations)."""

    costs: torch.Tensor  # (N,)
    out: torch.Tensor  # (26 + P,) [beta, grf(12), state(12), index, new params(P)]
    sigma: torch.Tensor | None  # (P,) CEM refit
    elites: torch.Tensor | None  # (K,) int32 CEM elite indices (index order above LIST_ELITE)
    # int64: [argmin, ticket | block keys (B*K, CEM; an even count) | partials
    # (B*(P+1) f32)]; the iteration's memset resets the first two words (the chain
    # kernel sets them itself).
    scratch: torch.Tensor
    # (P, N): the noise the rollout pass writes and the update pass reads back when
    # the caller passes neither noise_in nor noise_out (MPPI and CEM).
    noise: torch.Tensor | None


def _key_words(num_samples: int, knobs) -> int:
    """int64 words of the block keys: B*K for CEM with K <= LIST_ELITE, rounded up
    to even, so that the partials after them are 16-byte aligned (the update pass
    copies them with cp.async); none above LIST_ELITE."""
    n = -(-num_samples // BLOCK) * knobs.n_elite if knobs.cem and knobs.n_elite <= LIST_ELITE \
        else 0
    return n + n % 2


def workspace(plan: rs.RSPlan, knobs: Knobs, device, iterations: int | None = None) -> Workspace:
    """The workspace of one iteration or, with ``iterations``, of a chain launch."""
    P, N = plan.num_parameters, plan.num_samples
    B = -(-N // BLOCK)
    lead = () if iterations is None else (iterations,)
    scratch = torch.empty(2 + _key_words(N, knobs) + -(-B * (P + 1) // 2), dtype=torch.int64,
                          device=device)
    cem, softmax = knobs.cem, knobs.method != "random_sampling"
    return Workspace(torch.empty(lead + (N,), dtype=torch.float32, device=device),
                     torch.empty(lead + (rs.OUT_WINNER + P,), dtype=torch.float32, device=device),
                     torch.empty(lead + (P,), dtype=torch.float32, device=device) if cem else None,
                     torch.empty(lead + (knobs.n_elite,), dtype=torch.int32, device=device)
                     if cem else None,
                     scratch,
                     torch.empty(P, N, dtype=torch.float32, device=device) if softmax else None)


def scratch_pointers(ws: Workspace, num_samples: int, knobs) -> tuple:
    """(argmin and ticket, block keys or None, partials): the addresses of
    ``ws.scratch``'s parts for ``num_samples`` samples (``knobs``: Knobs or SMKnobs)."""
    base = ws.scratch.data_ptr()
    return base, base + 16 if knobs.cem else None, base + 8 * (2 + _key_words(num_samples, knobs))


def launch(lib, args: rs.RSArgs, kn: SMKnobs, plan: rs.RSPlan, ws: Workspace, incumbent, sigma,
           noise_in=None, noise_out=None, stream=None, phases: int = BOTH_PHASES,
           beta_in=None, sums_out=None) -> None:
    """One K1b/K1c iteration through the C entry, into ``ws``; raises on a refused
    launch. ``stream`` is the CUDA stream handle (the current stream if None);
    ``phases``, ``beta_in`` (1,) and ``sums_out`` (P + 1,) as the C entry's."""
    def ptr(x):
        return None if x is None else x.data_ptr()

    argmin, keys, partials = scratch_pointers(ws, plan.num_samples, kn)
    if noise_in is None and noise_out is None:
        noise_out = ws.noise
    if stream is None:
        stream = torch.cuda.current_stream(incumbent.device).cuda_stream
    rc = lib.sm_launch(ctypes.byref(args), ctypes.byref(kn), plan.params_per_leg,
                       plan.windows.data_ptr(), incumbent.data_ptr(),
                       ptr(sigma) if kn.cem else None, ptr(noise_in), ptr(noise_out),
                       ws.costs.data_ptr(), argmin, partials, keys, ws.out.data_ptr(),
                       ptr(ws.sigma), ptr(ws.elites), phases, ptr(beta_in), ptr(sums_out),
                       stream)
    if rc != 0:
        msg = ("unsupported shape, knob or alignment" if rc < 0
               else lib.sm_error_string(rc).decode())
        raise RuntimeError(f"sampling_softmax launch failed ({rc}): {msg}")


def key_cost(keys: torch.Tensor) -> torch.Tensor:
    """The costs (float32) in the high words of argmin keys (int64, cost bits << 32 |
    index), on the keys' device."""
    return (keys >> 32).to(torch.int32).view(torch.float32)


def softmax_iteration(plan: rs.RSPlan, knobs: Knobs, tick: rs.TickInputs,
                      incumbent: torch.Tensor, sigma: torch.Tensor | None, seed: int, offset: int,
                      noise_in: torch.Tensor | None = None,
                      noise_out: torch.Tensor | None = None, merge_beta=None,
                      sums: torch.Tensor | None = None):
    """One MPPI or CEM-MPPI iteration around ``incumbent`` (kernel K1b, or K1c when
    ``knobs.cem``, on CUDA); ``sigma`` (P,) is CEM's per-parameter sigma and is
    not read by MPPI.

    Returns ``(costs (N,), out (26 + P,), sigma (P,), elites (K,))`` on the
    incumbent's device, ``out`` packed as K1a's: [beta, step-0 GRFs (12), one-step
    state (12), index of beta, new parameters (P)]. For CEM ``sigma`` is the refit
    sigma, a new tensor (an iteration never writes the sigma it reads), and
    ``elites`` the elite indices; for MPPI they are the given ``sigma`` and None.
    ``noise_in`` (P, N) replaces the generated noise; ``noise_out`` (P, N)
    receives the noise used. A CUDA launch adds one to
    ``softmax_iteration.launches[knobs.method]``.

    ``merge_beta`` (a sample-sharded solve) maps this iteration's lowest cost, a
    (1,) tensor on its device, to the beta of the weights, a (1,) float32 tensor
    there (the lowest over every shard); ``sums`` (P + 1,) then receives the
    unnormalized [S, Z] of those weights, and ``out``'s new parameters are
    incumbent + S / Z of this shard alone."""
    P, N = plan.num_parameters, plan.num_samples
    if sums is not None and merge_beta is None:
        raise ValueError("sums is handed back only with merge_beta")
    if incumbent.device.type == "cpu":
        costs, out, new_sigma, elites = _plain(plan, knobs, tick, incumbent, sigma, seed, offset,
                                               noise_in, noise_out, merge_beta, sums)
        return costs, out, new_sigma if knobs.cem else sigma, elites
    if incumbent.device.type != "cuda":
        raise ValueError(f"unsupported device {incumbent.device}")
    check_kernel_knobs(plan, knobs)
    rs.check_cuda("incumbent", incumbent, (P,))
    if knobs.cem:
        rs.check_cuda("sigma", sigma, (P,))
    for name, x in (("noise_in", noise_in), ("noise_out", noise_out)):
        if x is not None:
            rs.check_cuda(name, x, (P, N))
    if sums is not None:
        rs.check_cuda("sums", sums, (P + 1,))
    ws = workspace(plan, knobs, incumbent.device)
    lib = load_library(plan.horizon, plan.params_per_leg)
    args, kn = rs.kernel_args(plan, tick, seed, offset), knobs.struct()
    if merge_beta is None:
        launch(lib, args, kn, plan, ws, incumbent, sigma, noise_in, noise_out)
    else:
        launch(lib, args, kn, plan, ws, incumbent, sigma, noise_in, noise_out,
               phases=PHASE_ROLLOUT)
        beta = merge_beta(key_cost(ws.scratch[0:1]))
        rs.check_cuda("merge_beta's beta", beta, (1,))
        launch(lib, args, kn, plan, ws, incumbent, sigma, noise_in, noise_out,
               phases=PHASE_UPDATE, beta_in=beta, sums_out=sums)
    softmax_iteration.launches[knobs.method] += 1
    return ws.costs, ws.out, ws.sigma if knobs.cem else sigma, ws.elites


class IterationResult(NamedTuple):
    costs: torch.Tensor  # (N,)
    out: torch.Tensor  # (26 + P,) packed as K1a's; out[26:] are the next incumbent
    sigma: torch.Tensor  # (P,) the sigma after the iteration
    elites: torch.Tensor | None  # (K,) CEM elite indices, else None


_CHAIN_LIBS: dict = {}


def load_chain_library(horizon: int, params_per_leg: int) -> ctypes.CDLL:
    """Build (if needed) and load the K1d library (``csrc/sampling_chain.cu``) of the
    (horizon, parameters per leg) pair; raises as ``load_library``."""
    key = (horizon, params_per_leg)
    if key not in _CHAIN_LIBS:
        lib = build.load("sampling_chain", horizon, params_per_leg)
        rs.int_getters(lib, ("chain_args_size", "chain_knobs_size", "chain_block",
                             "chain_horizon", "chain_params_per_leg", "chain_window_bytes",
                             "chain_rollout_tiles"))
        if (lib.chain_args_size() != ctypes.sizeof(rs.args_type(horizon))
                or lib.chain_knobs_size() != ctypes.sizeof(SMKnobs)
                or lib.chain_block() != BLOCK
                or (lib.chain_horizon(), lib.chain_params_per_leg()) != key
                or lib.chain_window_bytes() != 4 * rs.WINDOW_FLOATS):
            raise RuntimeError(f"sampling_chain.cu for {key} and its ctypes mirror disagree")
        lib.chain_error_string.restype = ctypes.c_char_p
        lib.chain_error_string.argtypes = [ctypes.c_int]
        lib.chain_blocks_per_sm.restype = ctypes.c_int
        lib.chain_blocks_per_sm.argtypes = [ctypes.c_int] * 4
        lib.chain_launch.restype = ctypes.c_int
        lib.chain_launch.argtypes = ([ctypes.POINTER(rs.RSArgs), ctypes.POINTER(SMKnobs)]
                                     + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 12)
        _CHAIN_LIBS[key] = lib
    return _CHAIN_LIBS[key]


def chain_blocks_per_sm(plan: rs.RSPlan, knobs: Knobs) -> int:
    """Blocks of the chain kernel one SM of the card holds at once for ``plan``'s
    chain (cudaOccupancyMaxActiveBlocksPerMultiprocessor); its grid is this times
    the SMs."""
    lib = load_chain_library(plan.horizon, plan.params_per_leg)
    n = lib.chain_blocks_per_sm(METHODS.index(knobs.method), int(knobs.cem), knobs.n_elite,
                                plan.num_samples)
    if n < 0:
        raise RuntimeError(f"chain_blocks_per_sm failed: {lib.chain_error_string(-n).decode()}")
    return n


def chain_launch(lib, args: rs.RSArgs, kn: SMKnobs, method: str, plan: rs.RSPlan,
                 iterations: int, ws: Workspace, incumbent, sigma, max_blocks: int = 0,
                 stream=None) -> None:
    """``iterations`` chained iterations in one launch of the chain kernel through its
    C entry, into ``ws`` (``workspace(..., iterations)``); raises on a refused
    launch, a cooperative launch refused included. ``max_blocks`` > 0 runs on that
    many blocks instead of the co-resident grid (the bits do not change);
    ``stream`` is the CUDA stream handle (the current stream if None)."""
    def ptr(x):
        return None if x is None else x.data_ptr()

    argmin, keys, partials = scratch_pointers(ws, plan.num_samples, kn)
    if stream is None:
        stream = torch.cuda.current_stream(incumbent.device).cuda_stream
    rc = lib.chain_launch(ctypes.byref(args), ctypes.byref(kn), METHODS.index(method),
                          plan.params_per_leg, iterations, max_blocks, plan.windows.data_ptr(),
                          incumbent.data_ptr(), ptr(sigma) if kn.cem else None, ptr(ws.noise),
                          ws.costs.data_ptr(), argmin, partials, keys, ws.out.data_ptr(),
                          ptr(ws.sigma), ptr(ws.elites), stream)
    if rc != 0:
        msg = ("unsupported shape, knob or alignment" if rc < 0
               else lib.chain_error_string(rc).decode())
        raise RuntimeError(f"sampling_chain launch failed ({rc}): {msg}")


def sampling_chain(plan: rs.RSPlan, knobs: Knobs, tick: rs.TickInputs, incumbent: torch.Tensor,
                   sigma: torch.Tensor, seed: int, offset: int, iterations: int) -> list:
    """``iterations`` chained iterations of ``knobs.method``: iteration i samples
    around iteration i - 1's result (the winner, or the softmax mean and, for CEM,
    its refit sigma) with Philox offset ``offset + i``, all on the incumbent's
    device. Returns one ``IterationResult`` per iteration.

    On CUDA with ``iterations > 1`` this is kernel K1d, one launch of the chain
    kernel (counted in ``sampling_chain.launches[knobs.method]``) or an error; one
    iteration is one K1a/K1b/K1c launch, and on the CPU every iteration runs the
    plain version."""
    if incumbent.device.type == "cuda" and iterations > 1:
        P = plan.num_parameters
        check_kernel_knobs(plan, knobs)
        rs.check_cuda("incumbent", incumbent, (P,))
        if knobs.cem:
            rs.check_cuda("sigma", sigma, (P,))
        ws = workspace(plan, knobs, incumbent.device, iterations)
        chain_launch(load_chain_library(plan.horizon, plan.params_per_leg),
                     rs.kernel_args(plan, tick, seed, offset), knobs.struct(), knobs.method, plan,
                     iterations, ws, incumbent, sigma)
        sampling_chain.launches[knobs.method] += 1
        return [IterationResult(ws.costs[i], ws.out[i], ws.sigma[i] if knobs.cem else sigma,
                                ws.elites[i] if knobs.cem else None) for i in range(iterations)]
    results = []
    for it in range(iterations):
        if knobs.method == "random_sampling":
            costs, out = rs.sampling_rs(plan, tick, incumbent, seed, offset + it)
            elites = None
        else:
            costs, out, sigma, elites = softmax_iteration(plan, knobs, tick, incumbent, sigma,
                                                          seed, offset + it)
        results.append(IterationResult(costs, out, sigma, elites))
        incumbent = out[rs.OUT_WINNER:]
    return results


softmax_iteration.launches = {"mppi": 0, "cem_mppi": 0}
sampling_chain.launches = dict.fromkeys(METHODS, 0)
