"""Random-sampling MPC iteration: the CUDA kernel K1a, its plain version and loader.

The kernel (``csrc/sampling_rs.cu``) replaces the main-path variant of the Pallas
TPU kernel ``quadruped_pympc_tamols_tpu/ops/rollout_pallas.py:
make_pallas_iteration(...).kernel`` (random_sampling, one group, fused cross-tile
combine, one iteration). Per sample it does a (H*12, P) basis product, an H-step
SRB rollout and P normals, against a few hundred KB of inputs and outputs: far
from both the card's FP32 rate and its memory rate, it is bound by the latency
of each sample's dependent chain. The rollout pass (shared with K1b-K1f, in
``csrc/sampling_common.cuh``) therefore runs each sample on four lanes, one per
leg, in blocks of ``ROLLOUT_SAMPLES`` samples; each lane stages its leg's
parameters in shared memory and forms only its leg's rows of the basis, each on
its window of four weights (``basis_windows``), which a bulk asynchronous copy
brings into shared memory. The argmin folds into one
64-bit atomicMin and the winner is regenerated from its Philox counter in a
second tiny launch, so neither the noise nor the forces ever reach device
memory. See the sources for the details.

``sampling_rs`` is the wrapper. On CUDA tensors it launches the kernel (two
launches, counted once in ``sampling_rs.launches``) or raises; on CPU tensors it
runs ``sampling_iteration_reference``, the plain torch version of the same
function. There is no fallback from one to the other.

The kernel is built with ``nvcc`` from the source in this package into
``quadruped_pympc_tamols_torch/_build/`` and bound with ``ctypes``
(``ops/build.py``), one library for each (horizon, parameters per leg) pair, the
first time a solver asks for the pair: every pair with 2 <= H <= 128 and P = 4 *
P_leg <= 1024 (``build.check_pair``), which holds every parametrization the
Pallas kernel takes. The argument block (``args_type``) carries the per-step
arrays sized by the pair's horizon. The rollout adds the ZMP-band cost each step
where ``sampling.zmp_weight > 0``, as the plain version does.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..controllers.sampling.rollout import (ForceModelParams, apply_force_model_rows,
                                            rollout_costs_soa)
from ..controllers.sampling.splines import make_step_major_basis, num_params_per_leg
from ..dynamics.srbd import SRBDParams, integrate_euler, make_params
from . import build

# Samples per block of the rollout pass, four lanes each (ROLLOUT_SAMPLES in
# csrc/sampling_common.cuh; every library's getter is checked against it).
ROLLOUT_SAMPLES = 16
WINDOW = 4  # weights of a basis row's window (RS_WINDOW)
WINDOW_FLOATS = 8  # a struct BasisWindow: the weights, the first parameter, padding
OUT_WINNER = 26  # packed output: [cost, grf(12), state(12), index, winner(P)]
COST_SATURATION = 1.0e6


class RSModel(ctypes.Structure):
    _fields_ = [("mass", ctypes.c_float), ("gravity", ctypes.c_float),
                ("inertia", ctypes.c_float * 9), ("inertia_inv", ctypes.c_float * 9),
                ("scale_x", ctypes.c_float), ("scale_y", ctypes.c_float),
                ("grf_min", ctypes.c_float), ("grf_max", ctypes.c_float),
                ("mu", ctypes.c_float)]


class RSArgs(ctypes.Structure):
    """Mirror of ``struct RSArgs`` in csrc/sampling_common.cuh up to its per-step
    arrays (352 bytes); ``args_type(H)`` adds them. Reads any pair's argument
    block (``from_buffer_copy``)."""

    _fields_ = [("num_samples", ctypes.c_int), ("horizon", ctypes.c_int),
                ("band1", ctypes.c_int), ("band2", ctypes.c_int),
                ("seed", ctypes.c_ulonglong), ("offset", ctypes.c_ulonglong),
                ("q_diag", ctypes.c_float * 12),
                ("model", RSModel),
                ("sigma1", ctypes.c_float), ("sigma2", ctypes.c_float),
                ("sigma3", ctypes.c_float),
                ("state", ctypes.c_float * 12), ("feet", ctypes.c_float * 12),
                ("ref", ctypes.c_float * 12),
                ("draw_col0", ctypes.c_int),
                ("zmp_weight", ctypes.c_float), ("zmp_margin", ctypes.c_float),
                ("pad", ctypes.c_int)]


_ARGS_TYPES: dict = {}


def args_type(horizon: int) -> type:
    """The argument block of a pair at ``horizon``: ``RSArgs`` and its per-step
    arrays dts (H,), contact and share (H*4, step-major), as each library sizes
    them (checked against its ``*_args_size``)."""
    if horizon not in _ARGS_TYPES:
        _ARGS_TYPES[horizon] = type(f"RSArgs{horizon}", (RSArgs,), {"_fields_": [
            ("dts", ctypes.c_float * horizon), ("contact", ctypes.c_float * (horizon * 4)),
            ("share", ctypes.c_float * (horizon * 4))]})
    return _ARGS_TYPES[horizon]


@dataclasses.dataclass(frozen=True)
class RSPlan:
    """Everything about one solver's iteration that does not change per tick."""

    num_samples: int
    horizon: int
    params_per_leg: int
    sigma_random: tuple
    W: torch.Tensor  # (H*12, 4*P_leg) dense basis on the solver's device
    windows: torch.Tensor  # (H*12, 8) each row's window of the basis (kernel input)
    dts: np.ndarray  # (H,) float32
    q_diag: np.ndarray  # (12,) float32, >= 0
    srbd: SRBDParams  # on the solver's device
    fm: ForceModelParams
    zmp_weight: float  # ZMP-band cost (0: none)
    zmp_margin: float
    args_template: bytes  # args_type(H) with every constant filled, per-tick fields zero
    # Sample 0 draws noise as the others do instead of being the incumbent: the
    # shards of a sample-sharded solve after the first (``with_drawn_column0``).
    draw_col0: bool = False

    @property
    def num_parameters(self) -> int:
        return 4 * self.params_per_leg


class TickInputs(NamedTuple):
    """Per-tick inputs of one iteration, host float32 arrays."""

    state12: np.ndarray  # (12,)
    feet: np.ndarray  # (4, 3) effective feet (swing feet already substituted)
    ref12: np.ndarray  # (12,)
    contact_seq: np.ndarray  # (4, H)
    share: np.ndarray  # (H, 4) per-leg gravity shares


class ReferenceResult(NamedTuple):
    costs: torch.Tensor  # (N,)
    best_index: torch.Tensor  # 0-d int64
    best_cost: torch.Tensor  # 0-d
    winner: torch.Tensor  # (P,)
    grfs: torch.Tensor  # (4, 3)
    next_state: torch.Tensor  # (12,)


def make_rs_plan(cfg: Config, num_samples: int, device) -> RSPlan:
    sp = cfg.mpc.sampling
    H = cfg.mpc.horizon
    P_leg = num_params_per_leg(sp.parametrization, H, sp.num_splines)
    W = make_step_major_basis(sp.parametrization, H, sp.num_splines)
    legs = (np.arange(H * 12) % 12) // 3
    blocks = np.stack([W[r, legs[r] * P_leg:(legs[r] + 1) * P_leg] for r in range(H * 12)])
    off_block = W.copy()
    for r in range(H * 12):
        off_block[r, legs[r] * P_leg:(legs[r] + 1) * P_leg] = 0.0
    if np.any(off_block != 0.0):
        raise ValueError("the spline basis is not block-diagonal per leg")
    q_diag = cfg.mpc.cost.as_vector()
    if np.any(q_diag < 0.0):
        # The kernel's argmin orders costs by their bit patterns: costs must be >= 0.
        raise ValueError("cost weights must be non-negative")
    fm = ForceModelParams(sp.max_force_x / sp.max_force_z, sp.max_force_y / sp.max_force_z,
                          cfg.mpc.grf_min, cfg.mpc.grf_max, cfg.mpc.mu)
    N = int(num_samples)
    a = args_type(H)()
    a.num_samples, a.horizon = N, H
    a.band1, a.band2 = band_edges(N)
    m = a.model
    inertia = np.asarray(cfg.robot.inertia_matrix())
    m.mass, m.gravity = cfg.robot.mass, cfg.gravity
    np.ctypeslib.as_array(m.inertia)[:] = inertia.ravel()
    np.ctypeslib.as_array(m.inertia_inv)[:] = np.linalg.inv(inertia).ravel()
    m.scale_x, m.scale_y, m.grf_min, m.grf_max, m.mu = (fm.scale_x, fm.scale_y, fm.grf_min,
                                                        fm.grf_max, fm.mu)
    a.sigma1, a.sigma2, a.sigma3 = sp.sigma_random
    a.zmp_weight, a.zmp_margin = sp.zmp_weight, sp.zmp_margin
    np.ctypeslib.as_array(a.dts)[:] = cfg.mpc.dts()
    np.ctypeslib.as_array(a.q_diag)[:] = q_diag
    return RSPlan(num_samples=N, horizon=H, params_per_leg=P_leg,
                  sigma_random=tuple(float(s) for s in sp.sigma_random),
                  W=torch.as_tensor(W, device=device),
                  windows=torch.as_tensor(basis_windows(blocks, P_leg), device=device),
                  dts=cfg.mpc.dts(), q_diag=q_diag,
                  srbd=make_params(cfg, device=device), fm=fm, zmp_weight=sp.zmp_weight,
                  zmp_margin=sp.zmp_margin, args_template=bytes(a))


def with_drawn_column0(plan: RSPlan) -> RSPlan:
    """``plan`` with sample 0 drawing noise instead of being the incumbent: the
    kernels' ``RSArgs::draw_col0`` and the plain noise's column 0. Random sampling
    draws it from N(0, sigma2), MPPI and CEM-MPPI as their other samples, as the
    JAX package's sharded solver does on every shard but the first
    (``parallel/sharded.py:58-73``), so that the shards do not each add a copy of
    the incumbent."""
    a = args_type(plan.horizon).from_buffer_copy(plan.args_template)
    a.draw_col0 = 1
    return dataclasses.replace(plan, draw_col0=True, args_template=bytes(a))


def basis_windows(blocks: np.ndarray, params_per_leg: int) -> np.ndarray:
    """The kernels' basis table (``struct BasisWindow``): for each row r of the
    own-leg blocks (..., H*12, >= P_leg), WINDOW weights as float32 [0:4] and, as
    int32 bits in [4], the leg-major index of the window's first parameter (leg *
    P_leg + j0, the leg (r % 12) // 3), with j0 the row's first nonzero moved left
    as far as the window must to end within the leg; (..., H*12, 8) float32.
    Raises NotImplementedError for a row whose nonzeros span more than WINDOW."""
    if params_per_leg < WINDOW:
        raise NotImplementedError(f"the basis windows need at least {WINDOW} parameters a leg, "
                                  f"not {params_per_leg}")
    b = np.asarray(blocks, np.float32)[..., :params_per_leg]
    nz = b != 0.0
    j0 = np.minimum(nz.argmax(axis=-1), params_per_leg - WINDOW)  # 0 for a row of zeros
    w = np.take_along_axis(b, j0[..., None] + np.arange(WINDOW), axis=-1)
    wide = nz.sum(-1) != np.count_nonzero(w, axis=-1)
    if wide.any():
        r = tuple(int(x) for x in np.argwhere(wide)[0])
        raise NotImplementedError(f"basis row {r} has nonzeros at {np.flatnonzero(nz[r]).tolist()}: "
                                  f"wider than the kernels' window of {WINDOW}")
    out = np.zeros(b.shape[:-1] + (WINDOW_FLOATS,), np.float32)
    out[..., :WINDOW] = w
    legs = (np.arange(b.shape[-2]) % 12) // 3
    out[..., WINDOW].view(np.int32)[...] = legs * params_per_leg + j0
    return out


def check_kernel_shape(plan: RSPlan) -> None:
    """Raise NotImplementedError, naming the bound, for a (horizon, parameters per
    leg) pair beyond what the CUDA kernels (K1a-K1f) hold (``build.check_pair``)."""
    build.check_pair(plan.horizon, plan.params_per_leg)


# -- the plain version ------------------------------------------------------------

def rollout_costs_reference(params, W, state12, feet, ref12, contact_seq, share, dts, q_diag,
                            srbd: SRBDParams, fm: ForceModelParams, zmp_weight: float = 0.0,
                            zmp_margin: float = 0.04):
    """(N,) costs of the (P, N) candidate parameters: the basis product and the
    plain rollout, NaN/Inf saturated to 1e6."""
    H = contact_seq.shape[1]
    raw = (W @ params).reshape(H, 12, params.shape[1])
    return rollout_costs_soa(state12, feet, ref12, raw, contact_seq, share, dts, q_diag, srbd,
                             fm, COST_SATURATION, zmp_weight=zmp_weight, zmp_margin=zmp_margin)


def step0_reference(params, W, state12, feet, contact_seq, share, dts, srbd: SRBDParams,
                    fm: ForceModelParams):
    """Step-0 GRFs (4, 3) and the one-step Euler state (12,) under parameters (P,)."""
    rows = apply_force_model_rows(W[0:12] @ params, contact_seq[:, 0], share[0], fm)
    grfs = torch.stack(rows).reshape(4, 3)
    next_state = integrate_euler(state12, feet, grfs, contact_seq[:, 0], srbd,
                                 float(np.float32(dts[0])))
    return grfs, next_state


def sampling_iteration_reference(noise, incumbent, W, state12, feet, ref12, contact_seq,
                                 share, dts, q_diag, srbd: SRBDParams,
                                 fm: ForceModelParams, zmp_weight: float = 0.0,
                                 zmp_margin: float = 0.04) -> ReferenceResult:
    """Plain torch version of the kernel: one random-sampling iteration.

    noise (P, N), incumbent (P,), W (H*12, P); state12/ref12 (12,), feet (4, 3),
    contact_seq (4, H), share (H, 4) or (H,), all on one device; dts and q_diag
    host arrays. Returns every cost, the argmin (lowest index on ties), the
    winner's parameters, its step-0 GRFs and its one-step Euler state, with the
    ZMP-band cost where ``zmp_weight > 0``."""
    params = incumbent[:, None] + noise
    costs = rollout_costs_reference(params, W, state12, feet, ref12, contact_seq, share, dts,
                                    q_diag, srbd, fm, zmp_weight, zmp_margin)
    best = torch.argmin(costs)
    winner = params[:, best]
    grfs, next_state = step0_reference(winner, W, state12, feet, contact_seq, share, dts, srbd,
                                       fm)
    return ReferenceResult(costs, best, costs[best], winner, grfs, next_state)


def band_edges(num_samples: int) -> tuple:
    """First samples of the sigma2 and uniform bands: column 0 is the incumbent,
    [1, 1+N/3) ~ N(0, s1), [1+N/3, 1+2(N/3)) ~ N(0, s2), the rest ~ U(+-s3)."""
    n3 = num_samples // 3
    return 1 + n3, 1 + 2 * n3


def sample_noise_reference(plan: RSPlan, generator: torch.Generator) -> torch.Tensor:
    """(P, N) three-band exploration noise on the CPU (reference
    centroidal_nmpc_jax.py:644-677), column 0 zero or, with ``plan.draw_col0``,
    N(0, sigma2); the kernel draws the same distribution from Philox."""
    P, N = plan.num_parameters, plan.num_samples
    s1, s2, s3 = plan.sigma_random
    b1, b2 = band_edges(N)
    noise = torch.zeros(P, N)
    noise[:, 1:b1] = s1 * torch.randn(P, b1 - 1, generator=generator)
    noise[:, b1:b2] = s2 * torch.randn(P, b2 - b1, generator=generator)
    noise[:, b2:] = (2.0 * torch.rand(P, N - b2, generator=generator) - 1.0) * s3
    if plan.draw_col0:
        noise[:, 0] = s2 * torch.randn(P, generator=generator)
    return noise


def cpu_generator(seed: int, offset: int) -> torch.Generator:
    """The CPU path's stream for the (seed, offset) pair the kernel keys Philox on."""
    return torch.Generator().manual_seed((int(seed) * 0x9E3779B1 + int(offset)) % (1 << 63))


def pack_result(best_cost, grfs, next_state, best_index, winner) -> torch.Tensor:
    """The kernel's output layout: [cost, grf(12), state(12), index, winner(P)]."""
    head = torch.cat([best_cost.reshape(1), grfs.reshape(12), next_state.reshape(12),
                      best_index.reshape(1).to(winner.dtype)])
    return torch.cat([head, winner])


def tick_tensors(tick: TickInputs, device) -> tuple:
    """(state12, feet, ref12, contact_seq, share) as float32 tensors on ``device``."""
    return tuple(torch.as_tensor(np.asarray(x, np.float32), device=device) for x in tick)


def _reference_from_tick(plan: RSPlan, tick: TickInputs, incumbent, noise):
    state12, feet, ref12, contact, share = tick_tensors(tick, incumbent.device)
    res = sampling_iteration_reference(noise, incumbent, plan.W, state12, feet, ref12, contact,
                                       share, plan.dts, plan.q_diag, plan.srbd, plan.fm,
                                       plan.zmp_weight, plan.zmp_margin)
    return res.costs, pack_result(res.best_cost, res.grfs, res.next_state, res.best_index,
                                  res.winner)


# -- the kernel ---------------------------------------------------------------------

_LIBS: dict = {}


def int_getters(lib, names) -> None:
    """Declare the library's getters ``names`` as C functions returning int."""
    for name in names:
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []


def load_library(horizon: int, params_per_leg: int) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library of the (horizon, parameters
    per leg) pair; raises on any failure, NotImplementedError for a pair beyond
    the kernels' bounds (``build.check_pair``)."""
    key = (horizon, params_per_leg)
    if key not in _LIBS:
        lib = build.load("sampling_rs", horizon, params_per_leg)
        int_getters(lib, ("rs_args_size", "rs_rollout_samples", "rs_horizon",
                          "rs_params_per_leg", "rs_window_bytes"))
        if lib.rs_args_size() != ctypes.sizeof(args_type(horizon)):
            raise RuntimeError("RSArgs layout differs between sampling_rs.cu and ctypes")
        if lib.rs_rollout_samples() != ROLLOUT_SAMPLES:
            raise RuntimeError("sampling_rs.cu's rollout block differs from ROLLOUT_SAMPLES")
        if (lib.rs_horizon(), lib.rs_params_per_leg()) != key:
            raise RuntimeError(f"the sampling_rs library for {key} is built for "
                               f"{(lib.rs_horizon(), lib.rs_params_per_leg())}")
        if lib.rs_window_bytes() != 4 * WINDOW_FLOATS:
            raise RuntimeError("sampling_rs.cu's BasisWindow differs from basis_windows")
        lib.rs_error_string.restype = ctypes.c_char_p
        lib.rs_error_string.argtypes = [ctypes.c_int]
        lib.rs_launch.restype = ctypes.c_int
        lib.rs_launch.argtypes = [ctypes.POINTER(RSArgs), ctypes.c_int] + [ctypes.c_void_p] * 8
        _LIBS[key] = lib
    return _LIBS[key]


def kernel_args(plan: RSPlan, tick: TickInputs, seed: int, offset: int) -> RSArgs:
    """The kernel's by-value argument block (``args_type(H)``): the plan's
    constants plus this tick."""
    H = plan.horizon
    a = args_type(H).from_buffer_copy(plan.args_template)
    a.seed, a.offset = int(seed) % (1 << 64), int(offset) % (1 << 64)
    np.ctypeslib.as_array(a.state)[:] = np.asarray(tick.state12, np.float32).reshape(12)
    np.ctypeslib.as_array(a.feet)[:] = np.asarray(tick.feet, np.float32).reshape(12)
    np.ctypeslib.as_array(a.ref)[:] = np.asarray(tick.ref12, np.float32).reshape(12)
    np.ctypeslib.as_array(a.contact)[:] = np.asarray(tick.contact_seq, np.float32).T.ravel()
    np.ctypeslib.as_array(a.share)[:] = np.asarray(tick.share, np.float32).reshape(H, 4).ravel()
    return a


def check_cuda(name, x, shape):
    if not (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()
            and tuple(x.shape) == tuple(shape)):
        raise ValueError(f"{name} must be a contiguous CUDA float32 tensor of shape {shape}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def sampling_rs(plan: RSPlan, tick: TickInputs, incumbent: torch.Tensor, seed: int,
                offset: int, noise_in: torch.Tensor | None = None,
                noise_out: torch.Tensor | None = None):
    """One random-sampling iteration around ``incumbent``.

    Returns ``(costs (N,), out (26 + P,))`` on the incumbent's device, ``out``
    packed as [best cost, step-0 GRFs (12), one-step state (12), best index,
    winner parameters (P)]. ``noise_in`` (P, N) replaces the generated noise
    (column 0 included); ``noise_out`` (P, N) receives the noise used. On CUDA
    the noise comes from Philox keyed on (seed, offset); on the CPU from
    ``cpu_generator(seed, offset)``.
    """
    P, N = plan.num_parameters, plan.num_samples
    if incumbent.device.type == "cpu":
        noise = noise_in if noise_in is not None \
            else sample_noise_reference(plan, cpu_generator(seed, offset))
        if noise_out is not None:
            noise_out.copy_(noise)
        return _reference_from_tick(plan, tick, incumbent, noise)
    if incumbent.device.type != "cuda":
        raise ValueError(f"unsupported device {incumbent.device}")
    check_kernel_shape(plan)
    check_cuda("incumbent", incumbent, (P,))
    for name, x in (("noise_in", noise_in), ("noise_out", noise_out)):
        if x is not None:
            check_cuda(name, x, (P, N))
    lib = load_library(plan.horizon, plan.params_per_leg)
    dev = incumbent.device
    costs = torch.empty(N, dtype=torch.float32, device=dev)
    out = torch.empty(OUT_WINNER + P, dtype=torch.float32, device=dev)
    argmin = torch.empty(1, dtype=torch.int64, device=dev)
    args = kernel_args(plan, tick, seed, offset)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rs_launch(ctypes.byref(args), plan.params_per_leg, plan.windows.data_ptr(),
                       incumbent.data_ptr(),
                       None if noise_in is None else noise_in.data_ptr(),
                       None if noise_out is None else noise_out.data_ptr(),
                       costs.data_ptr(), argmin.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        msg = "unsupported shape or alignment" if rc < 0 else lib.rs_error_string(rc).decode()
        raise RuntimeError(f"sampling_rs launch failed ({rc}): {msg}")
    sampling_rs.launches += 1
    return costs, out


sampling_rs.launches = 0
