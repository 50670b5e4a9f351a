"""Gait-adaptive sampling iteration: CUDA kernel K1e, its plain version and wrapper.

The kernel (``csrc/sampling_groups.cu``) replaces the group-axis variant of the
Pallas TPU kernel ``quadruped_pympc_tamols_tpu/ops/rollout_pallas.py:
make_pallas_iteration(...).kernel`` (``num_groups = K > 1``, fused per group, one
iteration), in the XLA solver's forms (JAX ``controllers/sampling/
gait_adaptive.py:184-226``). The samples are partitioned into K groups, one per
candidate step frequency: group k holds samples [k*Ng, (k+1)*Ng) with
Ng = N // K, and the last N - K*Ng samples are not evaluated. Each group has its
own contact sequence (4, H), gravity share (H,), own-leg spline basis blocks
(H*12, P_leg) and cost offset (f - 1.3)^2 * 100, added after the NaN/Inf
saturation. The noise is drawn for the global sample index with the band edges
of N, as in K1a (random sampling) and K1b/K1c (MPPI, CEM-MPPI). The optimizer
step runs over all K*Ng costs, offsets included: the argmin (random sampling),
the softmax update (MPPI) and the (cost, index) elites and sigma refit (CEM).
The step-0 GRFs and one-step state come from the host's contact sequence
column 0, its gravity share and the counter-zero basis (the static basis's
first 12 rows), not from the winning group.

One solve is a memset and two launches: the shared rollout pass over a
(ceil(Ng/ROLLOUT_SAMPLES), K) grid, then K1a's extraction or K1b/K1c's update
pass over the K*Ng samples. The groups' basis windows (``rs.basis_windows``),
contact and share columns and offsets reach the card in one host-to-device copy
a tick (from pinned memory).

``sampling_groups`` is the wrapper. On CUDA tensors it launches the kernel or
raises; on CPU tensors it runs ``group_iteration_reference`` with noise from
``cpu_generator(seed, offset)``. A CUDA launch adds one to
``sampling_groups.launches[knobs.method]``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..controllers.sampling.rollout import ForceModelParams
from ..dynamics.srbd import SRBDParams
from . import build
from . import sampling_kernel as rs
from . import sampling_softmax as sm


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """A gait-adaptive solver's constants: K1a's plan for N samples, the number of
    candidate groups K and the group size Ng = N // K."""

    base: rs.RSPlan
    num_groups: int
    group_size: int

    @property
    def num_used(self) -> int:
        """Samples evaluated, K * Ng."""
        return self.num_groups * self.group_size


def make_group_plan(cfg: Config, num_samples: int, device) -> GroupPlan:
    K = len(cfg.mpc.step_freq_available)
    N = int(num_samples)
    if K < 1 or N < K:
        raise ValueError(f"{N} samples cannot fill {K} candidate groups")
    return GroupPlan(rs.make_rs_plan(cfg, N, device), K, N // K)


class GroupInputs(NamedTuple):
    """One tick's per-group operators, host float32 arrays."""

    contact: np.ndarray  # (K, 4, H) timer contact sequences
    share: np.ndarray  # (K, H) gravity shares m*g/max(n_stance, 1)
    blocks: np.ndarray  # (K, H*12, P_leg) own-leg basis blocks, row n*12 + leg*3 + axis
    offsets: np.ndarray  # (K,) cost offsets (f - 1.3)^2 * 100
    windows: np.ndarray  # (K, H*12, 8) the same rows as rs.basis_windows's (kernel input)

    def dense(self, device) -> torch.Tensor:
        """(K, H*12, 4*P_leg) block-diagonal bases on ``device``."""
        K, R, P_leg = self.blocks.shape
        legs = (np.arange(R) % 12) // 3
        W = np.zeros((K, R, 4 * P_leg), np.float32)
        for leg in range(4):
            W[:, legs == leg, leg * P_leg:(leg + 1) * P_leg] = self.blocks[:, legs == leg]
        return torch.as_tensor(W, device=device)


def check_kernel(plan: GroupPlan, knobs: sm.Knobs) -> None:
    """Raise for what K1e does not take: a pair beyond the kernels' bounds
    (``rs.check_kernel_shape``), a temperature <= 0, or an elite count outside
    [2, K*Ng]."""
    used = dataclasses.replace(plan.base, num_samples=plan.num_used)
    sm.check_kernel_knobs(used, knobs)


# -- the plain version ------------------------------------------------------------

class GroupResult(NamedTuple):
    costs: torch.Tensor  # (K*Ng,) offsets included
    best_index: torch.Tensor  # 0-d int64, the first sample of the lowest cost
    best_group: torch.Tensor  # 0-d int64, best_index // Ng
    best_cost: torch.Tensor  # 0-d
    new_params: torch.Tensor  # (P,) the winner, or the softmax mean
    sigma: torch.Tensor | None  # (P,) refit sigma (CEM), else None
    elites: torch.Tensor | None  # (n_elite,) elite indices (CEM), else None
    grfs: torch.Tensor  # (4, 3) step-0 GRFs of new_params under the host contact
    next_state: torch.Tensor  # (12,) one-step Euler state under them


def group_costs_reference(params, W_groups, contact_groups, share_groups, offsets, state12, feet,
                          ref12, dts, q_diag, srbd: SRBDParams, fm: ForceModelParams,
                          zmp_weight: float = 0.0, zmp_margin: float = 0.04):
    """(K*Ng,) costs of the (P, K*Ng) candidates: group k's columns roll out under
    its own basis W_groups[k] (H*12, P), contact (4, H) and share (H,); its offset
    is added after the saturation."""
    K = W_groups.shape[0]
    Ng = params.shape[1] // K
    costs = [rs.rollout_costs_reference(params[:, k * Ng:(k + 1) * Ng], W_groups[k], state12,
                                        feet, ref12, contact_groups[k], share_groups[k], dts,
                                        q_diag, srbd, fm, zmp_weight, zmp_margin) + offsets[k]
             for k in range(K)]
    return torch.cat(costs)


def group_iteration_reference(noise, incumbent, W_groups, contact_groups, share_groups, offsets,
                              W, state12, feet, ref12, contact_seq, share, dts, q_diag,
                              srbd: SRBDParams, fm: ForceModelParams, knobs: sm.Knobs,
                              zmp_weight: float = 0.0, zmp_margin: float = 0.04) -> GroupResult:
    """Plain torch version of kernel K1e: one gait-adaptive iteration on the given
    noise (P, K*Ng), column 0 the incumbent's zero.

    W_groups (K, H*12, P), contact_groups (K, 4, H), share_groups (K, H) and
    offsets (K,) are the groups' operators; W (H*12, P) is the static basis,
    whose rows 0..11 are the counter-zero basis of the step-0 extraction, and
    contact_seq (4, H) and share (H,) or (H, 4) the host's, of which step 0 is
    read. All on one device; dts and q_diag host arrays."""
    params = incumbent[:, None] + noise
    costs = group_costs_reference(params, W_groups, contact_groups, share_groups, offsets,
                                  state12, feet, ref12, dts, q_diag, srbd, fm, zmp_weight,
                                  zmp_margin)
    Ng = costs.shape[0] // W_groups.shape[0]
    if knobs.method == "random_sampling":
        best = torch.argmin(costs)
        grfs, next_state = rs.step0_reference(params[:, best], W, state12, feet, contact_seq,
                                              share, dts, srbd, fm)
        return GroupResult(costs, best, best // Ng, costs[best], params[:, best], None, None,
                           grfs, next_state)
    r = sm.softmax_combine_reference(costs, noise, incumbent, W, state12, feet, contact_seq,
                                     share, dts, srbd, fm, knobs)
    return GroupResult(costs, r.best_index, r.best_index // Ng, r.beta, r.new_params, r.sigma,
                       r.elites, r.grfs, r.next_state)


def sample_noise_reference(plan: GroupPlan, knobs: sm.Knobs, generator: torch.Generator,
                           sigma=None) -> torch.Tensor:
    """(P, K*Ng) exploration noise on the CPU: the method's noise for all N
    samples (K1a's three bands, or K1b/K1c's normals), of which the first K*Ng
    columns are used."""
    if knobs.method == "random_sampling":
        noise = rs.sample_noise_reference(plan.base, generator)
    else:
        noise = sm.sample_noise_reference(plan.base.num_parameters, plan.base.num_samples, knobs,
                                          generator, sigma)
    return noise[:, :plan.num_used]


def _plain(plan: GroupPlan, knobs, tick, groups: GroupInputs, incumbent, sigma, seed, offset,
           noise_in, noise_out):
    noise = noise_in if noise_in is not None else sample_noise_reference(
        plan, knobs, rs.cpu_generator(seed, offset), sigma)
    if noise_out is not None:
        noise_out.copy_(noise)
    dev = incumbent.device
    p = plan.base
    state12, feet, ref12, contact, share = rs.tick_tensors(tick, dev)
    t = [torch.as_tensor(x, device=dev) for x in (groups.contact, groups.share, groups.offsets)]
    res = group_iteration_reference(noise, incumbent, groups.dense(dev), *t, p.W, state12, feet,
                                    ref12, contact, share, p.dts, p.q_diag, p.srbd, p.fm, knobs,
                                    p.zmp_weight, p.zmp_margin)
    out = rs.pack_result(res.best_cost, res.grfs, res.next_state, res.best_index, res.new_params)
    return res.costs, out, res.sigma, res.elites


# -- the kernel ---------------------------------------------------------------------

_LIBS: dict = {}
_METHOD = {"random_sampling": 0, "mppi": 1, "cem_mppi": 2}


def load_library(horizon: int, params_per_leg: int) -> ctypes.CDLL:
    """Build (if needed) and load the K1e library of the (horizon, parameters per
    leg) pair; raises on any failure, NotImplementedError for a pair beyond the
    kernels' bounds (``build.check_pair``)."""
    key = (horizon, params_per_leg)
    if key not in _LIBS:
        lib = build.load("sampling_groups", horizon, params_per_leg)
        rs.int_getters(lib, ("sg_args_size", "sg_knobs_size", "sg_block", "sg_rollout_samples",
                             "sg_horizon", "sg_params_per_leg", "sg_window_bytes"))
        if (lib.sg_args_size() != ctypes.sizeof(rs.args_type(horizon))
                or lib.sg_knobs_size() != ctypes.sizeof(sm.SMKnobs)
                or lib.sg_block() != sm.BLOCK
                or lib.sg_rollout_samples() != rs.ROLLOUT_SAMPLES
                or (lib.sg_horizon(), lib.sg_params_per_leg()) != key
                or lib.sg_window_bytes() != 4 * rs.WINDOW_FLOATS):
            raise RuntimeError(f"sampling_groups.cu for {key} and its ctypes mirror disagree")
        lib.sg_error_string.restype = ctypes.c_char_p
        lib.sg_error_string.argtypes = [ctypes.c_int]
        lib.sg_launch.restype = ctypes.c_int
        lib.sg_launch.argtypes = ([ctypes.POINTER(rs.RSArgs), ctypes.POINTER(sm.SMKnobs)]
                                  + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 14)
        _LIBS[key] = lib
    return _LIBS[key]


def pack_groups(groups: GroupInputs) -> np.ndarray:
    """The kernel's per-tick group buffer: [basis windows (K, H*12, 8) as
    ``rs.basis_windows`` | contact (K, H, 4) | share (K, H, 4) | offsets (K,)],
    step-major columns; float32."""
    K, R, _ = groups.blocks.shape
    H = groups.contact.shape[2]
    n = K * R * rs.WINDOW_FLOATS
    buf = np.empty(n + 8 * K * H + K, np.float32)
    buf[:n] = groups.windows.reshape(-1)
    buf[n:n + 4 * K * H].reshape(K, H, 4)[...] = groups.contact.transpose(0, 2, 1)
    buf[n + 4 * K * H:n + 8 * K * H].reshape(K, H, 4)[...] = groups.share[:, :, None]
    buf[n + 8 * K * H:] = groups.offsets
    return buf


def sampling_groups(plan: GroupPlan, knobs: sm.Knobs, tick: rs.TickInputs, groups: GroupInputs,
                    incumbent: torch.Tensor, sigma: torch.Tensor | None, seed: int, offset: int,
                    noise_in: torch.Tensor | None = None,
                    noise_out: torch.Tensor | None = None):
    """One gait-adaptive iteration of ``knobs.method`` around ``incumbent`` (kernel
    K1e on CUDA). ``tick`` carries the state, the effective feet, the reference and
    the host's contact sequence and (H, 4) shares, whose step 0 the extraction
    reads; ``groups`` the per-group operators.

    Returns ``(costs (K*Ng,), out (26 + P,), sigma (P,), elites)`` on the
    incumbent's device, ``out`` packed as K1a's: [best cost, step-0 GRFs (12),
    one-step state (12), best index, new parameters (P)]. For CEM ``sigma`` is the
    refit (a new tensor) and ``elites`` the elite indices; otherwise they are the
    given ``sigma`` and None. ``noise_in`` (P, K*Ng) replaces the generated noise;
    ``noise_out`` (P, K*Ng) receives the noise used."""
    P, n = plan.base.num_parameters, plan.num_used
    if incumbent.device.type == "cpu":
        costs, out, new_sigma, elites = _plain(plan, knobs, tick, groups, incumbent, sigma, seed,
                                               offset, noise_in, noise_out)
        return costs, out, new_sigma if knobs.cem else sigma, elites
    if incumbent.device.type != "cuda":
        raise ValueError(f"unsupported device {incumbent.device}")
    check_kernel(plan, knobs)
    if groups.blocks.shape != (plan.num_groups, plan.base.horizon * 12, plan.base.params_per_leg):
        raise ValueError(f"group basis blocks of shape {groups.blocks.shape} do not fit the plan")
    rs.check_cuda("incumbent", incumbent, (P,))
    if knobs.cem:
        rs.check_cuda("sigma", sigma, (P,))
    for name, x in (("noise_in", noise_in), ("noise_out", noise_out)):
        if x is not None:
            rs.check_cuda(name, x, (P, n))
    dev = incumbent.device
    used = dataclasses.replace(plan.base, num_samples=n)
    ws = sm.workspace(used, knobs, dev)
    buf = torch.from_numpy(pack_groups(groups)).pin_memory().to(dev, non_blocking=True)
    args = rs.kernel_args(plan.base, tick, seed, offset)
    args.num_samples = n  # the band edges stay N's
    launch(load_library(plan.base.horizon, plan.base.params_per_leg), args, knobs, plan, ws, buf,
           incumbent, sigma, noise_in, noise_out)
    sampling_groups.launches[knobs.method] += 1
    return ws.costs, ws.out, ws.sigma if knobs.cem else sigma, ws.elites


def launch(lib, args: rs.RSArgs, knobs: sm.Knobs, plan: GroupPlan, ws: sm.Workspace, groups_buf,
           incumbent, sigma, noise_in=None, noise_out=None, stream=None) -> None:
    """One K1e iteration through the C entry into ``ws`` (sized for K*Ng samples);
    raises on a refused launch. ``stream`` is the CUDA stream handle (the current
    stream if None)."""
    def ptr(x):
        return None if x is None else x.data_ptr()

    argmin, keys, partials = sm.scratch_pointers(ws, plan.num_used, knobs)
    if noise_in is None and noise_out is None:
        noise_out = ws.noise
    if stream is None:
        stream = torch.cuda.current_stream(incumbent.device).cuda_stream
    rc = lib.sg_launch(ctypes.byref(args), ctypes.byref(knobs.struct()), _METHOD[knobs.method],
                       plan.base.params_per_leg, plan.num_groups, plan.group_size,
                       groups_buf.data_ptr(), plan.base.windows.data_ptr(), incumbent.data_ptr(),
                       ptr(sigma) if knobs.cem else None, ptr(noise_in), ptr(noise_out),
                       ws.costs.data_ptr(), argmin, partials, keys, ws.out.data_ptr(),
                       ptr(ws.sigma), ptr(ws.elites), stream)
    if rc != 0:
        msg = ("unsupported shape, knob or alignment" if rc < 0
               else lib.sg_error_string(rc).decode())
        raise RuntimeError(f"sampling_groups launch failed ({rc}): {msg}")


sampling_groups.launches = {"random_sampling": 0, "mppi": 0, "cem_mppi": 0}
