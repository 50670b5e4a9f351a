"""Gait-adaptive sampling MPC: the step frequency chosen among candidates inside the solve.

Counterpart of ``quadruped_pympc_tamols_tpu/controllers/sampling/gait_adaptive.py``
(reference controllers/sampling/centroidal_nmpc_jax_gait_adaptive.py). The samples
are partitioned into K groups, one per candidate step frequency
(``mpc.step_freq_available``). Each group's contact sequence comes from the gait
phase through the in-rollout timer, its spline basis from per-leg stance counters
(the spline phase advances only during stance), and its cost carries the
frequency regularization (f - 1.3)^2 * 100 (reference :341-356, :500). The best
sample returns its parameters and the frequency of its group.

Part 1 is host numpy in float32, in the JAX functions' order of operations:
``timer_sequence``, ``leg_basis`` and ``group_operators``. Part 2 is the solver,
``make_gait_adaptive_solver`` and ``GaitAdaptiveSamplingMPC``; its iteration runs
through ``ops.sampling_groups.sampling_groups``: kernel K1e on CUDA, the plain
version on the CPU. Like the JAX package's XLA solver, it runs one iteration a
tick, always uses the gravity share (not ``sampling.equilibrium_share``) and does
not shift the solution; it keeps the ZMP-band cost (``sampling.zmp_weight > 0``)
on both devices. Each group's traced basis reaches K1e as its rows' windows of
four weights (``ops.sampling_kernel.basis_windows``).
"""
from __future__ import annotations

import numpy as np
import torch

from ...config import Config
from ...ops import sampling_groups as sg
from ...ops import sampling_kernel as rs
from ...ops import sampling_softmax as sm
from ...utils.device import resolve_device
from .rollout import gravity_share
from .sampling_mpc import SamplingMPC, SamplingState, SolveOutput, _host
from .splines import num_params_per_leg

# -- part 1: the groups' operators (host numpy, float32) ----------------------------


def timer_sequence(phase, freq, duty, mpc_dt, horizon) -> np.ndarray:
    """(..., 4, H) contact sequences of the in-rollout gait timer for the candidate
    frequencies ``freq`` (...,) from the phase (4,), in float32.

    As JAX ``_timer_sequence``: each column first wraps the timer (t >= 1 resets to
    0, not t - 1), then advances it by mpc_dt * f (the constant ``mpc.dt``), then
    reads t < duty, so the phase advances before the first column."""
    f = np.asarray(freq, np.float32)
    inc = (np.float32(mpc_dt) * f)[..., None]
    t = np.broadcast_to(np.asarray(phase, np.float32), f.shape + (4,)).copy()
    duty = np.float32(duty)
    cols = np.empty(f.shape + (4, horizon), np.float32)
    for n in range(horizon):
        t = np.where(t >= np.float32(1.0), np.float32(0.0), t)
        t = t + inc
        cols[..., n] = t < duty
    return cols


def leg_windows(parametrization: str, counters, horizon_legs, H: int, S: int,
                P_leg: int) -> tuple:
    """Per-leg spline basis with data-dependent stance phase, as JAX
    ``_traced_leg_basis``, as each row's window of four weights: counters (..., 4,
    H') stance-step counters, horizon_legs (..., 4) per-leg stance count + 1.
    Returns (weights (..., 4, H', 3, 4) float32, first (..., 4, H', 3) int): row
    (leg, n, a) is params_leg[first:first + 4] @ weights, every other parameter's
    weight 0; first is the row's first nonzero moved left as far as the window
    must to end within the leg (a zero-order hold or a linear spline at the leg's
    last parameters).

    The chunk index comes from the static horizon boundaries and is clipped;
    q = s / (hl / S) - idx is not clipped (negative on a leg that starts in swing,
    whose counter is -1); the cubic layout keeps the stride-10 quirk. Each weight
    is the JAX basis's sum of one-hot terms restricted to the window, so it has
    its bits."""
    s = np.asarray(counters, np.float32)
    hl = np.asarray(horizon_legs, np.float32)[..., None]
    iota = np.arange(4)

    def placed(start, coefs):
        """The window of each axis a (the last axis of start) holding coefs at
        start, start + 1, ...: (weights, first)."""
        first = np.minimum(start, P_leg - 4)
        off = (start - first)[..., None]
        w = sum(c[..., None] * (iota == off + k) for k, c in enumerate(coefs))
        return np.asarray(w, np.float32), first

    if parametrization == "zero_order":
        idx = np.clip(s.astype(np.int32), 0, H - 1)
        return placed(idx[..., None] + H * np.arange(3), [np.float32(1.0)])

    boundaries = np.linspace(0.0, float(H), S + 1).astype(np.float32)
    idx = np.sum(s[..., None] >= boundaries[:-1], axis=-1) - 1
    idx = np.clip(idx, 0, S - 1)
    q = (s / (hl / np.float32(S)) - idx.astype(np.float32))[..., None]
    one = np.float32(1.0)
    if parametrization == "linear_spline":
        return placed(idx[..., None] + (S + 1) * np.arange(3), [one - q, q])
    if parametrization != "cubic_spline":
        raise ValueError(f"unknown parametrization {parametrization!r}")
    q2, q3 = q * q, q * q * q
    two, three = np.float32(2.0), np.float32(3.0)
    a_b = two * q3 - three * q2 + one
    b_b = q3 - two * q2 + q
    c_b = -two * q3 + three * q2
    d_b = q3 - q2
    # si + 4a + 3 <= 10 (S - 1) + 11 < 12 S = P_leg: no window moves.
    w = np.stack([-b_b / two, a_b - d_b / two, b_b / two + c_b, d_b / two], axis=-1)
    return (np.broadcast_to(w, q.shape[:-1] + (3, 4)),
            (10 * idx)[..., None] + 4 * np.arange(3))


def leg_basis(parametrization: str, counters, horizon_legs, H: int, S: int,
              P_leg: int) -> np.ndarray:
    """``leg_windows`` as dense weights: (..., 4, H', 3, P_leg) float32 with
    f_a(leg, n) = params_leg @ W[leg, n, a], the JAX ``_traced_leg_basis``."""
    w, first = leg_windows(parametrization, counters, horizon_legs, H, S, P_leg)
    W = np.zeros(first.shape + (P_leg,), np.float32)
    np.put_along_axis(W, first[..., None] + np.arange(4), w, axis=-1)
    return W


def group_operators(cfg: Config, phase, freqs) -> sg.GroupInputs:
    """The K candidate groups' operators for the gait phase (4,) and the candidate
    frequencies (K,), as the JAX solver builds them per group: the timer contact
    sequence, the stance counters cumsum(seq) - 1 and per-leg stance counts + 1,
    their own-leg basis blocks in step-major rows (and the same rows' windows,
    the kernel's layout), the gravity share m*g/max(n_stance, 1) and the offset
    (f - 1.3)^2 * 100."""
    sp = cfg.mpc.sampling
    H, S = cfg.mpc.horizon, sp.num_splines
    P_leg = num_params_per_leg(sp.parametrization, H, S)
    freqs = np.asarray(freqs, np.float32)
    K = freqs.shape[0]
    seq = timer_sequence(phase, freqs, cfg.gait_params.duty_factor, cfg.mpc.dt, H)  # (K, 4, H)
    counters = np.cumsum(seq, axis=-1) - np.float32(1.0)
    horizon_legs = np.sum(seq, axis=-1) + np.float32(1.0)
    w, first = leg_windows(sp.parametrization, counters, horizon_legs, H, S, P_leg)
    # Step-major rows n*12 + leg*3 + axis: (K, 4, H, 3, ...) -> (K, H*12, ...).
    w, first = w.transpose(0, 2, 1, 3, 4), first.transpose(0, 2, 1, 3)
    blocks = np.zeros((K, H, 4, 3, P_leg), np.float32)
    np.put_along_axis(blocks, first[..., None] + np.arange(4), w, axis=-1)
    windows = np.empty((K, H, 4, 3, rs.WINDOW_FLOATS), np.float32)
    windows[..., :4] = w
    ints = windows[..., 4:].view(np.int32)
    ints[..., 1:] = 0
    ints[..., 0] = first + P_leg * np.arange(4)[:, None]
    mg = np.float32(cfg.robot.mass) * np.float32(9.81)
    share = mg / np.maximum(np.sum(seq, axis=-2), np.float32(1.0))
    d = freqs - np.float32(1.3)
    return sg.GroupInputs(seq, share.astype(np.float32), blocks.reshape(K, H * 12, P_leg),
                          d * d * np.float32(100.0), windows.reshape(K, H * 12, -1))


def host_best_freq(out: SolveOutput) -> float:
    """The step frequency of the best sample's group, read from the tick's one
    host summary (waiting for it if it is still in flight)."""
    if out.ready is not None:
        out.ready.synchronize()
    idx = int(out.summary[25])
    K = len(out.group_freqs)
    return float(out.group_freqs[idx // (out.costs.shape[0] // K)])


# -- part 2: the solver ----------------------------------------------------------------


def make_gait_adaptive_solver(cfg: Config, num_samples: int | None = None,
                              method: str | None = None, device="cuda"):
    """Build the gait-adaptive solve for a static config.

    Returns ``(solve, P)`` with ``solve(state12, feet, ref12, ref_feet, phase,
    nominal_freq, optimize_swing, contact_seq0, current_contact, previous_contact,
    sampling_state) -> (SolveOutput, SamplingState)``. The per-tick inputs are
    host data; the outputs live on ``device``. ``SolveOutput.best_freq`` is None:
    the frequency follows from the summary's best index (``host_best_freq``), so
    the tick still copies one summary to the host."""
    device = resolve_device(device)
    knobs = sm.make_knobs(cfg, method)
    plan = sg.make_group_plan(cfg, num_samples or cfg.mpc.sampling.num_samples, device)
    if device.type == "cuda":
        sg.check_kernel(plan, knobs)
    P_leg, P = plan.base.params_per_leg, plan.base.num_parameters
    H = plan.base.horizon
    freq_avail = np.asarray(cfg.mpc.step_freq_available, np.float32)
    mass = float(np.float32(cfg.robot.mass))
    no_footholds = torch.zeros(4, 3, device=device)

    def solve(state12, feet, ref12, ref_feet, phase, nominal_freq, optimize_swing, contact_seq0,
              current_contact, previous_contact, sampling_state: SamplingState):
        state12, feet, ref12 = _host(state12).reshape(12), _host(feet).reshape(4, 3), \
            _host(ref12).reshape(12)
        ref_feet, contact_seq0 = _host(ref_feet).reshape(4, 3), _host(contact_seq0)
        cur, prev = _host(current_contact).reshape(4), _host(previous_contact).reshape(4)

        best = sampling_state.best_parameters
        liftoff = (prev == 1.0) & (cur == 0.0)  # warm-start reset (reference :612-625)
        if liftoff.any():
            best = best * torch.from_numpy(np.repeat(~liftoff, P_leg).astype(np.float32)).to(device)
        feet_eff = np.where(cur[:, None] == 0.0, ref_feet, feet).astype(np.float32)

        # Candidate frequencies (reference :688-692): the available set when the
        # swing is being optimized, else K copies of the nominal frequency.
        freqs = freq_avail if optimize_swing else np.full(plan.num_groups, nominal_freq,
                                                          np.float32)
        groups = group_operators(cfg, _host(phase).reshape(4), freqs)
        share0 = gravity_share(torch.from_numpy(contact_seq0), mass)[:, None].expand(H, 4)
        tick = rs.TickInputs(state12, feet_eff, ref12, contact_seq0, share0.numpy())
        seed, offset = sampling_state.seed, sampling_state.offset
        costs, packed, sigma, _ = sg.sampling_groups(plan, knobs, tick, groups, best,
                                                     sampling_state.sigma, seed, offset)
        best, summary = packed[rs.OUT_WINNER:], packed[0:26]
        out = SolveOutput(grfs=summary[1:13].reshape(4, 3), footholds=no_footholds,
                          predicted_state=summary[13:25], best_parameters=best,
                          best_cost=summary[0], costs=costs, sigma=sigma, best_freq=None,
                          summary=summary, group_freqs=freqs)
        return out, SamplingState(best, seed, offset + 1, sigma)

    return solve, P


class GaitAdaptiveSamplingMPC(SamplingMPC):
    """Host-facing wrapper holding the SamplingState, as ``SamplingMPC``; its
    ``compute_control`` also takes the gait phase, the nominal step frequency and
    the ``optimize_swing`` flag (reference srbd_controller_interface.py:118-180).
    Read the frequency with ``host_best_freq``."""

    make_solver = staticmethod(make_gait_adaptive_solver)

    def compute_control(self, state_current: dict, ref_state: dict, contact_sequence,
                        current_contact, previous_contact, phase_signal,
                        nominal_step_frequency, optimize_swing) -> SolveOutput:
        state12, feet, ref12, ref_feet = self._arrays(state_current, ref_state)
        out, self.state = self.solve(state12, feet, ref12, ref_feet, phase_signal,
                                     nominal_step_frequency, bool(optimize_swing),
                                     contact_sequence, current_contact, previous_contact,
                                     self.state)
        return self._start_copy(out)

