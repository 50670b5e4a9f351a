"""Sampling-based MPC (random-sampling / MPPI / CEM-MPPI) in torch.

Counterpart of ``quadruped_pympc_tamols_tpu/controllers/sampling/sampling_mpc.py``
(reference Sampling_MPC, controllers/sampling/centroidal_nmpc_jax.py:20-1097). One
solve performs the lift-off warm-start reset (reference :612-625), the optional
solution shift (:513-561), swing-foot substitution (:588-595), the gravity share
or static-equilibrium share, the sampling iteration(s), and the winner's step-0
GRFs and one-step predicted state (:707-746).

Where the iterations run:

* CUDA: the hand-written kernels, all three methods at any ``num_iterations``:
  ``random_sampling`` through K1a (``ops.sampling_kernel.sampling_rs``), ``mppi``
  through K1b and ``cem_mppi`` through K1c (``ops.sampling_softmax.
  softmax_iteration``), chained
  on the card by K1d (``ops.sampling_softmax.sampling_chain``): each iteration
  reads the previous one's parameters (and CEM sigma) from device memory. The
  tick's inputs ride each launch as its by-value argument block and the outputs
  stay on the card; the host copies back one 25-float summary [best cost, GRFs
  (12), predicted state (12)] per tick (``SamplingMPC`` starts that copy,
  ``host_summary`` reads it). The kernels are built for a (horizon, parameters
  per leg) pair the first time a solver asks for it (``ops/build.py``): every
  pair with 2 <= H <= 128 and P = 4 * P_leg <= 1024 (the Pallas kernel's own
  bound), beyond which ``build.check_pair`` raises NotImplementedError naming the
  bound; they compute the ZMP-band cost (``sampling.zmp_weight > 0``) and CEM with
  any elite count 2 <= K <= N.
* CPU: the kernels' plain versions through the same wrappers, for all three
  methods and the ZMP-band cost.

``make_fleet_sampling_solver`` is the same solve for S scenarios at once, the
counterpart of ``jax.vmap`` over the JAX solver that the scenario fleet runs
(``parallel/scenario_engine.py``): every input and output has a leading scenario
axis and stays on the device, and each iteration is one launch of K1f's passes for
all S (``ops.sampling_fleet.fleet_iteration``) on CUDA, or its plain version on
the CPU. It makes no host copy and reads nothing back, so a fleet tick can be
captured as one CUDA graph.

Random numbers: a ``SamplingState`` carries a (seed, offset) pair. The kernels key
Philox4x32-10 on it; the CPU path seeds a ``torch.Generator`` from it. Each
iteration advances the offset by one. The streams differ by construction, so the
tests compare the two paths with injected or zero noise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ...config import Config
from ...ops import sampling_fleet as fleet
from ...ops import sampling_kernel as rs
from ...ops import sampling_softmax as sm
from ...utils.device import resolve_device
from .rollout import equilibrium_share, gravity_share
from .splines import make_shift_basis

_LEGS = ("FL", "FR", "RL", "RR")


class SolveOutput(NamedTuple):
    grfs: Any  # (4, 3) world-frame ground reaction forces for the first step
    footholds: Any  # (4, 3) zeros; sampling MPC does not optimize footholds
    predicted_state: Any  # (12,) one-step-ahead base state
    best_parameters: Any  # (P,)
    best_cost: Any  # scalar
    costs: Any  # (N,) every rollout cost of the last iteration
    sigma: Any  # (P,) CEM sigma state (unchanged unless cem_mppi)
    best_freq: Any  # scalar step frequency
    summary: Any = None  # [best_cost, grfs (12), state (12)] (+ best index: gait-adaptive)
    ready: Any = None  # CUDA event after which a host ``summary`` is filled, or None
    group_freqs: Any = None  # (K,) host candidate frequencies of a gait-adaptive solve


@dataclasses.dataclass
class SamplingState:
    """Controller state carried across MPC ticks."""

    best_parameters: torch.Tensor  # (P,) on the solver's device
    seed: int
    offset: int  # Philox / generator offset of the next iteration
    sigma: torch.Tensor  # (P,) CEM sigma


def host_summary(out: SolveOutput):
    """(grfs (4, 3), predicted_state (12,), best_cost) as host numpy, from the one
    summary copy of the tick (waiting for it if it is still in flight)."""
    if out.ready is not None:
        out.ready.synchronize()
    s = out.summary.detach().cpu().numpy()
    return s[1:13].reshape(4, 3), s[13:25], float(s[0])


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _first_knots(sp, H: int) -> list:
    """The parameters of a leg's first x, y and z knots, which the solution shift
    overwrites (JAX ``sampling_mpc.py:_first_knot_indices``)."""
    if sp.parametrization == "zero_order":
        return [0, H, 2 * H]
    if sp.parametrization == "linear_spline":
        return [0, sp.num_splines + 1, 2 * (sp.num_splines + 1)]
    return [1, 5, 9]  # cubic: the first interior knot of x/y/z in chunk 0


def make_sampling_solver(cfg: Config, num_samples: int | None = None, method: str | None = None,
                         device="cuda"):
    """Build the sampling-MPC solve function for a static config.

    Returns ``(solve, P)`` with ``solve(state12, feet, ref12, ref_feet, contact_seq,
    current_contact, previous_contact, sampling_state) -> (SolveOutput,
    SamplingState)``. The per-tick inputs are host data (numpy arrays or CPU
    tensors); the outputs live on ``device``.
    """
    device = resolve_device(device)
    sp = cfg.mpc.sampling
    knobs = sm.make_knobs(cfg, method)
    if sp.num_iterations < 1:
        raise ValueError(f"sampling.num_iterations must be >= 1, got {sp.num_iterations}")
    N = num_samples or sp.num_samples
    plan = rs.make_rs_plan(cfg, N, device)
    H = plan.horizon
    P_leg, P = plan.params_per_leg, plan.num_parameters
    if device.type == "cuda":
        sm.check_kernel_knobs(plan, knobs)

    mass = float(np.float32(cfg.robot.mass))
    shift_W = torch.as_tensor(make_shift_basis(sp.parametrization, H, sp.num_splines,
                                               1.0 / cfg.sim.mpc_frequency), device=device)
    first_knots = _first_knots(sp, H)
    best_freq = torch.tensor(cfg.gait_params.step_freq, dtype=torch.float32)
    no_footholds = torch.zeros(4, 3, device=device)  # built once: no fill launch per tick

    def _share(contact_seq, state12, feet):
        """(H, 4) per-leg shares on the host: m*g/n_stance for every stance leg
        (reference :377-385), or the static-equilibrium split."""
        c = torch.from_numpy(contact_seq)
        if sp.equilibrium_share:
            return equilibrium_share(torch.from_numpy(feet), torch.from_numpy(state12[:3]), c,
                                     mass, 9.81, cfg.mpc.grf_max).numpy()
        share = gravity_share(c, mass)
        return share[:, None].expand(H, 4).numpy()

    def solve(state12, feet, ref12, ref_feet, contact_seq, current_contact, previous_contact,
              sampling_state: SamplingState):
        """One MPC tick. state12/ref12 (12,), feet/ref_feet (4, 3), contact_seq (4, H),
        current/previous_contact (4,)."""
        state12, feet, ref12 = _host(state12).reshape(12), _host(feet).reshape(4, 3), \
            _host(ref12).reshape(12)
        ref_feet, contact_seq = _host(ref_feet).reshape(4, 3), _host(contact_seq)
        cur, prev = _host(current_contact).reshape(4), _host(previous_contact).reshape(4)

        best = sampling_state.best_parameters
        # Swing-leg warm-start reset at lift-off edges (reference :612-625).
        liftoff = (prev == 1.0) & (cur == 0.0)
        if liftoff.any():
            keep = np.repeat(~liftoff, P_leg).astype(np.float32)
            best = best * torch.from_numpy(keep).to(device)
        if sp.shift_solution:
            # Evaluate each leg's spline slightly ahead and fold it into the first
            # knots (a corrected version of reference shift_solution :513-561).
            leg_params = best.reshape(4, P_leg).clone()
            shifted0 = leg_params @ shift_W  # (4, 3)
            for a in range(3):
                leg_params[:, first_knots[a]] = shifted0[:, a]
            best = leg_params.reshape(P)

        # Swing feet are replaced by their reference footholds.
        feet_eff = np.where(cur[:, None] == 0.0, ref_feet, feet).astype(np.float32)
        share = _share(contact_seq, state12, feet_eff)
        tick = rs.TickInputs(state12, feet_eff, ref12, contact_seq, share)
        seed, offset = sampling_state.seed, sampling_state.offset
        costs, packed, sigma, _ = sm.sampling_chain(plan, knobs, tick, best, sampling_state.sigma,
                                                    seed, offset, sp.num_iterations)[-1]
        offset += sp.num_iterations
        best, summary = packed[rs.OUT_WINNER:], packed[0:25]

        out = SolveOutput(grfs=summary[1:13].reshape(4, 3),
                          footholds=no_footholds,
                          predicted_state=summary[13:25], best_parameters=best,
                          best_cost=summary[0], costs=costs, sigma=sigma, best_freq=best_freq,
                          summary=summary)
        return out, SamplingState(best, seed, offset, sigma)

    return solve, P


@dataclasses.dataclass
class FleetSamplingState:
    """The fleet's controller state, one row a scenario, on the solver's device."""

    best_parameters: torch.Tensor  # (S, P)
    sigma: torch.Tensor  # (S, P) CEM sigma
    seed: torch.Tensor  # (S,) int64 Philox key
    offset: torch.Tensor  # (S,) int64 Philox offset of the next iteration


class FleetSolveOutput(NamedTuple):
    grfs: Any  # (S, 4, 3) step-0 GRFs
    predicted_state: Any  # (S, 12)
    best_parameters: Any  # (S, P)
    best_cost: Any  # (S,)
    costs: Any  # (S, N) every rollout cost of the last iteration
    sigma: Any  # (S, P)


def make_fleet_sampling_solver(cfg: Config, num_samples: int | None = None, device="cuda"):
    """The sampling solve of ``make_sampling_solver`` for S scenarios at once.

    Returns ``(solve, P)`` with ``solve(state12 (S, 12), feet (S, 4, 3), ref12 (S,
    12), ref_feet (S, 4, 3), contact_seq (S, 4, H), current_contact (S, 4),
    previous_contact (S, 4), state: FleetSamplingState, noise=None) ->
    (FleetSolveOutput, FleetSamplingState)``, every tensor on ``device``. ``noise``
    (one (S, P, N) tensor an iteration) replaces the drawn noise."""
    device = resolve_device(device)
    sp = cfg.mpc.sampling
    knobs = sm.make_knobs(cfg)
    if sp.num_iterations < 1:
        raise ValueError(f"sampling.num_iterations must be >= 1, got {sp.num_iterations}")
    plan = rs.make_rs_plan(cfg, num_samples or sp.num_samples, device)
    H, P_leg, P = plan.horizon, plan.params_per_leg, plan.num_parameters
    if device.type == "cuda":
        sm.check_kernel_knobs(plan, knobs)
    mass = float(np.float32(cfg.robot.mass))
    shift_W = torch.as_tensor(make_shift_basis(sp.parametrization, H, sp.num_splines,
                                               1.0 / cfg.sim.mpc_frequency), device=device)
    first_knots = _first_knots(sp, H)
    iterations = sp.num_iterations

    def solve(state12, feet, ref12, ref_feet, contact_seq, current_contact, previous_contact,
              st: FleetSamplingState, noise=None):
        S = state12.shape[0]
        # Swing-leg warm-start reset at lift-off edges (reference :612-625).
        liftoff = (previous_contact == 1.0) & (current_contact == 0.0)
        keep = (~liftoff)[:, :, None].expand(S, 4, P_leg).reshape(S, P)
        best = st.best_parameters * keep.to(torch.float32)
        if sp.shift_solution:
            leg_params = best.reshape(S, 4, P_leg).clone()
            shifted0 = leg_params @ shift_W  # (S, 4, 3)
            for a in range(3):
                leg_params[:, :, first_knots[a]] = shifted0[..., a]
            best = leg_params.reshape(S, P)
        feet_eff = torch.where(current_contact[..., None] == 0.0, ref_feet, feet)
        if sp.equilibrium_share:
            share = equilibrium_share(feet_eff, state12[:, :3], contact_seq, mass, 9.81,
                                      cfg.mpc.grf_max)
        else:
            share = gravity_share(contact_seq, mass)[..., None].expand(S, H, 4)
        tick = fleet.FleetTick(state12, feet_eff, ref12, contact_seq, share)
        scen = fleet.tick_buffer(tick) if device.type == "cuda" else None
        sigma = st.sigma
        for it in range(iterations):
            costs, out, sigma, _ = fleet.fleet_iteration(
                plan, knobs, tick, best, sigma, st.seed, st.offset, it,
                None if noise is None else noise[it], scen=scen)
            best = out[:, rs.OUT_WINNER:]
        res = FleetSolveOutput(out[:, 1:13].reshape(S, 4, 3), out[:, 13:25], best, out[:, 0],
                               costs, sigma)
        return res, FleetSamplingState(best, sigma, st.seed, st.offset + iterations)

    return solve, P


class SamplingMPC:
    """Host-facing wrapper holding the SamplingState.

    ``compute_control(state_current, ref_state, contact_sequence, current, previous)``
    with the reference's dict schema (wb_interface.py:152-166 and :275-291). On
    CUDA it starts the tick's one device-to-host copy (the summary) and returns at
    once; read the result with ``host_summary``.
    """

    make_solver = staticmethod(make_sampling_solver)

    def __init__(self, cfg: Config, num_samples: int | None = None, method: str | None = None,
                 seed: int = 42, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.solve, self.num_parameters = self.make_solver(cfg, num_samples, method, self.device)
        self.seed = seed
        self.reset()

    def compute_control(self, state_current: dict, ref_state: dict, contact_sequence,
                        current_contact, previous_contact) -> SolveOutput:
        state12, feet, ref12, ref_feet = self._arrays(state_current, ref_state)
        out, self.state = self.solve(state12, feet, ref12, ref_feet, contact_sequence,
                                     current_contact, previous_contact, self.state)
        return self._start_copy(out)

    @staticmethod
    def _arrays(state_current: dict, ref_state: dict):
        """(state12, feet (4, 3), ref12, ref_feet (4, 3)) from the dict schema."""
        state12 = np.concatenate([
            np.asarray(state_current["position"]).reshape(3),
            np.asarray(state_current["linear_velocity"]).reshape(3),
            np.asarray(state_current["orientation"]).reshape(3),
            np.asarray(state_current["angular_velocity"]).reshape(3)])
        feet = np.stack([np.asarray(state_current[f"foot_{leg}"]).reshape(3) for leg in _LEGS])
        ref12 = np.concatenate([
            np.asarray(ref_state["ref_position"]).reshape(3),
            np.asarray(ref_state["ref_linear_velocity"]).reshape(3),
            np.asarray(ref_state["ref_orientation"]).reshape(3),
            np.asarray(ref_state["ref_angular_velocity"]).reshape(3)])
        ref_feet = np.stack([np.asarray(ref_state[f"ref_foot_{leg}"]).reshape(3)
                             for leg in _LEGS])
        return state12, feet, ref12, ref_feet

    def _start_copy(self, out: SolveOutput) -> SolveOutput:
        """On CUDA, start the tick's one device-to-host copy, of the summary."""
        if self.device.type == "cuda":
            host = torch.empty(out.summary.shape[0], dtype=torch.float32, pin_memory=True)
            host.copy_(out.summary, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            out = out._replace(summary=host, ready=ready)
        return out

    def reset(self):
        P = self.num_parameters
        offset = getattr(getattr(self, "state", None), "offset", 0)
        self.state = SamplingState(
            best_parameters=torch.zeros(P, dtype=torch.float32, device=self.device),
            seed=self.seed, offset=offset,
            sigma=torch.full((P,), self.cfg.mpc.sampling.sigma_cem_mppi, dtype=torch.float32,
                             device=self.device))
