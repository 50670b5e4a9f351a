"""The sample-sharded sampling solver and the multi-chip fleet step on torch.distributed.

Counterpart of ``quadruped_pympc_tamols_tpu/parallel/sharded.py``, which maps two
of the reference's parallelism dimensions onto a ``jax.sharding.Mesh`` with the
axes ("scenario", "sample"):

* the rollout batch of one solve shards over the "sample" axis: each shard rolls
  out its N / n_sample samples, and the winner (random sampling) or the softmax
  update (MPPI, CEM-MPPI) is merged with collectives;
* independent closed-loop scenarios shard over the "scenario" axis, and the fleet's
  metrics are summed over it.

Here the mesh is a grid of ranks of the default process group (``scenario_mesh``),
rank = scenario_row * n_sample + sample_col, with one process group a row (the
sample axis) and one a column (the scenario axis). Each rank's shard runs through
the hand-written kernels on the card: K1a for random sampling, K1b and K1c for
MPPI and CEM-MPPI, and K1f for a rank's scenarios of the fleet, with the knobs of
their C entries that the merge needs:

* only the first shard's sample 0 is the incumbent; the others draw noise there
  (``sampling_kernel.with_drawn_column0``, on K1a-K1c and K1f), or CEM's global
  elite set would hold a copy of the incumbent from every shard;
* MPPI and CEM (K1b, K1c) weigh every sample by exp(-(c - beta)/T) with beta the
  lowest cost over all shards and divide the summed S = sum w * noise by the
  summed Z = sum w (JAX ``sharded.py:103-106``): the update pass takes beta from
  the caller, an all-reduce (MIN) after the rollout pass, and hands back S and Z
  unnormalized for an all-reduce (SUM). The sums over the samples stay in the
  kernel.

CEM's elites stay per shard (K1c returns each shard's K lowest); their parameter
columns and costs are gathered and the global K lowest taken in (cost, position)
order as ``jax.lax.top_k`` takes them, and sigma is refit from those columns, as
the JAX package does in XLA outside its Pallas kernel (``sharded.py:112-124``).
The step-0 GRFs and the predicted state of the merged parameters are torch ops
(JAX ``_extract``). On the CPU every shard runs the kernels' plain versions over
gloo. The gloo backend takes no CUDA tensor for some collectives, so a CUDA
tensor is staged through host memory for it; with NCCL it stays on the card. The
solve runs eagerly: gloo cannot be captured into a CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..controllers.sampling.rollout import gravity_share
from ..controllers.sampling.sampling_mpc import FleetSamplingState, SamplingState
from ..dynamics.srbd import integrate_euler, make_params
from ..ops import sampling_fleet as fleet
from ..ops import sampling_kernel as rs
from ..ops import sampling_softmax as sm
from ..utils.device import resolve_device

METHODS = ("random_sampling", "mppi", "cem_mppi")
_GOLDEN = 0x9E3779B97F4A7C15  # the rank-distinct Philox seeds of the sample shards


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("scenario", "sample") grid of ranks and its process groups, as this rank
    sees it. ``coords`` is None, and every group None, on a rank outside the mesh."""

    shape: dict  # {"scenario": n_scenario, "sample": n_sample}
    ranks: tuple  # the mesh's global ranks, row-major
    coords: tuple | None  # (scenario_row, sample_col) of this rank
    sample_group: Any  # this rank's row: the ranks that shard one solve's samples
    scenario_group: Any  # this rank's column: one rank of every scenario row

    @property
    def member(self) -> bool:
        return self.coords is not None


def scenario_mesh(n_scenario: int, n_sample: int, group=None) -> Mesh:
    """The ("scenario", "sample") mesh over the first n_scenario * n_sample ranks of
    ``group`` (the default process group if None). Every rank of the world must
    call it, in the same order as its other ``new_group`` calls: it creates one
    process group a row and one a column. Raises ValueError when the group has
    fewer ranks than the mesh, as the JAX package does for devices."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.multihost.init_multihost first")
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(dist.get_world_size())))
    need = n_scenario * n_sample
    if len(ranks) < need:
        raise ValueError(f"need {need} ranks, have {len(ranks)}")
    mesh_ranks = tuple(ranks[:need])
    rows = [dist.new_group(list(mesh_ranks[r * n_sample:(r + 1) * n_sample]))
            for r in range(n_scenario)]
    cols = [dist.new_group(list(mesh_ranks[c::n_sample])) for c in range(n_sample)]
    me = dist.get_rank()
    coords = None
    if me in mesh_ranks:
        k = mesh_ranks.index(me)
        coords = (k // n_sample, k % n_sample)
    return Mesh({"scenario": n_scenario, "sample": n_sample}, mesh_ranks, coords,
                rows[coords[0]] if coords else None, cols[coords[1]] if coords else None)


# -- collectives that take CUDA tensors on gloo --------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``op`` over ``group`` of ``t`` (left as it is), on ``t``'s device; a CUDA tensor
    is staged through host memory for gloo."""
    x = t.detach().cpu() if _staged(t, group) else t.detach().clone()
    dist.all_reduce(x, op=op, group=group)
    return x.to(t.device)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ``t`` (k, ...) of every rank of ``group``, concatenated in rank order along
    dim 0 (``jax.lax.all_gather(..., tiled=True)``), on ``t``'s device."""
    x = t.detach().cpu() if _staged(t, group) else t.detach()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts).to(t.device)


def shard_seed(seed, col: int):
    """The Philox seed of sample shard ``col`` for a solve seeded ``seed`` (an int or
    an int64 tensor): shard 0 keeps it, the others are moved off it."""
    if col == 0:
        return seed
    if isinstance(seed, torch.Tensor):
        return seed + (col * _GOLDEN) % (1 << 63)
    return (int(seed) + col * _GOLDEN) % (1 << 64)


def _shard_plan(cfg: Config, n_local: int, col: int, device):
    plan = rs.make_rs_plan(cfg, n_local, device)
    return rs.with_drawn_column0(plan) if col != 0 else plan


def _local_knobs(cfg: Config, method: str, n_local: int) -> sm.Knobs:
    knobs = sm.make_knobs(cfg, method)
    return dataclasses.replace(knobs, n_elite=min(knobs.n_elite, n_local)) if knobs.cem \
        else knobs


def _merge_winner(best, winner, group):
    """Random sampling's merge over the sample shards, for S problems at once: best
    (S,) each shard's lowest cost, winner (S, P) its parameters. Returns the lowest
    cost over the shards (S,) and the mean of the winners of the shards that reach
    it (JAX ``sharded.py:95-101``)."""
    g_best = all_reduce(best, dist.ReduceOp.MIN, group)
    is_winner = (best == g_best).to(winner.dtype)
    tot = all_reduce(torch.cat([winner * is_winner[:, None], is_winner[:, None]], dim=1),
                     dist.ReduceOp.SUM, group)
    return g_best, tot[:, :-1] / tot[:, -1:]


def _sharded_iteration(cfg: Config, mesh: Mesh, n_local: int, method: str, device="cuda"):
    """This rank's shard of one sampling iteration, merged over its sample group.

    Returns ``iteration(tick, incumbent (P,), sigma (P,), seed, offset, noise=None)
    -> (new_params (P,), best_cost (1,), new_sigma (P,), elites)``; ``noise`` (P,
    n_local) replaces the shard's drawn noise (column 0 included). ``elites`` is
    CEM's global elite set as sample numbers over the whole solve (shard * n_local
    + index) in (cost, position) order, None for the other methods."""
    dev = resolve_device(device)
    if method not in METHODS:
        raise ValueError("the sharded solver supports random_sampling | mppi | cem_mppi")
    col = mesh.coords[1]
    group = mesh.sample_group
    plan = _shard_plan(cfg, n_local, col, dev)
    knobs = _local_knobs(cfg, method, n_local)
    P = plan.num_parameters
    n_elite = cfg.mpc.sampling.cem_elite
    if dev.type == "cuda":
        sm.check_kernel_knobs(plan, knobs)

    def iteration(tick, incumbent, sigma, seed, offset, noise=None):
        seed = shard_seed(seed, col)
        if method == "random_sampling":
            _, out = rs.sampling_rs(plan, tick, incumbent, seed, offset, noise_in=noise)
            best, new = _merge_winner(out[0:1], out[rs.OUT_WINNER:][None], group)
            return new[0], best, sigma, None
        merged = []

        def merge_beta(local):
            merged.append(all_reduce(local, dist.ReduceOp.MIN, group))
            return merged[-1]

        sums = torch.empty(P + 1, dtype=torch.float32, device=dev)
        used = noise
        if knobs.cem and noise is None:
            used = torch.empty(P, n_local, dtype=torch.float32, device=dev)
        costs, _, _, elites = sm.softmax_iteration(
            plan, knobs, tick, incumbent, sigma, seed, offset, noise_in=noise,
            noise_out=used if noise is None else None, merge_beta=merge_beta, sums=sums)
        tot = all_reduce(sums, dist.ReduceOp.SUM, group)
        new = incumbent + tot[:P] / tot[P]
        new_sigma, global_elites = sigma, None
        if knobs.cem:
            # The exact global top-k: each shard's elite columns with their costs
            # and sample numbers over the whole solve gathered, the K lowest in
            # (cost, position) order, then the refit on those columns.
            elites = elites.long()
            cols = incumbent[:, None] + used[:, elites]  # (P, k)
            meta = torch.stack([costs[elites], (elites + col * n_local).to(costs.dtype)], 1)
            cand = all_gather_rows(torch.cat([cols.T, meta], dim=1), group)  # (k * shards, P + 2)
            gi = torch.argsort(cand[:, P], stable=True)[:n_elite]
            var = torch.var(cand[gi, :P], dim=0, unbiased=True) + 1e-8
            sp = cfg.mpc.sampling
            new_sigma = torch.clamp(torch.sqrt(var), sp.cem_sigma_min, sp.cem_sigma_max)
            global_elites = cand[gi, P + 1].long()
        return new, merged[-1], new_sigma, global_elites

    iteration.plan = plan
    return iteration, P


def tick_inputs(state12, feet, ref12, contact_seq, mass: float) -> rs.TickInputs:
    """The solver's tick from host arrays: float32, with the gravity share of
    ``contact_seq`` (4, H) for a robot of ``mass``."""
    seq = np.asarray(contact_seq, np.float32)
    share = gravity_share(torch.from_numpy(seq), mass)[:, None].expand(-1, 4).numpy()
    return rs.TickInputs(np.asarray(state12, np.float32).reshape(12),
                         np.asarray(feet, np.float32).reshape(4, 3),
                         np.asarray(ref12, np.float32).reshape(12), seq, share)


def make_sharded_sampling_solver(cfg: Config, mesh: Mesh, num_samples: int | None = None,
                                 method: str | None = None, device="cuda"):
    """Sampling MPC with the rollout batch sharded over the mesh's sample axis: N //
    n_sample samples a rank of this rank's row.

    Returns ``(solve, P)`` with ``solve(state12 (12,), feet (4, 3), ref12 (12,),
    contact_seq (4, H), mpc_state: SamplingState, noise=None) -> (grfs (4, 3),
    new_state, best_cost (1,))``, the inputs host arrays, every rank of the row
    given the same, and the outputs equal on all of them. As the JAX solver, one
    iteration with the gravity share and no warm-start reset, shift or swing-foot
    substitution; the next state keeps the seed and advances the offset by one.
    ``noise`` (P, N // n_sample) replaces this rank's drawn noise."""
    dev = resolve_device(device)
    sp = cfg.mpc.sampling
    method = method or sp.method
    if not mesh.member:
        raise ValueError("this rank is not on the mesh")
    N = num_samples or sp.num_samples
    n_local = N // mesh.shape["sample"]
    iteration, P = _sharded_iteration(cfg, mesh, n_local, method, dev)
    plan = iteration.plan
    mass = float(np.float32(cfg.robot.mass))

    def solve(state12, feet, ref12, contact_seq, mpc_state: SamplingState, noise=None):
        tick = tick_inputs(state12, feet, ref12, contact_seq, mass)
        new, best, new_sigma, _ = iteration(tick, mpc_state.best_parameters, mpc_state.sigma,
                                            mpc_state.seed, mpc_state.offset, noise)
        t = rs.tick_tensors(tick, new.device)
        grfs, _ = rs.step0_reference(new, plan.W, t[0], t[1], t[3], t[4], plan.dts, plan.srbd,
                                     plan.fm)
        return grfs, SamplingState(new, mpc_state.seed, mpc_state.offset + 1, new_sigma), best

    solve.plan, solve.iteration = plan, iteration
    return solve, P


def _rows(state, sl):
    """The scenario rows ``sl`` of a ScenarioState."""
    from .scenario_engine import ScenarioState

    return ScenarioState.from_tensors([t[sl] for t in state.tensors()])


def make_multichip_step(cfg: Config, mesh: Mesh, scenarios_per_device: int = 1,
                        num_samples: int = 240, terrain: str | None = None, device="cuda"):
    """The multi-chip fleet step: closed-loop MPC scenarios, ``scenarios_per_device``
    on each scenario row of the mesh, each solve's samples sharded over the row.

    Port of the JAX package's own tick (``sharded.py:218-270``), not the scenario
    engine's: random sampling only, no solution shift, swing-foot substitution or
    reflex, the gravity share. A rank's scenarios go through K1f as one launch; the
    winner merge runs on (S_local,) vectors over the sample group; the fleet
    metrics [mean velocity error, mean best cost] are summed over the scenario
    group (one rank a row: the rows of a column hold every scenario once) and
    divided by B, so every rank of the mesh gets them. With ``terrain``
    ("boxes", "stairs", "perlin") each scenario's footholds are TAMOLS-adapted
    against its own heightfield.

    Returns ``(step, init, P)``: ``step(states, cmd_vels (S_local, 3), noise=None)
    -> (states', metrics (2,))`` with ``noise`` (S_local, P, num_samples //
    n_sample) replacing this rank's drawn noise, and ``init(seed=0)`` this rank's
    S_local scenarios of the B = n_scenario * scenarios_per_device the scenario
    engine's ``init_scenario_state`` builds from ``torch.Generator().manual_seed(seed)``
    (its terrain draws injectable through ``make_terrain_generator``)."""
    from ..gait.foothold_reference import raibert_footholds_torch
    from ..gait.periodic import contact_sequence_torch, make_timer_dts
    from ..gait.swing import bezier_swing_refs_torch
    from ..kinematics.leg_ik import LegKinematics
    from ..utils.frames import euler_xyz_to_rot
    from .scenario_engine import (ScenarioState, init_scenario_state, make_terrain_adapter,
                                  make_terrain_generator)

    dev = resolve_device(device)
    if not mesh.member:
        raise ValueError("this rank is not on the mesh")
    row, col = mesh.coords
    spd = scenarios_per_device
    B = mesh.shape["scenario"] * spd
    n_local = num_samples // mesh.shape["sample"]
    plan = _shard_plan(cfg, n_local, col, dev)
    knobs = sm.make_knobs(cfg, "random_sampling")
    if dev.type == "cuda":
        sm.check_kernel_knobs(plan, knobs)
    P, P_leg, H = plan.num_parameters, plan.params_per_leg, plan.horizon
    srbd = make_params(cfg, device=dev)
    mass = float(np.float32(cfg.robot.mass))
    gait = cfg.gait_params
    t_off = torch.as_tensor(make_timer_dts(cfg.mpc), device=dev)
    dt_ctrl = 1.0 / cfg.sim.mpc_frequency
    n_sub = max(1, int(round(dt_ctrl / cfg.sim.dt)))
    dt_sub = torch.tensor(dt_ctrl / n_sub, dtype=torch.float32, device=dev)
    hip_offsets = torch.as_tensor(LegKinematics(cfg.robot).hip_offsets_b, device=dev)
    adapt = make_terrain_adapter(cfg, dev) if terrain is not None else None
    terrain_gen = make_terrain_generator(terrain, dev) if terrain is not None else None
    ref_z = cfg.sim.ref_z

    def step(s: ScenarioState, cmd_vels: torch.Tensor, noise=None):
        S = s.x.shape[0]
        cmd = cmd_vels.to(dev, torch.float32).reshape(S, 3)
        phase = torch.remainder(s.phase + dt_ctrl * gait.step_freq, 1.0)
        seq = contact_sequence_torch(phase, gait.step_freq, gait.duty_factor, t_off)
        cur, prev = seq[..., 0], s.prev_contact
        swing = cur[..., None] == 0.0
        liftoff_edge = (prev == 1.0) & (cur == 0.0)
        liftoff = torch.where(liftoff_edge[..., None], s.feet, s.liftoff)
        swing_time = torch.where(cur == 0.0, s.swing_time + dt_ctrl, 0.0)

        R = euler_xyz_to_rot(s.x[:, 6:9])
        hips = s.x[:, None, 0:3] + hip_offsets @ R.transpose(1, 2)
        ref_feet = raibert_footholds_torch(
            s.x[:, 0:3], s.x[:, 6:9], s.x[:, 3:5], cmd[:, :2], hips, torch.zeros_like(cur),
            gait.stance_time, cfg.robot.hip_height, ref_z)
        zeros3 = torch.zeros_like(cmd)
        base_ref = torch.stack([zeros3[:, 0], zeros3[:, 1], zeros3[:, 2] + ref_z], dim=1)
        if adapt is not None:
            anchor = torch.where(swing, liftoff, s.feet)
            adapted, td_z = adapt(s.terrain, ref_feet, hips, s.x[:, 0:3], s.x[:, 3:6], s.x[:, 8],
                                  cur, s.feet, anchor)
            ref_feet = torch.where(swing, adapted, ref_feet)
            ground = torch.sum(s.feet[..., 2] * cur, dim=1) / torch.clamp(torch.sum(cur, dim=1),
                                                                          min=1.0)
            base_ref = torch.stack([base_ref[:, 0], base_ref[:, 1], base_ref[:, 2] + ground], 1)
        else:
            td_z = torch.zeros_like(cur)
        ref12 = torch.cat([base_ref, cmd, zeros3, zeros3], dim=1)

        # Warm-start reset at lift-off, then this shard's iteration on K1f for the
        # rank's scenarios and the winner merge over the sample group.
        keep = (~liftoff_edge)[:, :, None].expand(S, 4, P_leg).reshape(S, P)
        params0 = s.mpc.best_parameters * keep.to(torch.float32)
        share = gravity_share(seq, mass)[..., None].expand(S, H, 4)
        tick = fleet.FleetTick(s.x, s.feet, ref12, seq, share)
        _, out, _, _ = fleet.fleet_iteration(plan, knobs, tick, params0.contiguous(),
                                             s.mpc.sigma, shard_seed(s.mpc.seed, col),
                                             s.mpc.offset, 0, noise_in=noise)
        best, new = _merge_winner(out[:, 0], out[:, rs.OUT_WINNER:], mesh.sample_group)
        grfs, _ = fleet.step0_batched(new, plan.W, tick, plan.dts, plan.srbd, plan.fm)

        x_next = s.x
        for _ in range(n_sub):
            x_next = integrate_euler(x_next, s.feet, grfs, cur, srbd, dt_sub)
        pos = bezier_swing_refs_torch(swing_time, gait.swing_period, cfg.sim.step_height,
                                      liftoff, ref_feet)[0]
        touchdown = ((prev == 0.0) & (cur == 1.0))[..., None]
        feet = torch.where(swing, pos, s.feet)
        feet = torch.where(touchdown, torch.cat([ref_feet[..., :2], td_z[..., None]], dim=-1),
                           feet)
        mpc = FleetSamplingState(new.contiguous(), s.mpc.sigma, s.mpc.seed, s.mpc.offset + 1)
        s2 = ScenarioState(x_next, feet, phase, swing_time, liftoff, cur, mpc, s.terrain,
                           s.reflex, s.hitpoint)
        vel_err = torch.linalg.vector_norm(x_next[:, 3:5] - cmd[:, :2], dim=1)
        sums = torch.stack([torch.sum(vel_err), torch.sum(best)])
        return s2, all_reduce(sums, dist.ReduceOp.SUM, mesh.scenario_group) / B

    def init(seed: int = 0) -> ScenarioState:
        gen = torch.Generator().manual_seed(int(seed))
        states = init_scenario_state(cfg, P, B, gen, terrain_gen, dev)
        return _rows(states, slice(row * spd, (row + 1) * spd))

    return step, init, P
