"""Closed-loop scenario fleet on the device: S MPC loops advance one tick together.

Counterpart of ``quadruped_pympc_tamols_tpu/parallel/scenario_engine.py``, the JAX
package's "training step": gait timing, Raibert footholds (TAMOLS-adapted against
each scenario's own heightfield), the sampling MPC solve, SRB substeps, Bezier
swing feet and the early-stance reflex, for thousands of scenarios at once. The
JAX engine writes one scenario's tick and ``jax.vmap``s it; here every tensor has
a leading scenario axis S in place of the vmap, and the step is a chain of
batched torch ops around the scenario-axis kernel K1f
(``ops/sampling_fleet.py``): one rollout launch and one extraction or update
launch an iteration for all S.

A tick makes no host copy and reads nothing back, so on a CUDA device
``make_scenario_step`` returns the tick captured as one CUDA graph
(``utils/graphs.py``), replayed every call; the state is updated in place, and
each replay adds K1f's captured launches to its count. On the
CPU the same function runs eagerly with K1f's plain version.

Simplifications kept from the JAX engine (vs the host ``WBInterface``): the
base-velocity moving average is the instantaneous velocity and the state is
known exactly. The per-scenario heightfields are drawn from a ``torch.Generator``,
which cannot reproduce ``jax.random`` by seed, so every generator takes its draws
as an injectable dict (``gen.build``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import GAIT_PHASE_OFFSETS, Config
from ..controllers.sampling.sampling_mpc import FleetSamplingState, make_fleet_sampling_solver
from ..dynamics.srbd import integrate_euler, make_params
from ..gait.foothold_reference import raibert_footholds_torch
from ..gait.periodic import contact_sequence_torch, make_timer_dts
from ..gait.swing import bezier_swing_refs_torch
from ..kinematics.leg_ik import LegKinematics
from ..planner.heightmap import GridHeightMap, lookup_nearest
from ..planner.tamols import make_tamols_scorer
from ..utils.device import device_constant, resolve_device
from ..utils.frames import euler_xyz_to_rot
from ..utils.graphs import GraphedFunction


@dataclasses.dataclass
class ScenarioState:
    """S scenarios' closed-loop state, one row a scenario, on one device."""

    x: torch.Tensor  # (S, 12) base state
    feet: torch.Tensor  # (S, 4, 3)
    phase: torch.Tensor  # (S, 4) gait phase
    swing_time: torch.Tensor  # (S, 4)
    liftoff: torch.Tensor  # (S, 4, 3)
    prev_contact: torch.Tensor  # (S, 4)
    mpc: FleetSamplingState
    terrain: torch.Tensor  # (S, R, C) heightfields; (S, 1, 1) zeros when flat
    # The early-stance reflex: the moment into the swing a surface graze was
    # detected (-1: no reflex this swing) and the commanded point it was detected at.
    reflex: torch.Tensor  # (S, 4)
    hitpoint: torch.Tensor  # (S, 4, 3)

    def tensors(self) -> tuple:
        """Every tensor of the state, the sampling state's included, in a fixed order."""
        m = self.mpc
        return (self.x, self.feet, self.phase, self.swing_time, self.liftoff, self.prev_contact,
                m.best_parameters, m.sigma, m.seed, m.offset, self.terrain, self.reflex,
                self.hitpoint)

    @classmethod
    def from_tensors(cls, t) -> "ScenarioState":
        return cls(t[0], t[1], t[2], t[3], t[4], t[5], FleetSamplingState(t[6], t[7], t[8], t[9]),
                   t[10], t[11], t[12])


# Fixed geometry of the per-scenario heightfield: 64 x 64 cells at 8 cm covering
# x in [-0.5, 4.5], y in [-2.5, 2.5] around the walk corridor; only the heights
# vary per scenario.
TERRAIN_ROWS = 64
TERRAIN_COLS = 64
TERRAIN_RES = 0.08
TERRAIN_CENTER = (2.0, 0.0)


def _terrain_grid():
    """(gx, gy): the world x and y of every heightfield cell, float32 (R, C)."""
    i = (np.arange(TERRAIN_ROWS) - (TERRAIN_ROWS - 1) / 2) * TERRAIN_RES + TERRAIN_CENTER[0]
    j = (np.arange(TERRAIN_COLS) - (TERRAIN_COLS - 1) / 2) * TERRAIN_RES + TERRAIN_CENTER[1]
    gx = np.broadcast_to(i[:, None], (TERRAIN_ROWS, TERRAIN_COLS)).astype(np.float32)
    gy = np.broadcast_to(j[None, :], (TERRAIN_ROWS, TERRAIN_COLS)).astype(np.float32)
    return gx, gy


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., "linear")`` along one
    axis: half-pixel sample positions, the triangle kernel, each column normalized
    by its sum, so a border sample takes the border value whole."""
    f = np.float32
    inv_scale = f(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=f) + f(0.5)) * inv_scale - f(0.0) * inv_scale - f(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f)[:, None])
    w = np.maximum(f(0.0), f(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > f(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f(0.0)).astype(f)


def make_terrain_generator(kind: str, device="cuda"):
    """Per-scenario procedural heightfields: ``gen(generator, num_scenarios) ->
    (S, R, C)`` heights on ``device``, as the JAX package's generators (box
    bumps 2-8 cm, stairs of random rise and run, or two octaves of bilinearly
    upsampled value noise up to 9 cm; a flat spawn pad at x < 0.4 m).

    ``gen.draw(generator, S)`` returns the random draws as a dict of CPU tensors
    and ``gen.build(draws)`` the heightfields from them, so that a test can hand
    over the JAX package's own draws: boxes ``centers`` (S, 20, 2), ``half``
    (S, 20, 2), ``heights`` (S, 20); stairs ``rise``, ``run`` (S,); perlin
    ``coarse`` (S, 9, 9) and ``fine`` (S, 17, 17) in [-1, 1)."""
    dev = resolve_device(device)
    gx_np, gy_np = _terrain_grid()
    gx, gy = torch.as_tensor(gx_np, device=dev), torch.as_tensor(gy_np, device=dev)

    def uniform(generator, shape, lo, hi):
        lo, hi = torch.as_tensor(lo, dtype=torch.float32), torch.as_tensor(hi, dtype=torch.float32)
        return torch.rand(shape, generator=generator) * (hi - lo) + lo

    if kind == "boxes":
        def draw(generator, S):
            return dict(centers=uniform(generator, (S, 20, 2), [0.7, -2.0], [4.2, 2.0]),
                        half=uniform(generator, (S, 20, 2), 0.08, 0.3),
                        heights=uniform(generator, (S, 20), 0.02, 0.08))

        def build(d):
            c, half, h = (torch.as_tensor(d[k], dtype=torch.float32, device=dev)
                          for k in ("centers", "half", "heights"))
            inside = ((torch.abs(gx - c[..., 0, None, None]) <= half[..., 0, None, None])
                      & (torch.abs(gy - c[..., 1, None, None]) <= half[..., 1, None, None]))
            hm = torch.amax(torch.where(inside, h[..., None, None], 0.0), dim=1)
            return torch.where(gx < 0.4, 0.0, hm)
    elif kind == "stairs":
        def draw(generator, S):
            return dict(rise=uniform(generator, (S,), 0.03, 0.06),
                        run=uniform(generator, (S,), 0.28, 0.4))

        def build(d):
            rise, run = (torch.as_tensor(d[k], dtype=torch.float32, device=dev)[:, None, None]
                         for k in ("rise", "run"))
            n = torch.clamp(torch.floor((gx - 0.6) / run), 0.0, 7.0)
            return n * rise
    elif kind == "perlin":
        wc = {n: torch.as_tensor(linear_resize_matrix(n, TERRAIN_ROWS), device=dev)
              for n in (9, 17)}
        wr = {n: torch.as_tensor(linear_resize_matrix(n, TERRAIN_COLS), device=dev)
              for n in (9, 17)}

        def draw(generator, S):
            return dict(coarse=uniform(generator, (S, 9, 9), -1.0, 1.0),
                        fine=uniform(generator, (S, 17, 17), -1.0, 1.0))

        def resize(x):
            n = x.shape[-1]
            return wc[n].T @ x @ wr[n]

        def build(d):
            coarse, fine = (torch.as_tensor(d[k], dtype=torch.float32, device=dev)
                            for k in ("coarse", "fine"))
            h = resize(coarse) + 0.5 * resize(fine)
            lo = torch.amin(h, dim=(1, 2), keepdim=True)
            hi = torch.amax(h, dim=(1, 2), keepdim=True)
            h = 0.09 * (h - lo) / (hi - lo + 1e-6)
            # Blend in from the flat spawn pad instead of a step edge.
            return h * torch.clamp((gx - 0.2) / 0.6, 0.0, 1.0)
    else:
        raise ValueError(f"unknown terrain kind {kind!r}")

    def gen(generator, num_scenarios: int):
        return build(draw(generator, num_scenarios))

    gen.draw, gen.build = draw, build
    return gen


def _terrain_map(terrain_h: torch.Tensor) -> GridHeightMap:
    """The scenarios' heightfields (S, R, C) as one batch of grids."""
    S, dev = terrain_h.shape[0], terrain_h.device
    return GridHeightMap(device_constant(TERRAIN_CENTER, dev).expand(S, 2),
                         device_constant(0.0, dev), device_constant(TERRAIN_RES, dev), terrain_h)


def make_terrain_adapter(cfg: Config, device="cuda"):
    """Per-tick terrain sensing and TAMOLS adaptation for the fleet.

    Returns ``adapt(terrain_h (S, R, C), seeds, hips (S, 4, 3), base_pos, base_vel
    (S, 3), yaw (S,), cur (S, 4), feet, own_anchor (S, 4, 3)) -> (footholds (S, 4,
    3), td_z (S, 4))``: per-leg ``cfg.tamols.heightmap_rows x heightmap_cols``
    grids sensed nearest-cell out of each scenario's heightfield, all 4 S legs
    scored at once by the TAMOLS scorer of ``planner/tamols.py``, and the raw
    surface height under each chosen foothold (no sensor offset) for the
    touch-down."""
    dev = resolve_device(device)
    score = make_tamols_scorer(cfg, strategy="tamols", device=dev).legs
    tp = cfg.tamols
    rows, cols = tp.heightmap_rows, tp.heightmap_cols

    def adapt(terrain_h, seeds, hips, base_pos, base_vel, yaw, cur, feet, own_anchor):
        S = terrain_h.shape[0]
        L = 4 * S
        ghm = _terrain_map(terrain_h)
        leg_hms = GridHeightMap(
            center=seeds[..., :2].reshape(L, 2),
            yaw=yaw[:, None].expand(S, 4).reshape(L),
            resolution=torch.full((L,), tp.heightmap_resolution, device=dev),
            heights=torch.zeros((L, rows, cols), device=dev))
        pts = leg_hms.cell_world_xy().reshape(S, 4, rows, cols, 2)
        leg_hms.heights = lookup_nearest(ghm, pts).reshape(L, rows, cols)
        per_leg = (lambda v: v[:, None, :].expand(S, 4, 3).reshape(L, 3))
        res = score(leg_hms, seeds.reshape(L, 3), hips.reshape(L, 3), per_leg(base_pos),
                    per_leg(base_vel), cur.reshape(L), feet.reshape(L, 3),
                    own_anchor.reshape(L, 3))
        footholds = res.footholds.reshape(S, 4, 3)
        return footholds, lookup_nearest(ghm, footholds[..., :2])

    return adapt


def init_scenario_state(cfg: Config, num_params: int, num_scenarios: int,
                        generator: torch.Generator, terrain_gen=None,
                        device="cuda") -> ScenarioState:
    """S scenarios standing at the spawn point, each with its own heightfield
    (``terrain_gen(generator, S)``, or flat) and its own Philox seed drawn from
    ``generator`` (offset 0)."""
    dev = resolve_device(device)
    S, rp = num_scenarios, cfg.robot
    feet = torch.tensor([[rp.hip_x, rp.hip_y + 0.1, 0.0], [rp.hip_x, -rp.hip_y - 0.1, 0.0],
                         [-rp.hip_x, rp.hip_y + 0.1, 0.0], [-rp.hip_x, -rp.hip_y - 0.1, 0.0]],
                        dtype=torch.float32, device=dev).expand(S, 4, 3)
    x = torch.zeros(S, 12, device=dev)
    x[:, 2] = cfg.sim.ref_z
    terrain = (terrain_gen(generator, S) if terrain_gen is not None
               else torch.zeros(S, 1, 1, device=dev))
    seeds = torch.randint(0, 2 ** 62, (S,), generator=generator, dtype=torch.int64).to(dev)
    phase = torch.tensor(GAIT_PHASE_OFFSETS[cfg.gait_params.gait_type], dtype=torch.float32,
                         device=dev)
    return ScenarioState(
        x=x, feet=feet.clone(), phase=phase.expand(S, 4).clone(),
        swing_time=torch.zeros(S, 4, device=dev), liftoff=feet.clone(),
        prev_contact=torch.ones(S, 4, device=dev),
        mpc=FleetSamplingState(
            torch.zeros(S, num_params, device=dev),
            torch.full((S, num_params), cfg.mpc.sampling.sigma_cem_mppi, device=dev),
            seeds, torch.zeros(S, dtype=torch.int64, device=dev)),
        terrain=terrain.contiguous(),
        reflex=torch.full((S, 4), -1.0, device=dev),
        hitpoint=torch.zeros(S, 4, 3, device=dev))


METRICS = ("best_cost", "vel_error", "height_error", "grf_total", "reflex_triggers")


def make_scenario_step(cfg: Config, num_samples: int | None = None, terrain: str | None = None,
                       reflexes: bool = False, device="cuda"):
    """One control tick of S scenarios: ``step(states, cmd_vel) -> metrics``.

    ``step`` advances ``states`` (a ScenarioState) one MPC tick in place and
    returns (S, 5) metrics, columns ``METRICS``: the best cost, the velocity error,
    the height error over the stance surface, the total vertical GRF and the
    reflex firings. ``cmd_vel`` is (3,) or (S, 3) on the device. The tick runs at
    the MPC rate with ``n_sub`` Euler substeps at the simulation step. With
    ``terrain`` ("boxes", "stairs", "perlin") footholds are TAMOLS-adapted against
    each scenario's heightfield and touch-downs land on it; with ``reflexes``
    (terrain only) a swing foot whose commanded point grazes the surface (under
    5 cm) mid-swing has its swing re-planned from the hitpoint with the remaining
    time and the reflex apex, as the JAX engine does (its docstring gives the
    reference). ``step(states, cmd_vel, noise=...)`` (one (S, P, N) tensor an
    iteration) replaces the drawn noise and runs eagerly.

    On CUDA the tick is captured as one CUDA graph at the first call of each state
    (``step.graph``, a GraphedFunction); ``step.tick`` is the eager function.
    Returns ``(step, P)``."""
    dev = resolve_device(device)
    solve, P = make_fleet_sampling_solver(cfg, num_samples, device=dev)
    srbd = make_params(cfg, device=dev)
    gait = cfg.gait_params
    t_off = torch.as_tensor(make_timer_dts(cfg.mpc), device=dev)
    dt_ctrl = 1.0 / cfg.sim.mpc_frequency
    n_sub = max(1, int(round(dt_ctrl / cfg.sim.dt)))
    dt_sub = torch.tensor(dt_ctrl / n_sub, dtype=torch.float32, device=dev)
    hip_offsets = torch.as_tensor(LegKinematics(cfg.robot).hip_offsets_b, device=dev)
    adapt = make_terrain_adapter(cfg, dev) if terrain is not None else None
    use_reflex = bool(reflexes) and terrain is not None
    ref_z = cfg.sim.ref_z
    swing_period = gait.swing_period

    def tick(*tensors, noise=None):
        s = ScenarioState.from_tensors(tensors[:-1])
        cmd_vel = tensors[-1]
        S = s.x.shape[0]
        cmd = cmd_vel.expand(S, 3)
        phase = torch.remainder(s.phase + dt_ctrl * gait.step_freq, 1.0)
        seq = contact_sequence_torch(phase, gait.step_freq, gait.duty_factor, t_off)
        cur = seq[..., 0]
        prev = s.prev_contact
        swing = cur[..., None] == 0.0

        # Lift-off tracking (stance -> swing edge) and the swing clocks.
        liftoff_edge = (prev == 1.0) & (cur == 0.0)
        liftoff = torch.where(liftoff_edge[..., None], s.feet, s.liftoff)
        swing_time = torch.where(cur == 0.0, s.swing_time + dt_ctrl, 0.0)

        # Raibert reference footholds.
        R = euler_xyz_to_rot(s.x[:, 6:9])
        hips = s.x[:, None, 0:3] + hip_offsets @ R.transpose(1, 2)
        ref_feet = raibert_footholds_torch(
            s.x[:, 0:3], s.x[:, 6:9], s.x[:, 3:5], cmd[:, :2], hips, torch.zeros_like(cur),
            gait.stance_time, cfg.robot.hip_height, ref_z)

        if adapt is not None:
            # Terrain-aware adaptation every tick; swing legs take the adapted
            # target, anchored at their lift-off point (their feet are airborne).
            anchor = torch.where(swing, liftoff, s.feet)
            adapted, td_z = adapt(s.terrain, ref_feet, hips, s.x[:, 0:3], s.x[:, 3:6], s.x[:, 8],
                                  cur, s.feet, anchor)
            ref_feet = torch.where(swing, adapted, ref_feet)
        else:
            td_z = torch.zeros_like(cur)

        zeros3 = torch.zeros_like(cmd)
        base_ref = torch.stack([zeros3[:, 0], zeros3[:, 1], zeros3[:, 2] + ref_z], dim=1)
        if adapt is not None:
            # The reference height rides the stance surface.
            ground = torch.sum(s.feet[..., 2] * cur, dim=1) / torch.clamp(
                torch.sum(cur, dim=1), min=1.0)
            base_ref = torch.stack([base_ref[:, 0], base_ref[:, 1], base_ref[:, 2] + ground], 1)
        ref12 = torch.cat([base_ref, cmd, zeros3, zeros3], dim=1)

        out, mpc = solve(s.x, s.feet, ref12, ref_feet, seq, cur, prev, s.mpc, noise)

        # Physics substeps under the commanded GRFs (contacts held over the tick).
        x_next = s.x
        for _ in range(n_sub):
            x_next = integrate_euler(x_next, s.feet, out.grfs, cur, srbd, dt_sub)

        # Kinematic feet: swing follows the Bezier toward the reference foothold,
        # a touch-down lands on the surface; a tripped leg's swing restarts from
        # its hitpoint with the remaining time and the reflex apex.
        if use_reflex:
            hit_active = s.reflex >= 0.0
        else:
            hit_active = torch.zeros_like(cur, dtype=torch.bool)
        t_eff = torch.where(hit_active, swing_time - s.reflex, swing_time)
        period_eff = torch.where(hit_active, torch.clamp(swing_period - s.reflex, min=1e-3),
                                 swing_period)
        lo_eff = torch.where(hit_active[..., None], s.hitpoint, liftoff)
        step_h = torch.where(hit_active, cfg.sim.reflex_max_step_height, cfg.sim.step_height)
        pos = bezier_swing_refs_torch(t_eff, period_eff, step_h, lo_eff, ref_feet)[0]
        touchdown = ((prev == 0.0) & (cur == 1.0))[..., None]
        feet = torch.where(swing, pos, s.feet)
        landed = torch.cat([ref_feet[..., :2], td_z[..., None]], dim=-1)
        feet = torch.where(touchdown, landed, feet)

        reflex, hitpoint = s.reflex, s.hitpoint
        n_trig = torch.zeros_like(cur[:, 0])
        if use_reflex:
            surf = lookup_nearest(_terrain_map(s.terrain), pos[..., :2])
            mid_swing = (cur == 0.0) & (swing_time > 0.2 * swing_period) \
                & (swing_time < 0.8 * swing_period)
            trip = mid_swing & (pos[..., 2] < surf + 0.05) & ~hit_active
            n_trig = torch.sum(trip.to(torch.float32), dim=1)
            reflex = torch.where(trip, swing_time, reflex)
            hitpoint = torch.where(trip[..., None], pos, hitpoint)
            reflex = torch.where(touchdown[..., 0], -1.0, reflex)

        ground_now = torch.sum(feet[..., 2] * cur, dim=1) / torch.clamp(torch.sum(cur, dim=1),
                                                                          min=1.0)
        metrics = torch.stack([
            out.best_cost,
            torch.linalg.vector_norm(x_next[:, 3:5] - cmd[:, :2], dim=1),
            torch.abs(x_next[:, 2] - (ground_now + ref_z)),
            torch.sum(out.grfs[..., 2], dim=1),
            n_trig], dim=1)
        new = ScenarioState(x_next, feet, phase, swing_time, liftoff, cur, mpc, s.terrain,
                            reflex, hitpoint)
        for dst, src in zip(tensors[:-1], new.tensors()):
            if dst is not src:
                dst.copy_(src)
        return metrics

    graph = GraphedFunction(tick, dev)

    def step(states: ScenarioState, cmd_vel: torch.Tensor, noise=None):
        if noise is not None:
            return tick(*states.tensors(), cmd_vel, noise=noise)
        return graph(*states.tensors(), cmd_vel)

    step.graph, step.tick = graph, tick
    return step, P
