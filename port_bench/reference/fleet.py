"""Plain reference of one control tick of the scenario fleet, and the judge that holds
the program's tick to it.

A tick of S scenarios (the semantics of the fleet's ``make_scenario_step`` with
random sampling, one iteration, perlin terrain and reflexes): the gait clock and
contact sequence, lift-off tracking, Raibert footholds adapted by TAMOLS against
each scenario's heightfield, the sampling solve (every one of the N samples rolled
out on the noise that Philox draws from the scenario's seed and offset, the argmin
winner, its step-0 GRFs), the SRB Euler substeps under those GRFs, the Bezier swing
feet, the touch-down onto the surface and the early-stance reflex.

Everything here is plain torch on the frozen copies in ``frozen/``, float32 with
TF32 off unless ``tf32`` asks for the control: the same computation with TF32
matmuls (and their operands rounded to TF32 where the backend would keep float32),
one step of precision below the configuration's.
"""
from __future__ import annotations

import numpy as np
import torch

from .frozen.config import make_config
from .frozen.controllers.sampling.rollout import (ForceModelParams, apply_force_model_rows,
                                                  equilibrium_share, gravity_share,
                                                  rollout_costs_soa)
from .frozen.controllers.sampling.splines import (make_shift_basis, make_step_major_basis,
                                                  num_params_per_leg)
from .frozen.dynamics.srbd import integrate_euler, make_params
from .frozen.gait.foothold_reference import raibert_footholds_torch
from .frozen.gait.periodic import contact_sequence_torch, make_timer_dts
from .frozen.gait.swing import bezier_swing_refs_torch
from .frozen.kinematics.leg_ik import LegKinematics
from .frozen.planner.heightmap import GridHeightMap, lookup_nearest
from .frozen.planner.tamols import make_tamols_scorer
from .frozen.utils.frames import euler_xyz_to_rot
from .philox import random_sampling_noise
from .precision import matmul_precision, round_tf32

COST_SATURATION = 1.0e6
# The order of a scenario state's tensors, as the fleet's ScenarioState.tensors().
STATE_KEYS = ("x", "feet", "phase", "swing_time", "liftoff", "prev_contact", "best", "sigma",
              "seed", "offset", "terrain", "reflex", "hitpoint")
METRIC_NAMES = ("best_cost", "vel_error", "height_error", "grf_total", "reflex_triggers")


def _first_knots(sp, H: int) -> list:
    if sp.parametrization == "zero_order":
        return [0, H, 2 * H]
    if sp.parametrization == "linear_spline":
        return [0, sp.num_splines + 1, 2 * (sp.num_splines + 1)]
    return [1, 5, 9]


class FleetReference:
    """The fleet's tick in plain torch on ``device`` for one configuration.

    ``terrain`` is the heightfield geometry of the traffic (rows, cols, res,
    center); the heights themselves come with each state."""

    def __init__(self, make_config_args: dict, num_samples: int, terrain: dict, reflexes: bool,
                 device, tf32: bool = False, block: int = 16):
        cfg = make_config(**make_config_args)
        sp = cfg.mpc.sampling
        if sp.method != "random_sampling" or sp.num_iterations != 1:
            raise NotImplementedError("the fleet reference covers random sampling, one iteration")
        self.cfg, self.sp, self.dev = cfg, sp, torch.device(device)
        self.tf32, self.block = tf32, block
        self.N = int(num_samples)
        self.H = H = cfg.mpc.horizon
        self.PL = num_params_per_leg(sp.parametrization, H, sp.num_splines)
        self.P = 4 * self.PL
        self.W = torch.as_tensor(make_step_major_basis(sp.parametrization, H, sp.num_splines),
                                 device=self.dev)
        self.dts = cfg.mpc.dts()
        self.q_diag = cfg.mpc.cost.as_vector()
        self.srbd = make_params(cfg, device=self.dev)
        self.fm = ForceModelParams(sp.max_force_x / sp.max_force_z, sp.max_force_y / sp.max_force_z,
                                   cfg.mpc.grf_min, cfg.mpc.grf_max, cfg.mpc.mu)
        self.shift_W = torch.as_tensor(make_shift_basis(sp.parametrization, H, sp.num_splines,
                                                        1.0 / cfg.sim.mpc_frequency),
                                       device=self.dev)
        self.first_knots = _first_knots(sp, H)
        self.t_off = torch.as_tensor(make_timer_dts(cfg.mpc), device=self.dev)
        self.dt_ctrl = 1.0 / cfg.sim.mpc_frequency
        self.n_sub = max(1, int(round(self.dt_ctrl / cfg.sim.dt)))
        self.dt_sub = torch.tensor(self.dt_ctrl / self.n_sub, dtype=torch.float32,
                                   device=self.dev)
        self.hip_offsets = torch.as_tensor(LegKinematics(cfg.robot).hip_offsets_b,
                                           device=self.dev)
        self.score = make_tamols_scorer(cfg, strategy="tamols", device=self.dev).legs
        self.geom = terrain
        self.reflexes = bool(reflexes)

    # -- pieces -------------------------------------------------------------------
    def _terrain_map(self, heights):
        S = heights.shape[0]
        g = self.geom
        center = torch.tensor([float(c) for c in g["center"]], dtype=torch.float32,
                              device=self.dev)
        return GridHeightMap(center.expand(S, 2), torch.tensor(0.0, device=self.dev),
                             torch.tensor(float(g["res"]), device=self.dev), heights)

    def _adapt(self, heights, seeds, hips, base_pos, base_vel, yaw, cur, feet, own_anchor):
        tp = self.cfg.tamols
        rows, cols = tp.heightmap_rows, tp.heightmap_cols
        S = heights.shape[0]
        L = 4 * S
        ghm = self._terrain_map(heights)
        leg_hms = GridHeightMap(
            center=seeds[..., :2].reshape(L, 2),
            yaw=yaw[:, None].expand(S, 4).reshape(L),
            resolution=torch.full((L,), tp.heightmap_resolution, device=self.dev),
            heights=torch.zeros((L, rows, cols), device=self.dev))
        pts = leg_hms.cell_world_xy().reshape(S, 4, rows, cols, 2)
        leg_hms.heights = lookup_nearest(ghm, pts).reshape(L, rows, cols)

        def per_leg(v):
            return v[:, None, :].expand(S, 4, 3).reshape(L, 3)

        res = self.score(leg_hms, seeds.reshape(L, 3), hips.reshape(L, 3), per_leg(base_pos),
                         per_leg(base_vel), cur.reshape(L), feet.reshape(L, 3),
                         own_anchor.reshape(L, 3))
        footholds = res.footholds.reshape(S, 4, 3)
        return footholds, lookup_nearest(ghm, footholds[..., :2])

    def _costs(self, params, x, feet_eff, ref12, seq, share):
        """Rollout costs (S, M) of parameters (S, P, M)."""
        S, M = params.shape[0], params.shape[-1]
        W = self.W
        if self.tf32:  # TF32's operand rounding, also where cuBLAS or the CPU keeps float32
            W, params = round_tf32(W), round_tf32(params)
        raw = torch.matmul(W, params).reshape(S, self.H, 12, M)
        return rollout_costs_soa(x, feet_eff, ref12, raw, seq, share, self.dts, self.q_diag,
                                 self.srbd, self.fm, COST_SATURATION,
                                 zmp_weight=self.sp.zmp_weight, zmp_margin=self.sp.zmp_margin)

    def _solve(self, x, feet, ref12, ref_feet, seq, cur, prev, best, seeds, offsets, winner):
        """(grfs (S, 4, 3), winner (S, P), least cost (S,), winner's cost (S,))."""
        sp, S, P, PL = self.sp, x.shape[0], self.P, self.PL
        liftoff = (prev == 1.0) & (cur == 0.0)
        keep = (~liftoff)[:, :, None].expand(S, 4, PL).reshape(S, P)
        best = best * keep.to(torch.float32)
        if sp.shift_solution:
            leg_params = best.reshape(S, 4, PL).clone()
            shifted0 = leg_params @ self.shift_W
            for a in range(3):
                leg_params[:, :, self.first_knots[a]] = shifted0[..., a]
            best = leg_params.reshape(S, P)
        feet_eff = torch.where(cur[..., None] == 0.0, ref_feet, feet)
        if sp.equilibrium_share:
            share = equilibrium_share(feet_eff, x[:, :3], seq, float(np.float32(self.cfg.robot.mass)),
                                      9.81, self.cfg.mpc.grf_max)
        else:
            share = gravity_share(seq, float(np.float32(self.cfg.robot.mass)))[..., None] \
                .expand(S, self.H, 4)
        c_min = torch.empty(S, device=self.dev)
        own = torch.empty(S, P, device=self.dev)
        for s0 in range(0, S, self.block):
            sl = slice(s0, min(S, s0 + self.block))
            noise = random_sampling_noise(seeds[sl], offsets[sl], PL, self.N, sp.sigma_random)
            params = best[sl, :, None] + noise
            costs = self._costs(params, x[sl], feet_eff[sl], ref12[sl], seq[sl], share[sl])
            c_min[sl], idx = torch.min(costs, dim=1)
            own[sl] = params.gather(2, idx[:, None, None].expand(-1, P, 1))[..., 0]
            del noise, params, costs
        w = own if winner is None else winner
        c_w = self._costs(w[:, :, None], x, feet_eff, ref12, seq, share)[:, 0]
        W0, wT = self.W[0:12], w.T
        if self.tf32:
            W0, wT = round_tf32(W0), round_tf32(wT)
        raw0 = W0 @ wT  # (12, S)
        rows = apply_force_model_rows(raw0, seq[:, :, 0].T, share[:, 0, :].T, self.fm)
        grfs = torch.stack(rows, dim=-1).reshape(-1, 4, 3)
        return grfs, w, c_min, c_w

    # -- the tick ------------------------------------------------------------------
    def tick(self, pre: dict, cmd_vel: torch.Tensor, winner: torch.Tensor | None = None):
        """One tick from the state ``pre`` (STATE_KEYS -> tensors of S scenarios).
        The winner is the argmin of the reference's own costs, or ``winner`` (S, P)
        where one is given to be judged. Returns (state after, metrics (S, 5),
        least cost (S,), the winner's cost (S,))."""
        with matmul_precision(self.tf32):
            return self._tick(pre, cmd_vel, winner)

    def _tick(self, pre, cmd_vel, winner):
        cfg, gait = self.cfg, self.cfg.gait_params
        x, s_feet = pre["x"], pre["feet"]
        S = x.shape[0]
        cmd = cmd_vel.expand(S, 3)
        dt_ctrl = self.dt_ctrl
        phase = torch.remainder(pre["phase"] + dt_ctrl * gait.step_freq, 1.0)
        seq = contact_sequence_torch(phase, gait.step_freq, gait.duty_factor, self.t_off)
        cur = seq[..., 0]
        prev = pre["prev_contact"]
        swing = cur[..., None] == 0.0
        liftoff_edge = (prev == 1.0) & (cur == 0.0)
        liftoff = torch.where(liftoff_edge[..., None], s_feet, pre["liftoff"])
        swing_time = torch.where(cur == 0.0, pre["swing_time"] + dt_ctrl, 0.0)
        R = euler_xyz_to_rot(x[:, 6:9])
        hips = x[:, None, 0:3] + self.hip_offsets @ R.transpose(1, 2)
        ref_z = cfg.sim.ref_z
        ref_feet = raibert_footholds_torch(x[:, 0:3], x[:, 6:9], x[:, 3:5], cmd[:, :2], hips,
                                           torch.zeros_like(cur), gait.stance_time,
                                           cfg.robot.hip_height, ref_z)
        anchor = torch.where(swing, liftoff, s_feet)
        adapted, td_z = self._adapt(pre["terrain"], ref_feet, hips, x[:, 0:3], x[:, 3:6], x[:, 8],
                                    cur, s_feet, anchor)
        ref_feet = torch.where(swing, adapted, ref_feet)
        zeros3 = torch.zeros_like(cmd)
        base_ref = torch.stack([zeros3[:, 0], zeros3[:, 1], zeros3[:, 2] + ref_z], dim=1)
        ground = torch.sum(s_feet[..., 2] * cur, dim=1) / torch.clamp(torch.sum(cur, dim=1), min=1.0)
        base_ref = torch.stack([base_ref[:, 0], base_ref[:, 1], base_ref[:, 2] + ground], 1)
        ref12 = torch.cat([base_ref, cmd, zeros3, zeros3], dim=1)

        grfs, best, c_min, c_w = self._solve(x, s_feet, ref12, ref_feet, seq, cur, prev,
                                             pre["best"], pre["seed"], pre["offset"], winner)
        x_next = x
        for _ in range(self.n_sub):
            x_next = integrate_euler(x_next, s_feet, grfs, cur, self.srbd, self.dt_sub)

        reflex, hitpoint = pre["reflex"], pre["hitpoint"]
        swing_period = gait.swing_period
        hit_active = reflex >= 0.0 if self.reflexes else torch.zeros_like(cur, dtype=torch.bool)
        t_eff = torch.where(hit_active, swing_time - reflex, swing_time)
        period_eff = torch.where(hit_active, torch.clamp(swing_period - reflex, min=1e-3),
                                 swing_period)
        lo_eff = torch.where(hit_active[..., None], hitpoint, liftoff)
        step_h = torch.where(hit_active, cfg.sim.reflex_max_step_height, cfg.sim.step_height)
        pos = bezier_swing_refs_torch(t_eff, period_eff, step_h, lo_eff, ref_feet)[0]
        touchdown = ((prev == 0.0) & (cur == 1.0))[..., None]
        feet = torch.where(swing, pos, s_feet)
        landed = torch.cat([ref_feet[..., :2], td_z[..., None]], dim=-1)
        feet = torch.where(touchdown, landed, feet)
        n_trig = torch.zeros_like(cur[:, 0])
        if self.reflexes:
            surf = lookup_nearest(self._terrain_map(pre["terrain"]), pos[..., :2])
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
            c_w,
            torch.linalg.vector_norm(x_next[:, 3:5] - cmd[:, :2], dim=1),
            torch.abs(x_next[:, 2] - (ground_now + ref_z)),
            torch.sum(grfs[..., 2], dim=1),
            n_trig], dim=1)
        post = dict(x=x_next, feet=feet, phase=phase, swing_time=swing_time, liftoff=liftoff,
                    prev_contact=cur, best=best, sigma=pre["sigma"], seed=pre["seed"],
                    offset=pre["offset"] + 1, terrain=pre["terrain"], reflex=reflex,
                    hitpoint=hitpoint)
        return post, metrics, c_min, c_w


# The state tensors compared by value (each a float tensor of the scenario state);
# seed, offset, sigma and terrain must come out exactly as the tick leaves them.
COMPARED = ("x", "feet", "phase", "swing_time", "liftoff", "prev_contact", "reflex", "hitpoint")
EXACT = ("seed", "offset", "sigma", "terrain")


def _worst(x: torch.Tensor) -> float:
    """The largest entry, with NaN read as infinity."""
    x = torch.nan_to_num(x.double(), nan=float("inf"))
    return float(x.max()) if x.numel() else 0.0


def judge_tick(ref: FleetReference, pre: dict, post: dict, metrics: torch.Tensor,
               cmd_vel: torch.Tensor) -> dict:
    """The numbers by which one tick of the program, from ``pre`` to ``post`` with
    its metrics (S, 5), is held to the reference:

    * ``cost_gaps`` (S,): per scenario the larger of the program's best cost against
      the reference's cost of the program's winner, and that cost above the
      reference's least cost over all N samples, over max(least cost, 1);
    * ``grf_gap_N``: the program's total vertical GRF against the reference's from
      the same winner, N, the worst scenario;
    * ``state_gap``: the largest difference of the state after the tick (base state,
      feet, gait clock, lift-off points, contacts, reflex times and hitpoints) and
      of the velocity error, height error and reflex firings; infinite where the
      seed, offset, sigma or heightfield differ from what the tick leaves.
    """
    r_post, r_m, c_min, c_w = ref.tick(pre, cmd_vel, winner=post["best"])
    m = metrics.to(torch.float32)
    cost = torch.maximum(torch.abs(m[:, 0] - c_w), c_w - c_min) / torch.clamp(c_min, min=1.0)
    grf = torch.abs(m[:, 3] - r_m[:, 3])
    state = [torch.abs(post[k].to(torch.float32) - r_post[k].to(torch.float32)).flatten()
             for k in COMPARED]
    state.append(torch.abs(m[:, [1, 2, 4]] - r_m[:, [1, 2, 4]]).flatten())
    state_gap = _worst(torch.cat(state))
    if any(not torch.equal(post[k], r_post[k]) for k in EXACT):
        state_gap = float("inf")
    return {"cost_gaps": torch.nan_to_num(cost.double(), nan=float("inf")).cpu().numpy(),
            "grf_gap_N": _worst(grf), "state_gap": state_gap}
