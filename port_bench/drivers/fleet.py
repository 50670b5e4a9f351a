"""Driver ``fleet``: the on-device scenario fleet as a data generator runs it.

The system under test is the port's ``parallel.make_scenario_step`` (one CUDA graph
a tick on the card), S scenarios at the configuration's N samples, with the traffic's
terrain and reflexes, commanded at the traffic's velocity. Every ``episode_ticks``
ticks all scenarios are drawn again (``generate.FleetEpisodes``) and copied into the
same state tensors, so the graph captured at set-up serves the whole run; each
episode's (ticks, S, 5) metrics reach the host in one copy. Ticks are dispatched
back to back with at most ``queue_depth`` in flight. The window ends with a
synchronize and counts the ticks it dispatched, all completed by then.

Once an episode, at a tick drawn from the seed, a tick is offered to the check; a
reservoir drawn from the seed keeps ``check_ticks`` of those offered (the state
before and after the tick and its metrics), a uniform sample of them. After the
window the reference (``reference/fleet.py``) judges the kept ticks.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..generate import FleetEpisodes
from ..reference.fleet import STATE_KEYS, FleetReference, judge_tick
from ..reference.frozen.controllers.sampling.splines import num_params_per_leg
from ..reference.philox import random_sampling_noise

TRACE_SCOPE = "window"  # ticks run back to back: the traced window is one range


class PortFleet:
    """The port's scenario fleet: ``tick(cmd) -> (S, 5) metrics``, its state tensors
    in ``STATE_KEYS`` order (``tensors()``), ``load(episode)`` in place, and the
    graph's ``captures``."""

    def __init__(self, make_config_args: dict, traffic: dict, device, noise_fn=None):
        from quadruped_pympc_tamols_torch import make_config
        from quadruped_pympc_tamols_torch.config import GAIT_PHASE_OFFSETS
        from quadruped_pympc_tamols_torch.parallel import init_scenario_state, make_scenario_step

        cfg = make_config(**make_config_args)
        dev = torch.device(device)
        S = int(traffic["scenarios"])
        geom = traffic["terrain"]
        self.step, self.P = make_scenario_step(cfg, terrain=geom["kind"],
                                               reflexes=bool(traffic["reflexes"]), device=dev)
        st = init_scenario_state(cfg, self.P, S, torch.Generator().manual_seed(0), None, dev)
        st.terrain = torch.zeros((S, int(geom["rows"]), int(geom["cols"])), device=dev)
        self.state = st
        self.sigma0 = float(cfg.mpc.sampling.sigma_cem_mppi)
        self.phase0 = torch.tensor(GAIT_PHASE_OFFSETS[cfg.gait_params.gait_type],
                                   dtype=torch.float32, device=dev)
        # On the CPU the plain tick draws its noise from a torch.Generator; a CPU
        # rehearsal hands it the Philox noise the card's kernel would draw instead.
        self.noise_fn = noise_fn

    def tensors(self) -> tuple:
        return self.state.tensors()

    def load(self, ep: dict) -> None:
        st = self.state
        st.terrain.copy_(ep["terrain"])
        st.x.copy_(ep["x"])
        st.feet.copy_(ep["feet"])
        st.liftoff.copy_(ep["feet"])
        st.phase.copy_(self.phase0.expand_as(st.phase))
        st.swing_time.zero_()
        st.prev_contact.fill_(1.0)
        st.mpc.best_parameters.zero_()
        st.mpc.sigma.fill_(self.sigma0)
        st.mpc.seed.copy_(ep["seed"])
        st.mpc.offset.zero_()
        st.reflex.fill_(-1.0)
        st.hitpoint.zero_()

    def tick(self, cmd: torch.Tensor) -> torch.Tensor:
        if self.noise_fn is not None:
            return self.step(self.state, cmd, noise=self.noise_fn(self.state)[None])
        return self.step(self.state, cmd)

    @property
    def captures(self) -> int:
        return self.step.graph.captures


def make_system(ctx):
    noise_fn = None
    if ctx.device.type == "cpu":
        sp = ctx.cfg.mpc.sampling
        pl = num_params_per_leg(sp.parametrization, ctx.cfg.mpc.horizon, sp.num_splines)

        def noise_fn(st):
            return random_sampling_noise(st.mpc.seed, st.mpc.offset, pl, sp.num_samples,
                                         sp.sigma_random)
    return PortFleet(ctx.config["make_config"], ctx.traffic, ctx.device, noise_fn)


def _snapshot(system) -> dict:
    return {k: t.clone() for k, t in zip(STATE_KEYS, system.tensors())}


def run(ctx) -> dict:
    tr, dev = ctx.traffic, ctx.device
    S, T = int(tr["scenarios"]), int(tr["episode_ticks"])
    depth = int(tr["queue_depth"])
    system = (ctx.make_system or make_system)(ctx)
    episodes = FleetEpisodes(ctx.config["make_config"], tr, ctx.seed, dev)
    cmd = torch.tensor([float(v) for v in tr["command"]], dtype=torch.float32, device=dev)
    rng = np.random.default_rng(ctx.seed)
    buf = torch.empty((T, S, 5), device=dev)
    pinned = dev.type == "cuda"
    hosts = [torch.empty((T, S, 5), pin_memory=pinned) for _ in range(2)]

    # Set-up: the first tick captures the graph (after its warm-up runs); a
    # re-draw and the episode's copies run once; then the first episode is loaded.
    system.load(episodes.draw())
    for _ in range(int(tr["warmup_ticks"])):
        buf[0].copy_(system.tick(cmd))
    hosts[0][:1].copy_(buf[:1], non_blocking=pinned)
    system.load(episodes.draw())
    ctx.sync()
    captures = system.captures
    ctx.mark_setup_done()

    failed = 0
    pending = [None, None]  # (event, ticks) of the copy in flight into hosts[b]

    def count_failed(b):
        nonlocal failed
        ev, n = pending[b]
        if ev is not None:
            ev.synchronize()
        rows = hosts[b][:n].numpy()
        failed += int(np.count_nonzero(~np.isfinite(rows).all(axis=2)))
        pending[b] = None

    def flush(n, b):
        if pending[b] is not None:
            count_failed(b)
        hosts[b][:n].copy_(buf[:n], non_blocking=pinned)
        ev = torch.cuda.Event() if pinned else None
        if ev is not None:
            ev.record()
        pending[b] = (ev, n)

    K = int(tr["check_ticks"])
    checks_at = int(rng.integers(0, T))
    snaps, offered, slot = [], 0, None
    inflight = []
    marks = []  # host time at each episode's end
    launch = [0.0]  # host seconds spent dispatching each episode's ticks
    ticks = k = episode = 0
    gc.collect()
    gc.disable()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while True:
        if k == T:
            marks.append(time.perf_counter())
            launch.append(0.0)
            flush(T, episode % 2)
            system.load(episodes.draw())
            episode += 1
            k = 0
            checks_at = int(rng.integers(0, T))
        snap = k == checks_at
        if snap:  # reservoir sampling: offer j is kept with probability K / (j + 1)
            slot = len(snaps) if offered < K else int(rng.integers(0, offered + 1))
            offered += 1
            snap = slot < K
        if snap:
            pre = _snapshot(system)
        h0 = time.perf_counter()
        m = system.tick(cmd)
        buf[k].copy_(m)
        launch[-1] += time.perf_counter() - h0
        if snap:
            kept = (pre, _snapshot(system), m.clone())
            if slot < len(snaps):
                snaps[slot] = kept
            else:
                snaps.append(kept)
        if pinned:
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            if len(inflight) > depth:
                inflight.pop(0).synchronize()
        ticks += 1
        k += 1
        if time.perf_counter() >= deadline:
            break
    ctx.sync()
    window = time.perf_counter() - t0
    gc.enable()
    flush(k, episode % 2)
    for b in (0, 1):
        if pending[b] is not None:
            count_failed(b)
    grew = system.captures - captures

    records = None
    if ctx.trace:
        n = int(tr["trace_ticks"])

        def traced():
            for _ in range(n):
                with ctx.tracer.unit():
                    buf[0].copy_(system.tick(cmd))

        records = ctx.tracer.run(traced, units=n)
    ctx.read_memory_peak()
    del system, buf
    ctx.free()

    ctx.log(f"fleet: {ticks} ticks of {S} scenarios in {window:.6f} s, {episode} re-draws, "
            f"{len(snaps)} of {offered} ticks offered kept for the check; graph captures in the window: {grew}; "
            f"ms a tick by episode: "
            f"{[round((b - a) * 1e3 / T, 4) for a, b in zip([t0] + marks, marks)]}; "
            f"host ms dispatching a tick by episode: {[round(h * 1e3 / T, 4) for h in launch[:-1]]}")
    if grew:
        raise RuntimeError(f"the fleet captured {grew} new graph(s) inside the window")
    N = ctx.cfg.mpc.sampling.num_samples
    ref = FleetReference(ctx.config["make_config"], N, tr["terrain"], bool(tr["reflexes"]), dev)
    costs, grf_gap, state_gap = [], 0.0, 0.0
    for pre, post, m in snaps:
        got = judge_tick(ref, pre, post, m, cmd)
        costs.append(got["cost_gaps"])
        grf_gap = max(grf_gap, got["grf_gap_N"])
        state_gap = max(state_gap, got["state_gap"])
    costs = np.concatenate(costs)
    checks = {"cost_gap": float(costs.max()), "cost_gap_med": float(np.median(costs)),
              "grf_gap_N": grf_gap, "state_gap": state_gap}
    return {"attempted": ticks * S, "failed": failed,
            "metrics": {"fleet_steps_per_s": ticks * S / window},
            "checks": checks, "records": records, "units": ticks,
            "counts": {"scenarios": S, "num_samples": N}}
