"""Driver ``solve_stream``: one robot's gradient MPC called at its control rate.

The system under test is the port's ``GradientMPC.compute_control`` (one CUDA graph
a call on the card, its one copy each way). Calls are due every 1 / ``rate_hz``
seconds from the window's start, each on the next state of ``generate.trot_stream``;
a call starts at its due time, or when the previous one returns if that is later,
and ends when its GRFs reach the host. Its latency is from its due time to its
return, so a call that overruns delays the next ones and the wait counts. The
window holds the calls due within ``--seconds``.

Every call's GRFs and status are kept with the controller's warm start before and
after it; after the window the reference (``reference/gradient.py``) judges the
first call, which starts from no warm start, and a sample of the others drawn from
the seed, each from the warm start the program held at that call.
"""
from __future__ import annotations

import gc
import itertools
import statistics
import time

import numpy as np

from ..generate import trot_stream
from ..reference.gradient import GradientReference, judge_calls

TRACE_SCOPE = "units"  # each call ends in a synchronize: the traced window is the calls
SPIN_S = 1e-3  # the last stretch before a call's due time is waited by spinning


class PortGradient:
    """The port's nominal gradient MPC: ``call(state, reference, seq) -> (grfs,
    status)``, its warm start ``U_warm`` (host numpy), and its graph's captures."""

    def __init__(self, make_config_args: dict, device):
        from quadruped_pympc_tamols_torch import make_config
        from quadruped_pympc_tamols_torch.controllers.gradient import GradientMPC
        self.mpc = GradientMPC(make_config(**make_config_args), device=device)

    def call(self, state, reference, seq):
        grfs, _, _, status, _ = self.mpc.compute_control(state, reference, seq)
        return grfs, status

    @property
    def U_warm(self) -> np.ndarray:
        return self.mpc.U_warm

    def reset(self) -> None:
        self.mpc.reset()

    @property
    def captures(self) -> int:
        return self.mpc._solve_dev.captures


def make_system(ctx):
    return PortGradient(ctx.config["make_config"], ctx.device)


def _wait_until(t: float) -> None:
    rest = t - time.perf_counter()
    if rest > SPIN_S:
        time.sleep(rest - SPIN_S)
    while time.perf_counter() < t:
        pass


def run(ctx) -> dict:
    tr = ctx.traffic
    period = 1.0 / float(tr["rate_hz"])
    n_calls = int(round(ctx.seconds * float(tr["rate_hz"])))
    system = (ctx.make_system or make_system)(ctx)
    stream = trot_stream(ctx.config["make_config"], tr, ctx.seed)
    # The warm-up calls (the first captures the graph) take states of their own.
    for state, ref, seq in itertools.islice(stream, int(tr["warmup_calls"])):
        system.call(state, ref, seq)
    system.reset()
    calls = list(itertools.islice(stream, n_calls))
    captures = system.captures
    ctx.mark_setup_done()

    lat, records = [], []
    failed = 0
    gc.collect()
    gc.disable()
    t0 = time.perf_counter()
    for i, (state, ref, seq) in enumerate(calls):
        due = t0 + i * period
        _wait_until(due)
        before = system.U_warm.copy()
        grfs, status = system.call(state, ref, seq)
        lat.append((time.perf_counter() - due) * 1e3)
        records.append(dict(state=state, reference=ref, seq=seq, U_warm=before,
                            U_warm_next=system.U_warm.copy(), grfs=np.array(grfs),
                            status=int(status)))
        if status != 0 or not np.all(np.isfinite(grfs)):
            failed += 1
    window = time.perf_counter() - t0
    gc.enable()
    grew = system.captures - captures

    trace_records = None
    if ctx.trace:
        n = int(tr["trace_calls"])
        more = list(itertools.islice(stream, n))

        def traced():
            start = time.perf_counter()
            for i, (state, ref, seq) in enumerate(more):
                _wait_until(start + i * period)
                with ctx.tracer.unit():
                    system.call(state, ref, seq)

        trace_records = ctx.tracer.run(traced, units=n)
    ctx.read_memory_peak()
    del system
    ctx.free()

    q = statistics.quantiles(lat, n=20)
    ctx.log(f"solve_stream: {len(lat)} calls at {tr['rate_hz']} Hz in {window:.6f} s, "
            f"p50 {statistics.median(lat):.4f} ms, p95 {q[18]:.4f} ms, max {max(lat):.4f} ms, "
            f"{failed} failed; graph captures in the window: {grew}; p50 ms by 500 calls: "
            f"{[round(statistics.median(lat[i:i + 500]), 4) for i in range(0, len(lat), 500)]}")
    if grew:
        raise RuntimeError(f"the controller captured {grew} new graph(s) inside the window")
    rng = np.random.default_rng(ctx.seed)
    k = min(len(records) - 1, int(tr["check_calls"]) - 1)
    picked = [0] + sorted(int(j) + 1 for j in rng.choice(len(records) - 1, size=k, replace=False))
    ref = GradientReference(ctx.config["make_config"], ctx.config["mehrotra_iterations"])
    checks = judge_calls(ref, [records[j] for j in picked])
    return {"attempted": len(lat), "failed": failed,
            "metrics": {"solve_ms_p50": statistics.median(lat), "solve_ms_p95": q[18]},
            "checks": checks, "records": trace_records, "units": len(lat), "counts": {}}
