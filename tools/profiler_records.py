#!/usr/bin/env python3
"""Where a profiling window's device records lie against the profiled call, for
the nominal gradient MPC's solve tick on one card.

    python3 tools/profiler_records.py [WINDOWS]

Profiles WINDOWS (default 10) windows of 20 graph-replayed ticks and
WINDOWS // 2 windows of 5 eager ticks on the trot golden scenario (the ticks of
chip_smoke.py's phase 19 (d), each window a ``profile_window``), and prints one
JSON line a window: the device-to-host copies and kernels that start inside the
profiled call's host range, the device records that start before it and after
it, and the start of each copy outside it (us from the call's start). Then one
line with the kernel names whose records a tick differ between the last graph
window and the last eager window.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def records(prof, n):
    """(summary dict, per-name kernel records a tick inside the call)."""
    from torch.autograd import DeviceType

    import chip_smoke as cs

    events = prof.events()
    span = next(e.time_range for e in events if e.name == cs.PROFILED_CALL)
    inside, before, after = [], [], []
    for e in events:
        if e.device_type == DeviceType.CPU:
            continue
        start = e.time_range.start
        (before if start < span.start else after if start > span.end else inside).append(e)

    def is_kernel(e):
        return "Memcpy" not in e.name and "Memset" not in e.name

    per = {}
    for e in inside:
        if is_kernel(e):
            per[e.name] = per.get(e.name, 0) + 1 / n
    return {"dtoh_inside": sum("DtoH" in e.name for e in inside),
            "kernels_inside": sum(map(is_kernel, inside)),
            "before": len(before), "after": len(after),
            "dtoh_outside_start_us": [round(e.time_range.start - span.start, 1)
                                      for e in before + after if "DtoH" in e.name],
            "call_us": round(span.end - span.start, 1)}, per


def main() -> int:
    import torch

    import chip_smoke as cs
    from quadruped_pympc_tamols_torch.controllers.gradient import GradientMPC

    windows = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    cfg = cs.grad_cfg()
    paths = (("graph", GradientMPC(cfg, device="cuda"), 20, windows),
             ("eager", cs.eager(GradientMPC(cfg, device="cuda")), 5, max(1, windows // 2)))
    last = {}
    for name, mpc, n, count in paths:
        tick = cs.grad_tick(mpc, "trot_nominal")
        for _ in range(3):
            tick()
        torch.cuda.synchronize()

        def ticks():
            for _ in range(n):
                tick()
            torch.cuda.synchronize()

        for w in range(count):
            prof, _ = cs.profile_window(ticks)
            summary, last[name] = records(prof, n)
            print(json.dumps({"path": name, "window": w, "ticks": n, **summary}), flush=True)
    names = set(last["graph"]) | set(last["eager"])
    diff = {k: (round(last["graph"].get(k, 0), 2), round(last["eager"].get(k, 0), 2))
            for k in sorted(names)
            if abs(last["graph"].get(k, 0) - last["eager"].get(k, 0)) > 1e-9}
    print(json.dumps({"kernels_a_tick_graph_vs_eager": diff}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
