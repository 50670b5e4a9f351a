#!/usr/bin/env python3
"""How often torch.profiler loses kernel records in a profiling window on one card,
with and without idle time around the profiled work.

    python3 tools/profiler_windows.py [WINDOWS]

For the MPPI row (K1b) with linear splines and with cubic splines at N = 10 000
on the flagship tick, profiles WINDOWS (default 20) windows of 50 iterations
through the C entry for each variant: the active step after one warm-up step
(``warm1``, as chip_smoke.py profiled before its pads), the same with 50 ms idle
before and after the work inside the active step (``warm1_pad50ms``, as
chip_smoke.py's ``profile_window`` does), and with two warm-up steps and the
pads (``warm2_pad50ms``). The variants take turns, each window after some
unrelated torch work and a CUDA-event timing of the iteration, as in
chip_smoke.py's phases. Prints, for each variant, how many windows recorded all
50 rollout-pass launches, some, or none, and the counts.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = (("warm1", 0.0, 1), ("warm1_pad50ms", 0.05, 1), ("warm2_pad50ms", 0.05, 2))


def window(calls, pad, warm) -> int:
    """Rollout-pass launches that one profiling window recorded."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warm, active=1, repeat=1)) as prof:
        for _ in range(warm):
            calls()
            prof.step()
        time.sleep(pad)
        calls()
        time.sleep(pad)
        prof.step()
    return sum(e.count for e in prof.key_averages()
               if "rollout_kernel" in e.key and getattr(e, "device_time_total", 0) > 0)


def main() -> int:
    import torch

    import chip_smoke as cs
    from quadruped_pympc_tamols_torch.ops import build
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    windows = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    build.build_all()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for par in ("linear_spline", "cubic_spline"):
        cfg = cs.softmax_cfg("mppi", par)
        plan = sk.make_rs_plan(cfg, cs.N_MAIN, dev)
        lib = sm.load_library(plan.horizon, plan.params_per_leg)
        knobs = sm.make_knobs(cfg)
        P = plan.num_parameters
        inc, sig = torch.zeros(P, device=dev), torch.ones(P, device=dev)
        args = sk.kernel_args(plan, cs.example_tick(cfg, plan), 5, 0)
        ws, kn = sm.workspace(plan, knobs, dev), knobs.struct()

        def one():
            sm.launch(lib, args, kn, plan, ws, inc, sig, stream=stream)

        def calls():
            for _ in range(50):
                one()
            torch.cuda.synchronize()

        counts = {name: [] for name, _, _ in VARIANTS}
        for _ in range(windows):
            for name, pad, warm in VARIANTS:
                for _ in range(200):
                    torch.randn(P, 1000, device=dev).exp_().sum()
                cs.time_cuda(one)
                counts[name].append(window(calls, pad, warm))
        for name, v in counts.items():
            print(par, name, "windows", len(v), "empty", sum(x == 0 for x in v),
                  "short", sum(0 < x < 50 for x in v), "full", sum(x == 50 for x in v), v,
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
