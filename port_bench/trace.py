"""The traced part of a ``--trace 1`` run: torch.profiler over a bounded number of
ticks or calls, and the reduction of its records to what the per-layer metrics read.

``Tracer.run(fn, units)`` profiles one warm-up call of ``fn`` (not recorded), then
profiles ``fn`` inside the range ``WINDOW`` with a synchronize at both ends, so every
device record of the window starts inside that range and no other does. ``fn``
marks each tick or call with ``tracer.unit()``. The result (``Records``) holds
the device records (kernels, copies, memsets) that start inside the window, the
traced window's length and its busy time, both over the whole window (``scope``
"window", for work dispatched back to back) or over the union of the unit ranges
(``scope`` "units", for calls each ending in a synchronize), and the idle gaps there,
each named after the innermost host operation running at its middle (gaps under
``SHORT_GAP_US`` are the launch gaps between device operations).
"""
from __future__ import annotations

import contextlib
import dataclasses

WINDOW = "port_bench.window"
UNIT = "port_bench.unit"  # the range of one tick or call
SHORT_GAP_US = 5.0  # an idle gap shorter than this lies between two device operations


@dataclasses.dataclass
class Records:
    units: int  # ticks or calls in the window
    window_us: float  # length of the traced window (whole window or the units' union)
    busy_us: float  # time in it with a device record running
    device: list  # (name, start_us, duration_us) of every device record in the window
    gaps: list  # (host operation, idle us) of every idle gap in the window


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals, scope):
    """The parts of ``intervals`` inside the (sorted, disjoint) ``scope``."""
    out = []
    for s, e in intervals:
        for a, b in scope:
            lo, hi = max(s, a), min(e, b)
            if hi > lo:
                out.append((lo, hi))
    return out


class Tracer:
    def __init__(self, sync, scope: str):
        self.sync = sync
        self.scope = scope

    @contextlib.contextmanager
    def unit(self):
        from torch.profiler import record_function
        with record_function(UNIT):
            yield

    def run(self, fn, units: int) -> Records:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function, schedule

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            self.sync()
            prof.step()
            with record_function(WINDOW):
                self.sync()
                fn()
                self.sync()
            prof.step()
        events = prof.events()
        span = next(e.time_range for e in events if e.name == WINDOW)
        if self.scope == "units":
            scope = _union([(e.time_range.start, e.time_range.end) for e in events
                            if e.name == UNIT and e.device_type == DeviceType.CPU])
        else:
            scope = [(span.start, span.end)]
        device, host = [], []
        for e in events:
            tr = e.time_range
            if e.device_type == DeviceType.CPU:
                if e.name not in (WINDOW, UNIT) and not e.name.startswith("ProfilerStep"):
                    host.append((tr.start, tr.end, e.name))
            elif e.name not in (WINDOW, UNIT) and span.start <= tr.start <= span.end:
                # (the ranges themselves come back as device-side annotations too)
                device.append((e.name, tr.start, tr.elapsed_us()))
        busy = _union(_clip([(s, s + d) for _, s, d in device], scope))
        window_us = sum(b - a for a, b in scope)
        busy_us = sum(b - a for a, b in busy)
        idle = []
        for a, b in scope:
            cur = a
            for s, e in busy:
                if e <= a or s >= b:
                    continue
                if s > cur:
                    idle.append((cur, s))
                cur = max(cur, e)
            if b > cur:
                idle.append((cur, b))
        gaps = []
        for a, b in idle:
            if b - a < SHORT_GAP_US:
                gaps.append(("between device operations", b - a))
                continue
            mid = 0.5 * (a + b)
            inside = [(e - s, name) for s, e, name in host if s <= mid <= e]
            gaps.append((min(inside)[1] if inside else "no host operation", b - a))
        return Records(units=units, window_us=window_us, busy_us=busy_us, device=device,
                       gaps=gaps)


def breakdown(rec: Records, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what the host
    was doing, each in seconds, at most ``top`` of each."""
    ops, idle = {}, {}
    for name, _, d in rec.device:
        ops[name] = ops.get(name, 0.0) + d * 1e-6
    for name, d in rec.gaps:
        idle[name] = idle.get(name, 0.0) + d * 1e-6
    return {"device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}
