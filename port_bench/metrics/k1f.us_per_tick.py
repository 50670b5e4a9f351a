"""Device time per fleet tick of kernel K1f's passes (the ``fleet_*`` kernels)."""
from port_bench.metrics._kernels import is_k1f, kernels

NAME = "k1f.us_per_tick"
UNIT = "us"
LAYER = "kernel K1f (ops/sampling_fleet.py, ops/csrc/sampling_fleet.cu)"
MOVES = "fleet_steps_per_s"
SOURCE = "device_trace"


def read(rec, run):
    k1f = [d for n, d in kernels(rec) if is_k1f(n)]
    return sum(k1f) / rec.units if k1f else None
