"""Kernel launches the card ran per fleet tick in the traced window, from the
profiler's kernel records."""
from port_bench.metrics._kernels import kernels

NAME = "fleet.kernels_per_tick"
UNIT = "launches"
LAYER = "fleet tick (parallel/scenario_engine.py)"
MOVES = "fleet_steps_per_s"
SOURCE = "device_trace"


def read(rec, run):
    k = kernels(rec)
    return len(k) / rec.units if k else None
