"""Device time per fleet tick of every kernel but K1f's (gait, terrain adapter,
substeps, swing, reflex and the solve's torch operations)."""
from port_bench.metrics._kernels import is_k1f, kernels

NAME = "fleet.other_us_per_tick"
UNIT = "us"
LAYER = "fleet tick (parallel/scenario_engine.py)"
MOVES = "fleet_steps_per_s"
SOURCE = "device_trace"


def read(rec, run):
    other = [d for n, d in kernels(rec) if not is_k1f(n)]
    return sum(other) / rec.units if other else None
