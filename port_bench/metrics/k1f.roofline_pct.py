"""K1f's share of its roofline: the least time of one random-sampling iteration for
the cell's S x N on an H100 (``roofline/k1f.py``, published peaks) over K1f's
device time per tick."""
from port_bench.metrics._kernels import is_k1f, kernels
from port_bench.roofline.k1f import least_time

NAME = "k1f.roofline_pct"
UNIT = "%"
LAYER = "kernel K1f (ops/sampling_fleet.py, ops/csrc/sampling_fleet.cu)"
MOVES = "fleet_steps_per_s"
SOURCE = "device_trace"


def read(rec, run):
    us = sum(d for n, d in kernels(rec) if is_k1f(n))
    if us <= 0:
        return None
    least_s, _ = least_time(run["cfg"], run["counts"]["scenarios"], run["counts"]["num_samples"])
    return 100.0 * least_s / (us * 1e-6 / rec.units)
