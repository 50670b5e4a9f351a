"""The share of a gradient-MPC call with no kernel or copy running on the card
(``_kernels.idle_pct``)."""
from port_bench.metrics._kernels import idle_pct

NAME = "device.idle_pct.solve"
UNIT = "%"
LAYER = "device (H100)"
MOVES = "solve_ms_p50"
SOURCE = "device_trace"


def read(rec, run):
    return idle_pct(rec)
