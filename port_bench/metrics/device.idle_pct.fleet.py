"""The share of a fleet tick with no kernel or copy running on the card
(``_kernels.idle_pct``)."""
from port_bench.metrics._kernels import idle_pct

NAME = "device.idle_pct.fleet"
UNIT = "%"
LAYER = "device (H100)"
MOVES = "fleet_steps_per_s"
SOURCE = "device_trace"


def read(rec, run):
    return idle_pct(rec)
