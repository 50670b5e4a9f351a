"""Device time per gradient-MPC call: every kernel and copy in the calls' ranges."""
NAME = "gradient.device_ms_per_solve"
UNIT = "ms"
LAYER = "gradient solve graph (controllers/gradient/ocp.py, qp.py, sqp.py)"
MOVES = "solve_ms_p50"
SOURCE = "device_trace"


def read(rec, run):
    us = sum(d for _, _, d in rec.device)
    return us / rec.units / 1e3 if us > 0 else None
