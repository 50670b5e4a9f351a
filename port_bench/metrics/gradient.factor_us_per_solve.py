"""Device time per gradient-MPC call of the Mehrotra QP's factorization and
triangular solves: the kernels whose names hold one of ``PATTERNS`` (as the profiler
names them on an H100 with torch 2.11 and CUDA 12.8: cuSOLVER's Cholesky runs as
``getrf_wo_pivot`` and its panel kernels, the triangular solves as ``trsv_*``)."""
from port_bench.metrics._kernels import kernels

NAME = "gradient.factor_us_per_solve"
UNIT = "us"
LAYER = "Mehrotra QP factorization (controllers/gradient/qp.py)"
MOVES = "solve_ms_p50"
SOURCE = "device_trace"
PATTERNS = ("potrf", "getrf", "potrs", "trsm", "trsv", "cholesky")


def read(rec, run):
    us = [d for n, d in kernels(rec) if any(p in n.lower() for p in PATTERNS)]
    return sum(us) / rec.units if us else None
