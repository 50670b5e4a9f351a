"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
power limit): float32 outside the tensor cores and HBM3 bandwidth."""

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> tuple:
    """(seconds, "operations" or "bytes"): the larger of the two bounds."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
