"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit).  The configurations compute in float32 with TF32
off, so the FLOP peak is float32 outside the tensor cores."""

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, n_bytes: float):
    """(least seconds, "operations" or "bytes"): the larger of the two
    bounds and which one it is."""
    t_ops, t_bytes = ops / FP32_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
