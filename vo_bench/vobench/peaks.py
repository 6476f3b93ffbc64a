"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): the roofline's two ceilings."""
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float):
    """(least time in seconds, what bounds it) of work moving n_bytes and
    doing n_ops float32 operations."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
