"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
full 700 W power limit): the yardstick of every roofline share."""

HBM_BYTES_PER_S = 3.35e12       # HBM3
FP32_FLOPS = 67e12              # float32 on the CUDA cores


def work_bound_s(nbytes, flops):
    """(seconds, 'bytes' or 'operations'): the least time of work that
    moves ``nbytes`` through HBM and does ``flops`` float32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
