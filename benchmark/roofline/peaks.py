"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet): device memory bandwidth and float32 outside the tensor cores.
A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) reaches
less; the benchmark states shares against these peaks, with the card's
limit beside them."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def bound_s(nbytes: float, ops: float):
    """(least seconds the card could take, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the operations over the
    float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")
