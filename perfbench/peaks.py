"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit) and the least time a piece of work could take
on it."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def least_s(nbytes: float, flops: float) -> float:
    """The larger of the bytes over the memory rate and the float32
    operations over their rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
