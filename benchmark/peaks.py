"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its full 700 W power limit): what a roofline share is taken against."""

FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the FP32 peak and the bytes over the memory's."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
