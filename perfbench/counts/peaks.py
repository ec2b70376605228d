"""NVIDIA H100 SXM peaks, from NVIDIA's data sheet (dense rates, no
sparsity), at the card's full power limit of 700 W. A share of one of these
is stated against the published peak; the run records the card's power
limit beside it."""

BF16_FLOPS = 989e12  # tensor cores, bf16 / fp16 dense
TF32_FLOPS = 495e12
F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
HBM_BYTES_S = 3.35e12


def least_s(flops: float, nbytes: float, flops_peak: float) -> float:
    """The least time the card could take: the larger of the operations
    over their peak and the bytes over HBM's."""
    return max(flops / flops_peak, nbytes / HBM_BYTES_S)
