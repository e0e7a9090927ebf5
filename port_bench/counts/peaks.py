"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
#: outside the tensor cores
FP32_FLOPS_PER_S = 67e12
FP64_FLOPS_PER_S = 34e12

FLOPS_PER_S = {"float32": FP32_FLOPS_PER_S, "float64": FP64_FLOPS_PER_S}


def least_seconds(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the card could take for this work: the larger of
    its operations over the peak rate and its bytes over HBM bandwidth."""
    return max(flops / FLOPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)
