"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit), and the least time a piece of work can take on it:
the larger of its bytes over the memory bandwidth and its operations
over the float32 rate of the CUDA cores."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
