"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the full
700 W power limit): HBM bandwidth, and float64 and float32 rates outside
the tensor cores."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34.0e12, "float32": 67.0e12}


def ms(nbytes: float, ops: float, dtype: str) -> tuple[float, float]:
    """(bytes ms, operations ms) at the peaks."""
    return (nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[dtype] * 1e3)
