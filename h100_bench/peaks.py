"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet, dense,
at the 700 W limit) and the least time of the work the benchmark counts."""

#: bf16 tensor-core FLOP/s
BF16_FLOPS = 989e12
#: HBM bytes/s
HBM_BYTES = 3.35e12


def all_pairs_scan_s(n: int, d: int, k: int = 10) -> float:
    """The least time of an exhaustive k-NN scan of n rows of width d
    against themselves: 2*n*n*d operations at the bf16 peak, or its bytes
    (the float32 rows read once, k (id, distance) pairs per row written
    once) at the HBM rate, whichever is larger."""
    return max(2.0 * n * n * d / BF16_FLOPS, (4.0 * n * d + 8.0 * n * k) / HBM_BYTES)
