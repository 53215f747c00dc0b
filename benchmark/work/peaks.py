"""
The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
outside the tensor cores for float32 / float64; 700 W) and the roofline
bound of a piece of work against them.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}


def bound_s(n_ops, n_bytes, dtype):
    """The least seconds the card could take for ``n_ops`` operations of
    ``dtype`` and ``n_bytes`` bytes moved: the larger of the two."""
    return max(n_ops / PEAK_OPS_PER_S[dtype], n_bytes / HBM_BYTES_PER_S)
