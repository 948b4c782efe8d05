"""The least time a product could take on one H100, from the matrix alone.

The bytes are the matrix's own: each stored value once at the
configuration's precision, x read once and y written once. Column indices,
row pointers and whatever layout the program prepares are not counted, so
that a change of layout cannot move the yardstick. The operations are
2 nnz. Peaks are NVIDIA's data sheet figures for the H100 SXM at its 700 W
limit (dense, no sparsity); the card's power limit is printed beside every
run.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
#: CUDA-core (not tensor-core) rates, which a sparse product runs on
FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def product_bytes(m: int, n: int, nnz: int, dtype: str) -> int:
    return (nnz + n + m) * ITEMSIZE[dtype]


def product_flops(nnz: int) -> int:
    return 2 * nnz


def least_time_s(m: int, n: int, nnz: int, dtype: str) -> float:
    """max(bytes / bandwidth, operations / peak rate)."""
    return max(
        product_bytes(m, n, nnz, dtype) / HBM_BYTES_PER_S,
        product_flops(nnz) / FLOPS_PER_S[dtype],
    )
