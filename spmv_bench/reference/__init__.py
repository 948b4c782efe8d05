"""The plain reference: what the program's answers are judged against.

Plain NumPy in float64 over the matrix as the benchmark generated it, and
plain PyTorch for the controls (the reference put in the program's place in
a lower precision). It imports nothing of the program and takes nothing the
program made.
"""
from .spmv import (
    LOWER,
    ControlSystem,
    abs_product,
    csr_indptr,
    product,
    product_error,
    relres,
)

__all__ = [
    "LOWER",
    "ControlSystem",
    "abs_product",
    "csr_indptr",
    "product",
    "product_error",
    "relres",
]
