"""spmv_openmp_cuda_tpu_torch — the PyTorch/CUDA port of spmv_openmp_cuda_tpu.

A second package beside the JAX one, for NVIDIA Hopper (H100, sm_90a): the
same host layer (MatrixMarket ingestion, COO/CSR/ELL, the serial oracle and
the 7e-4 check, the synthetic proxies), the DIA, DIA+residual, windowed
local-gather and Clos-routed engines on hand-written CUDA kernels (csrc/),
and AutoSpMV and the CLI over them. It imports torch and numpy, never jax or the JAX package.
"""
from .config import (
    AVG_TIMES_ITERATION,
    Config,
    DEFAULT_CONFIG,
    DOUBLE_DIFF_THRESH,
    ELL_MAX_ENTRIES,
    MAXRND,
)
from .formats.matrix import COOMatrix, CSRMatrix, ELLMatrix
from .formats.convert import (
    EllSizeError,
    coo_to_csr,
    coo_to_ell,
    csr_to_coo,
    csr_to_dense,
    sort_coo,
)
from .io.mmio import mm_to_csr, mm_to_ell, read_coo, write_mtx


def __getattr__(name):
    # lazy engine exports, as in the JAX package
    if name == "AutoSpMV":
        from .models.auto import AutoSpMV

        return AutoSpMV
    if name in ("prepare_dia", "DiaFillError"):
        from .formats import dia

        return getattr(dia, name)
    raise AttributeError(name)


__version__ = "0.1.0"
