"""spmv_openmp_cuda_tpu_torch — the PyTorch/CUDA port of spmv_openmp_cuda_tpu.

A second package beside the JAX one, for NVIDIA Hopper (H100, sm_90a): the
same host layer (MatrixMarket ingestion, COO/CSR/ELL and their device forms,
the partitioners, the serial oracle and the 7e-4 check, the synthetic
proxies), the JAX registry's 26 modes under the same names (the DIA,
DIA+residual, windowed local-gather, Clos-routed, transposed-ELL and
lane-gather engines and the double-float ones on hand-written CUDA kernels
in csrc/; the reference's CSR/ELL strategy matrix and the binned slabs as
torch ops), AutoSpMV, the solvers over it (CG and power iteration, a CUDA
graph per chunk of iterations on the card), prepared-format files that
either package loads, the native host library's binding (io/native.py), the
CLI, and the oracle-checked harness, sweep and log reducer (bench/). It
imports torch and numpy, never jax or the JAX package.
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
    if name in ("prepare_routed_auto", "RoutedError"):
        from .formats import routed

        return getattr(routed, name)
    if name in ("prepare_lanes_small", "LanesError"):
        from .formats import lanes

        return getattr(lanes, name)
    if name in ("save_prepared", "load_prepared"):
        from .formats import serialize

        return getattr(serialize, name)
    raise AttributeError(name)


__version__ = "0.1.0"
