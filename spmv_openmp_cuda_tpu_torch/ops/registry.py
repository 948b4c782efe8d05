"""Kernel registry: the uniform ABI + enumeration tables.

Counterpart of spmv_openmp_cuda_tpu/ops/registry.py (reference: the
function-pointer registries of src/include/SpMV.h:130-159 and the
COMPUTE_MODE string dispatch, SpMV.h:27-59), with the JAX package's 26
modes under the same names, formats and f64 flags, so logs of both packages
read the same:

- plain torch (impl "torch", the JAX package's XLA modes): the reference's
  OpenMP strategy matrix CSR_ROWS, CSR_ROWS_GROUPS, CSR_TILES,
  CSR_TILES_ALLOCD, ELL_ROWS, ELL_ROWS_GROUPS, ELL_TILES, ELL_ROWS_T,
  ELL_ROWS_NOSIMD, ELL_ROWS_NORL (ops/spmv_torch.py), CSR_ROWS_BINNED
  (formats/binned.py) and DIA_ROWS;
- hand-written CUDA (impl "cuda", the JAX package's Pallas modes): the DIA
  modes PL_DIA_ROWS, PL_DIA_BF16, PL_DIA_RESID, PL_DIA_RESID_BF16,
  PL_ELL_ROWS_T, PL_CSR_LANES, the window modes PL_CSR_WINDOW and
  PL_CSR_WINDOW_BF16, the routed modes PL_CSR_ROUTED and
  PL_CSR_ROUTED_BF16, and the double-float (float64) modes PL_DIA_F64,
  PL_DIA_RESID_F64, PL_CSR_WINDOW_F64 and PL_CSR_ROUTED_F64.

Uniform ABI: every kernel is described by a KernelSpec whose
  prepare(csr, ell, cfg, device) -> operands (host prepare + upload)
  run(operands, x)               -> y
split mirrors the reference's separation of host-side setup from the timed
kernel body (ElapsedInternal).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered compute mode."""

    name: str  # compute-mode string (CLI + harness id)
    fmt: str  # "csr" | "ell" — which host format it needs
    impl: str  # "torch" | "cuda"
    prepare: Callable  # (csr, ell, cfg, device) -> operands
    run: Callable  # (operands, x) -> y
    doc: str = ""
    #: double-precision semantics: takes a float64 x and returns float64
    #: (the double-float engines)
    f64: bool = False

    def jitted(self, operands) -> Callable:
        """Closure over prepared operands: x -> y. PyTorch runs eagerly, so
        there is nothing to compile; the name mirrors the JAX package."""
        run = self.run
        return lambda x: run(operands, x)


_REGISTRY: Dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate kernel {spec.name}")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> KernelSpec:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown compute mode {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def all_kernels(fmt: Optional[str] = None, impl: Optional[str] = None) -> List[KernelSpec]:
    return [
        s
        for s in _REGISTRY.values()
        if (fmt is None or s.fmt == fmt) and (impl is None or s.impl == impl)
    ]


def names() -> List[str]:
    return list(_REGISTRY)


from . import spmv_torch  # noqa: E402,F401  (registers the plain-torch CSR/ELL modes)
from . import spmv_cuda  # noqa: E402,F401  (registers the DIA modes on import)
from . import ell_cuda  # noqa: E402,F401  (registers PL_ELL_ROWS_T)
from . import lanes_cuda  # noqa: E402,F401  (registers PL_CSR_LANES)
from . import window_cuda  # noqa: E402,F401  (registers the window modes)
from . import routed_cuda  # noqa: E402,F401  (registers the routed modes)
