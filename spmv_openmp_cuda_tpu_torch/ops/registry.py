"""Kernel registry: the uniform ABI + enumeration tables.

Counterpart of spmv_openmp_cuda_tpu/ops/registry.py (reference: the
function-pointer registries of src/include/SpMV.h:130-159 and the
COMPUTE_MODE string dispatch, SpMV.h:27-59), restricted to the modes the port
runs so far: DIA_ROWS (plain torch) and the CUDA DIA modes PL_DIA_ROWS,
PL_DIA_BF16, PL_DIA_RESID and PL_DIA_RESID_BF16. Mode names are the JAX
package's, so logs of both packages read the same.

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


from . import spmv_cuda  # noqa: E402,F401  (registers the DIA modes on import)
