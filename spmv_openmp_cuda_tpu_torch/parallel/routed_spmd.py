"""Single-program multi-device routed engine: schema'd chunks, one per shard.

Counterpart of spmv_openmp_cuda_tpu/parallel/routed_spmd.py. The rows split
fairly by nnz into mesh.shape[ROWS] chunks; every chunk is prepared against
one shared pow2-ladder schema (formats/routed.py::routed_schema_stats,
merge_routed_schemas, prepare_routed(schema=...)), so all chunks have the
same shapes, runs, level count and window count. The JAX package needs that
to stack the chunks under one shard_map; the port keeps them as a list, each
chunk's RoutedCSR and its chain (ops/routed_cuda.py::build_chain) on its
shard's device, and runs the same chain for every size (the JAX package's
_W3_FUSED_MAX_ROWS split serves its TPU's VMEM only). x is replicated: every
chunk reads any column. The schema takes no heavy split: hub rows reduce
over the multi-level runs, uniform across chunks.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..formats import routed as R
from ..formats.matrix import CSRMatrix
from .collectives import gather_to
from .mesh import ROWS, Mesh


@dataclasses.dataclass
class SpmdRouted:
    """Schema'd chunk operands, one per shard of the rows axis, and their
    chains."""

    mats: List  # RoutedCSR per shard, on its device
    chains: List  # RoutedChain per shard
    bounds: Tuple[int, ...]  # chunk row bounds (len nd + 1)
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0
    nwin: int = 1
    h_out: int = 0


def _fair_nnz_bounds(csr: CSRMatrix, nd: int) -> Tuple[int, ...]:
    cum = csr.indptr.astype(np.int64)
    targets = (np.arange(1, nd) * csr.nnz) // nd
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = [0]
    for c in cuts:
        bounds.append(int(min(max(c, bounds[-1] + 1), csr.shape[0] - (nd - len(bounds)))))
    bounds.append(csr.shape[0])
    return tuple(bounds)


def _spmd(mats, bounds, shape, nnz: int) -> SpmdRouted:
    from ..ops.routed_cuda import build_chain

    h_out = mats[0].perm_out.h
    if any(m.perm_out.h != h_out or m.runs != mats[0].runs or m.lvl_runs != mats[0].lvl_runs
           or m.rows_a != mats[0].rows_a for m in mats):
        raise ValueError("the chunks do not share one schema")
    return SpmdRouted(mats=list(mats), chains=[build_chain(m) for m in mats],
                      bounds=tuple(int(b) for b in bounds), shape=tuple(int(v) for v in shape),
                      nnz=int(nnz), nwin=mats[0].n_windows, h_out=h_out)


def prepare_routed_spmd(csr: CSRMatrix, mesh: Mesh, dtype=torch.float32,
                        vals_dtype=None) -> SpmdRouted:
    nd = mesh.shape[ROWS]
    if csr.nnz < nd:
        raise R.RoutedError(f"need at least {nd} nnz for {nd}-way split")
    bounds = _fair_nnz_bounds(csr, nd)
    chunks = [R._sub_csr(csr, bounds[b], bounds[b + 1]) for b in range(nd)]
    schema = R.merge_routed_schemas([R.routed_schema_stats(c) for c in chunks])
    mats = [R.prepare_routed(c, dtype=dtype, vals_dtype=vals_dtype, schema=schema, device=dev)
            for c, dev in zip(chunks, mesh.axis_devices(ROWS))]
    return _spmd(mats, bounds, csr.shape, csr.nnz)


def routed_spmd_from_jax(chunks: Sequence[dict], bounds, shape, nnz: int, mesh: Mesh) -> SpmdRouted:
    """chunks: per shard, the ops/routed_cuda.py::routed_from_jax keywords
    of the JAX op's stacked mats at that index (as numpy). Each chunk's
    shape is taken from the bounds (the JAX op normalizes it to its output
    domain)."""
    from ..ops.routed_cuda import routed_from_jax

    n = int(shape[1])
    mats = [routed_from_jax(**dict(c, shape=(bounds[b + 1] - bounds[b], n)), device=dev)
            for b, (c, dev) in enumerate(zip(chunks, mesh.axis_devices(ROWS)))]
    return _spmd(mats, bounds, shape, nnz)


def make_routed_spmd(mesh: Mesh, op: SpmdRouted):
    """Every shard runs its chunk's chain on its copy of x; each chunk's y
    is its m_b rows, and the pieces join in row order on the first
    device."""
    from ..ops.routed_cuda import routed_chain_spmv

    def spmv(op_: SpmdRouted, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        per_dev = {}
        ys = []
        for chain in op_.chains:
            if chain.device not in per_dev:  # one copy per device
                per_dev[chain.device] = x.to(chain.device)
            ys.append(routed_chain_spmv(chain, per_dev[chain.device]))
        return gather_to(ys, ys[0].device)[: op_.shape[0]]

    return spmv
