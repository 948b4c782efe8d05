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

Under a process group every rank takes the same bounds and the same schema
(both from the whole matrix, which every rank holds), so each shard's chunk
and chain are the one-process ones; a rank prepares and runs only its own
shards' chunks (None in the others' places), and every rank gets the joined
y.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import LANE
from ..formats import routed as R
from ..formats.matrix import CSRMatrix
from ..ops.route import pick_t
from .collectives import each, gather_to
from .mesh import ROWS, Mesh


@dataclasses.dataclass
class SpmdRouted:
    """Schema'd chunk operands, one per shard of the rows axis, and their
    chains (None for another process's shard). nwin and h_out are the
    schema's, which every chunk shares."""

    mats: List  # RoutedCSR per own shard, on its device
    chains: List  # RoutedChain per own shard
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


def _spmd(mats, bounds, shape, nnz: int, nwin: int, h_out: int) -> SpmdRouted:
    from ..ops.routed_cuda import build_chain

    own = [m for m in mats if m is not None]
    if any(m.perm_out.h != h_out or m.n_windows != nwin or m.runs != own[0].runs
           or m.lvl_runs != own[0].lvl_runs or m.rows_a != own[0].rows_a for m in own):
        raise ValueError("the chunks do not share one schema")
    return SpmdRouted(mats=list(mats), chains=each(build_chain, mats),
                      bounds=tuple(int(b) for b in bounds), shape=tuple(int(v) for v in shape),
                      nnz=int(nnz), nwin=int(nwin), h_out=int(h_out))


def prepare_routed_spmd(csr: CSRMatrix, mesh: Mesh, dtype=torch.float32,
                        vals_dtype=None) -> SpmdRouted:
    nd = mesh.shape[ROWS]
    if csr.nnz < nd:
        raise R.RoutedError(f"need at least {nd} nnz for {nd}-way split")
    bounds = _fair_nnz_bounds(csr, nd)
    chunks = [R._sub_csr(csr, bounds[b], bounds[b + 1]) for b in range(nd)]
    schema = R.merge_routed_schemas([R.routed_schema_stats(c) for c in chunks])
    mats = [R.prepare_routed(c, dtype=dtype, vals_dtype=vals_dtype, schema=schema, device=dev)
            if mine else None
            for c, dev, mine in zip(chunks, mesh.axis_devices(ROWS), mesh.is_local(ROWS))]
    return _spmd(mats, bounds, csr.shape, csr.nnz, schema["nwin"],
                 pick_t(schema["out_rows"]) * LANE)


def routed_spmd_from_jax(chunks: Sequence[dict], bounds, shape, nnz: int, mesh: Mesh) -> SpmdRouted:
    """chunks: per shard, the ops/routed_cuda.py::routed_from_jax keywords
    of the JAX op's stacked mats at that index (as numpy). Each chunk's
    shape is taken from the bounds (the JAX op normalizes it to its output
    domain). Every rank passes every shard's keywords; it converts its own."""
    from ..ops.routed_cuda import routed_from_jax

    n = int(shape[1])
    mats = [routed_from_jax(**dict(c, shape=(bounds[b + 1] - bounds[b], n)), device=dev)
            if mine else None
            for b, (c, dev, mine) in enumerate(zip(chunks, mesh.axis_devices(ROWS),
                                                   mesh.is_local(ROWS)))]
    out = chunks[0]["perm_out"]
    t_out = out["t"] if isinstance(out, dict) else out.t
    return _spmd(mats, bounds, shape, nnz, chunks[0]["n_windows"], int(t_out) * LANE)


def make_routed_spmd(mesh: Mesh, op: SpmdRouted):
    """Every own shard runs its chunk's chain on its copy of x; each
    chunk's y is its m_b rows, and the pieces join in row order on the
    home device, on every rank."""
    from ..ops.routed_cuda import routed_chain_spmv

    def spmv(op_: SpmdRouted, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        per_dev = {}

        def run(chain):
            if chain.device not in per_dev:  # one copy per device
                per_dev[chain.device] = x.to(chain.device)
            return routed_chain_spmv(chain, per_dev[chain.device])

        return gather_to(each(run, op_.chains), mesh, ROWS)[: op_.shape[0]]

    return spmv
