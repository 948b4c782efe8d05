"""Multi-device sharded SpMV over a mesh of torch.devices, in one process or
across the processes of a torch.distributed group.

Counterpart of spmv_openmp_cuda_tpu/parallel/sharded.py, with the same names.
The JAX package runs each path as one shard_map program over a Mesh; the
port runs the same local bodies per shard, in shard order, with the
collectives of parallel/collectives.py between them. A sharded operand or x
is a list with one entry per shard of a mesh axis (parallel/mesh.py): the
shard's tensor where this process owns it, None where another process does.
Each process prepares and computes only its own shards; each product
returns its y joined on the axis' home device (mesh.home), on every rank
(the global array a shard_map program returns). Paths, numbered as in
contract.dryrun_multichip (the file's sections number them otherwise):

1. ell_rows_sharded: rows sharded, x replicated.
2. csr_cols_psum: columns sharded, the partial y summed by psum in a fixed
   shard order.
3. ell_ring: rows and x sharded; the x shard ring-rotates by ppermute while
   each step multiplies the matching local column stripe (D steps, D - 1
   exchanges).
4. dia_sharded: the DIA slab and x row-sharded, a halo of pad_sub rows from
   each neighbour.
8. dia_sharded_df: the same in double-float, both x planes exchanged.
6. window_sharded: the window engine's blocks row-sharded; x with a halo of
   wr rows on the left and h_right on the right (an all-gather where a
   shard is smaller than its window reach); the local product is the port's
   window kernel (csrc/window_spmv.cu::window_blocks_kernel) on the shard's
   halo'd x, one launch per shard.
5. routed_multidevice: row chunks of the routed engine, each on a device of
   its own (round-robin), each running its chain (ops/routed_cuda.py). No
   shard_map in the JAX package either: it takes this process's devices
   only (mesh.addressable), and exchanges nothing.

Paths 1-4 and 8 are plain torch ops, as the JAX package's are plain XLA. A
mesh replica along an axis a value is not sharded over computes nothing the
first line does not, so the port computes each shard once, on the first
device of its replica group (Mesh.axis_devices), in the process owning it.

Each path has a `*_from_jax` converter: the JAX op's arrays as numpy (its
shards gathered) -> the port's op, so that both packages can run the same
operands.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import LANE, SUBLANE
from ..formats.matrix import CSRMatrix, ELLMatrix, _ceil_to
from ..ops.spmv_cuda import _to_tensor
from .collectives import Parts, all_gather, each, gather_to, ppermute
from .mesh import COLS, ROWS, Mesh, _default_devices, addressable, shard


def _as_parts(x, mesh: Mesh, axis: str = ROWS) -> Parts:
    """x given as one tensor (replicated onto this process's devices of the
    axis) or as its per-shard list."""
    if isinstance(x, torch.Tensor):
        return [x.to(d) if mine else None
                for d, mine in zip(mesh.axis_devices(axis), mesh.is_local(axis))]
    return list(x)


def _neighbour(nd: int, step: int):
    return [(j, (j + step) % nd) for j in range(nd)]


def _tail(t: torch.Tensor, rows: int) -> torch.Tensor:
    return t[t.shape[0] - rows:]


# ---------------------------------------------------------------------------
# 1) Row-sharded ELL — the DP / row-block analog
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RowShardedELL:
    """Host-prepared operands of ell_rows_sharded, one piece per row shard."""

    data: Parts  # (M_pad/D, W) each
    cols: Parts
    row_lens: Parts  # (M_pad/D,) each
    m: int
    nnz: int


def row_sharded_ell_from_jax(data, cols, row_lens, m: int, nnz: int, mesh: Mesh) -> RowShardedELL:
    return RowShardedELL(
        data=shard(_to_tensor(data, "cpu"), mesh), cols=shard(_to_tensor(cols, "cpu"), mesh),
        row_lens=shard(_to_tensor(row_lens, "cpu"), mesh), m=int(m), nnz=int(nnz),
    )


def prepare_row_sharded_ell(ell: ELLMatrix, mesh: Mesh, dtype=torch.float32) -> RowShardedELL:
    n_rows = mesh.shape[ROWS]
    m, _ = ell.shape
    w = max(_ceil_to(max(ell.max_row_nz, 1), LANE), LANE)
    m_pad = _ceil_to(max(m, 1), SUBLANE * n_rows)
    data = np.zeros((m_pad, w), dtype=np.float64)
    cols = np.zeros((m_pad, w), dtype=np.int32)
    rl = np.zeros(m_pad, dtype=np.int32)
    data[:m, : ell.max_row_nz] = ell.data
    cols[:m, : ell.max_row_nz] = ell.ja
    # without explicit row_lens, rows are full width: padded slots hold 0
    rl[:m] = ell.row_lens if ell.row_lens is not None else ell.max_row_nz
    return row_sharded_ell_from_jax(torch.from_numpy(data).to(dtype), cols, rl, m, ell.nnz, mesh)


def make_ell_rows_sharded(mesh: Mesh):
    """y = A @ x with A row-sharded, x replicated (a tensor, or one per
    shard), y (M_pad,) joined on the first device."""

    def local(data, cols, row_lens, x):
        prods = data * x[cols.long()].to(data.dtype)
        k = torch.arange(prods.shape[1], device=prods.device)
        prods = torch.where(k < row_lens[:, None], prods, torch.zeros((), dtype=prods.dtype,
                                                                       device=prods.device))
        return prods.sum(dim=1)

    def spmv(op: RowShardedELL, x):
        ys = each(local, op.data, op.cols, op.row_lens, _as_parts(x, mesh))
        return gather_to(ys, mesh, ROWS)

    return spmv


# ---------------------------------------------------------------------------
# 2) Column-sharded CSR with psum — the 2D-tiles partial-sum analog
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ColShardedCSR:
    """Per-stripe column CSR parts, one per shard of the cols axis; `lengths`
    holds each stripe's nnz per row (m + 1 segments, the last the
    padding's), which the local sum reads."""

    data: Parts  # (nnz_max,) each
    local_cols: Parts
    row_ids: Parts
    lengths: Parts  # (m + 1,) int64 each
    x_pad: int  # padded total x length (D * stripe_w)
    stripe_w: int
    m: int
    nnz: int


def col_sharded_csr_from_jax(data, local_cols, row_ids, x_pad: int, stripe_w: int, m: int,
                             nnz: int, mesh: Mesh) -> ColShardedCSR:
    rids = np.asarray(row_ids)
    if (np.diff(rids, axis=1) < 0).any() or rids.min(initial=0) < 0 or rids.max(initial=0) > m:
        raise ValueError("row_ids must be ascending per stripe, in [0, m]")
    lengths = np.stack([np.bincount(r, minlength=m + 1) for r in rids]).astype(np.int64)

    def stripes(a):  # (D, k) -> stripe j's (k,) on shard j
        return [None if p is None else p[0] for p in shard(_to_tensor(a, "cpu"), mesh, COLS)]

    return ColShardedCSR(
        data=stripes(data), local_cols=stripes(local_cols), row_ids=stripes(rids),
        lengths=stripes(lengths),
        x_pad=int(x_pad), stripe_w=int(stripe_w), m=int(m), nnz=int(nnz),
    )


def prepare_col_sharded_csr(csr: CSRMatrix, mesh: Mesh, dtype=torch.float32) -> ColShardedCSR:
    """Split columns into uniform stripes of width ceil(N/D) (column indices
    re-based per stripe so each device gathers from its local x shard)."""
    d = mesh.shape[COLS]
    m, n = csr.shape
    stripe_w = -(-n // d)
    bucket = np.minimum(csr.indices // stripe_w, d - 1).astype(np.int64)
    rids_all = csr.row_ids()
    counts = np.bincount(bucket, minlength=d)
    nnz_max = max(_ceil_to(max(int(counts.max(initial=1)), 1), LANE), LANE)
    data = np.zeros((d, nnz_max), dtype=np.float64)
    lcols = np.zeros((d, nnz_max), dtype=np.int32)
    rids = np.full((d, nnz_max), m, dtype=np.int32)
    for j in range(d):
        sel = bucket == j
        k = int(counts[j])
        data[j, :k] = csr.data[sel]
        lcols[j, :k] = (csr.indices[sel] - j * stripe_w).astype(np.int32)
        rids[j, :k] = rids_all[sel]
    return col_sharded_csr_from_jax(torch.from_numpy(data).to(dtype), lcols, rids, d * stripe_w,
                                    stripe_w, m, csr.nnz, mesh)


def make_csr_cols_psum(mesh: Mesh, m: int):
    """y = psum_j(A_stripe_j @ x_shard_j): contraction-axis sharding. The
    padding slots carry value 0 and row id m, a segment of their own that
    is dropped. Each stripe's row sums are a segment sum (no atomics), the
    partials added in shard order on the axis' home device (psum's sum,
    also on a rank that owns no stripe): a rerun is bitwise equal."""
    from .collectives import sum_to

    def local(data, lcols, lengths, x_shard):
        prods = data * x_shard[lcols.long()].to(data.dtype)
        return torch.segment_reduce(prods, "sum", lengths=lengths, unsafe=True)[:m]

    def spmv(op: ColShardedCSR, x_parts):
        parts = each(local, op.data, op.local_cols, op.lengths, x_parts)
        return sum_to(parts, mesh, COLS, mesh.home(COLS))

    return spmv


def pad_x_for_col_sharding(x, op: ColShardedCSR, mesh: Mesh, dtype) -> Parts:
    xp = np.zeros(op.x_pad, dtype=np.float64)
    xp[: np.shape(x)[0]] = np.asarray(x, np.float64)
    return shard(torch.from_numpy(xp).to(dtype), mesh, COLS)


# ---------------------------------------------------------------------------
# 3) Ring ELL — rows AND x sharded, the x shard rotated by ppermute
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RingELL:
    """Each shard: its row block's slab split into D column stripes
    (m_loc, D, W_s), column indices re-based to stripe-local."""

    data: Parts
    cols: Parts
    m: int
    nnz: int
    d: int
    m_loc: int
    w_s: int
    chunk_w: int
    x_pad: int


def ring_ell_from_jax(data, cols, m: int, nnz: int, d: int, m_loc: int, w_s: int, chunk_w: int,
                      x_pad: int, mesh: Mesh) -> RingELL:
    return RingELL(
        data=shard(_to_tensor(data, "cpu"), mesh), cols=shard(_to_tensor(cols, "cpu"), mesh),
        m=int(m), nnz=int(nnz), d=int(d), m_loc=int(m_loc), w_s=int(w_s),
        chunk_w=int(chunk_w), x_pad=int(x_pad),
    )


def prepare_ring_ell(csr: CSRMatrix, mesh: Mesh, dtype=torch.float32) -> RingELL:
    """Per-(row-block, column-stripe) ELL slabs from CSR; W_s is the largest
    per-row nnz within any one stripe (lane-aligned), so every shard and
    step has the same shapes."""
    d = mesh.shape[ROWS]
    m, n = csr.shape
    m_loc = _ceil_to(max(-(-m // d), 1), SUBLANE)
    chunk_w = -(-n // d)
    bucket = np.minimum(csr.indices // chunk_w, d - 1).astype(np.int64)
    rids = csr.row_ids()
    per_rs = np.zeros((m, d), dtype=np.int64)
    np.add.at(per_rs, (rids, bucket), 1)
    w_s = max(_ceil_to(max(int(per_rs.max(initial=1)), 1), LANE), LANE)
    data = np.zeros((d, m_loc, d, w_s), dtype=np.float64)  # (dev, row, stripe, k)
    cols = np.zeros((d, m_loc, d, w_s), dtype=np.int32)
    order = np.lexsort((csr.indices, bucket, rids))  # by row, stripe, col
    r_s, b_s, c_s, v_s = rids[order], bucket[order], csr.indices[order], csr.data[order]
    group = r_s.astype(np.int64) * d + b_s
    start = np.zeros(m * d + 1, dtype=np.int64)
    np.cumsum(np.bincount(group, minlength=m * d), out=start[1:])
    slot = np.arange(group.shape[0]) - start[group]
    dev = r_s // m_loc
    row_l = r_s % m_loc
    data[dev, row_l, b_s, slot] = v_s
    cols[dev, row_l, b_s, slot] = (c_s - b_s * chunk_w).astype(np.int32)
    return ring_ell_from_jax(
        torch.from_numpy(data.reshape(d * m_loc, d, w_s)).to(dtype), cols.reshape(d * m_loc, d, w_s),
        m, csr.nnz, d, m_loc, w_s, chunk_w, d * chunk_w, mesh,
    )


def make_ell_ring(mesh: Mesh, op_meta: RingELL):
    """Fully sharded SpMV: step s on shard i adds stripe (i - s) mod D times
    the x chunk it holds, then (for s < D - 1) the chunks move one shard on,
    i -> i + 1 mod D. The exchange reads the chunk the step multiplies and
    the multiply does not wait for it."""
    d = op_meta.d
    perm = _neighbour(d, 1)

    def spmv(op: RingELL, x_parts):
        chunks = list(x_parts)
        accs = each(lambda a: torch.zeros(op.m_loc, dtype=a.dtype, device=a.device), op.data)
        for s in range(d):
            nxt = ppermute(chunks, mesh, ROWS, perm) if s < d - 1 else None
            for i in range(d):
                if accs[i] is None:
                    continue
                stripe = (i - s) % d
                dat, idx = op.data[i][:, stripe], op.cols[i][:, stripe]
                accs[i] = accs[i] + (dat * chunks[i][idx.long()].to(dat.dtype)).sum(dim=1)
            chunks = nxt
        return gather_to(accs, mesh, ROWS)

    return spmv


def pad_x_for_ring(x, op: RingELL, mesh: Mesh, dtype) -> Parts:
    xp = np.zeros(op.x_pad, dtype=np.float64)
    xp[: np.shape(x)[0]] = np.asarray(x, np.float64)
    return shard(torch.from_numpy(xp).to(dtype), mesh)


# ---------------------------------------------------------------------------
# 4) Row-sharded DIA with halo exchange — the banded flagship path
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedDIA:
    """The diagonal slab row-sharded (D, s_local, 128) per shard; x
    row-sharded too, the shift reach (pad_sub rows) crossing shard
    boundaries by one halo exchange each way. The wrap-around halo of the
    edge shards multiplies diagonal values that are zero outside the
    matrix."""

    data: Parts
    offsets: Tuple[int, ...]
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0
    pad_sub: int = 0
    s_local: int = 0


def _dia_geometry(s: int, pad_sub: int, nd: int) -> Tuple[int, int]:
    s_pad = _ceil_to(max(s, nd * SUBLANE), nd * SUBLANE)
    s_local = s_pad // nd
    if pad_sub > s_local:
        raise ValueError(f"diagonal reach {pad_sub} rows exceeds local shard {s_local}")
    return s_pad, s_local


def dia_sharded_from_jax(data, offsets, shape, nnz: int, pad_sub: int, s_local: int,
                         mesh: Mesh) -> ShardedDIA:
    """data: the JAX op's (D, S_pad, 128) slab, padded."""
    return ShardedDIA(
        data=shard(_to_tensor(data, "cpu"), mesh, dim=1), offsets=tuple(int(o) for o in offsets),
        shape=tuple(int(v) for v in shape), nnz=int(nnz), pad_sub=int(pad_sub),
        s_local=int(s_local),
    )


def prepare_dia_sharded(mat, mesh: Mesh) -> ShardedDIA:
    """Shard a DeviceDIA's row-group axis across mesh[ROWS]."""
    d, s, _ = mat.data.shape
    s_pad, s_local = _dia_geometry(s, mat.pad_sub, mesh.shape[ROWS])
    data = torch.nn.functional.pad(mat.data.cpu(), (0, 0, 0, s_pad - s))
    return dia_sharded_from_jax(data, mat.offsets, mat.shape, mat.nnz, mat.pad_sub, s_local, mesh)


def pad_x_for_dia_sharded(x, op: ShardedDIA, mesh: Mesh, dtype) -> Parts:
    """x -> (S_pad, 128) row-group layout, row-sharded."""
    s_pad = op.s_local * mesh.shape[ROWS]
    xt = torch.as_tensor(np.asarray(x)).to(dtype)
    xp = torch.nn.functional.pad(xt, (0, s_pad * LANE - xt.shape[0]))
    return shard(xp.reshape(s_pad, LANE), mesh)


def _halo(x_parts: Parts, mesh: Mesh, left_rows: int, right_rows: int) -> Parts:
    """Each shard's x with the left neighbour's last left_rows rows before
    it and the right neighbour's first right_rows after it (wrapping around
    at the edges): two ppermutes, their slices copied."""
    nd = len(x_parts)
    left = ppermute(each(lambda p: _tail(p, left_rows), x_parts), mesh, ROWS, _neighbour(nd, 1))
    right = ppermute(each(lambda p: p[:right_rows], x_parts), mesh, ROWS, _neighbour(nd, -1))
    return each(lambda p, lf, r: torch.cat([lf, p, r]), x_parts, left, right)


def _shifted(xp: torch.Tensor, off: int, s: int, base_sub: int) -> torch.Tensor:
    """(s, 128) of x[i + off] for the shard's flat rows i (the JAX package's
    formats/dia.py::shifted_view, on the flat halo'd x)."""
    base = base_sub * LANE + off
    return xp.reshape(-1)[base: base + s * LANE].reshape(s, LANE)


def make_dia_sharded(mesh: Mesh, op_meta: ShardedDIA):
    """y = A @ x, both row-sharded (a (S_pad, 128) y joined on the first
    device); the halo by one ppermute per direction. The local product adds
    the diagonals in offset order, as the JAX package's."""
    ps, offsets, s_local = op_meta.pad_sub, op_meta.offsets, op_meta.s_local

    def local(data, xp):
        acc = torch.zeros((s_local, LANE), dtype=data.dtype, device=data.device)
        for k, off in enumerate(offsets):
            acc = acc + data[k] * _shifted(xp, off, s_local, ps)
        return acc

    def spmv(op: ShardedDIA, x_parts):
        return gather_to(each(local, op.data, _halo(list(x_parts), mesh, ps, ps)), mesh, ROWS)

    return spmv


# ---------------------------------------------------------------------------
# 8) Row-sharded double-float DIA with halo exchange
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedDIADF:
    """ShardedDIA carrying the (hi, lo) double-float slab pair."""

    data: Parts  # f32 hi words
    data_lo: Parts  # f32 lo words
    offsets: Tuple[int, ...]
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0
    pad_sub: int = 0
    s_local: int = 0


def dia_sharded_df_from_jax(data, data_lo, offsets, shape, nnz: int, pad_sub: int, s_local: int,
                            mesh: Mesh) -> ShardedDIADF:
    hi = dia_sharded_from_jax(data, offsets, shape, nnz, pad_sub, s_local, mesh)
    return ShardedDIADF(data=hi.data, data_lo=shard(_to_tensor(data_lo, "cpu"), mesh, dim=1),
                        offsets=hi.offsets, shape=hi.shape, nnz=hi.nnz, pad_sub=hi.pad_sub,
                        s_local=hi.s_local)


def prepare_dia_sharded_df(mat, mesh: Mesh) -> ShardedDIADF:
    """Shard a DeviceDIADF's row-group axis across mesh[ROWS]."""
    d, s, _ = mat.data.shape
    s_pad, s_local = _dia_geometry(s, mat.pad_sub, mesh.shape[ROWS])
    pad = (0, 0, 0, s_pad - s)
    return dia_sharded_df_from_jax(
        torch.nn.functional.pad(mat.data.cpu(), pad), torch.nn.functional.pad(mat.data_lo.cpu(), pad),
        mat.offsets, mat.shape, mat.nnz, mat.pad_sub, s_local, mesh,
    )


def pad_x_for_dia_sharded_df(x, op: ShardedDIADF, mesh: Mesh) -> Tuple[Parts, Parts]:
    """f64 x -> row-sharded (hi, lo) f32 plane pair."""
    from ..ops.dfloat import split_f64

    s_pad = op.s_local * mesh.shape[ROWS]
    xp = np.zeros(s_pad * LANE, dtype=np.float64)
    xp[: np.shape(x)[0]] = np.asarray(x, np.float64)
    xh, xl = split_f64(xp)
    return (shard(torch.from_numpy(xh).reshape(s_pad, LANE), mesh),
            shard(torch.from_numpy(xl).reshape(s_pad, LANE), mesh))


def make_dia_sharded_df(mesh: Mesh, op_meta: ShardedDIADF):
    """(y_hi, y_lo) = A @ x in double-float, row-sharded with halo: per
    diagonal, TwoProduct of the hi words, the cross terms in f32, the
    product's hi word into acc_hi by TwoSum (ops/dfloat.py, one op per step:
    nothing fused)."""
    from ..ops.dfloat import two_prod, two_sum

    ps, offsets, s_local = op_meta.pad_sub, op_meta.offsets, op_meta.s_local

    def local(dh, dl, xh, xl):
        acc_h = torch.zeros((s_local, LANE), dtype=torch.float32, device=dh.device)
        acc_l = torch.zeros_like(acc_h)
        for k, off in enumerate(offsets):
            vh = _shifted(xh, off, s_local, ps)
            vl = _shifted(xl, off, s_local, ps)
            ph, pe = two_prod(dh[k], vh)
            plo = pe + (dh[k] * vl + dl[k] * vh)
            acc_h, e = two_sum(acc_h, ph)
            acc_l = acc_l + (plo + e)
        return acc_h, acc_l

    def spmv(op: ShardedDIADF, xh_parts, xl_parts):
        xhs = _halo(list(xh_parts), mesh, ps, ps)
        xls = _halo(list(xl_parts), mesh, ps, ps)
        outs = each(local, op.data, op.data_lo, xhs, xls)
        return tuple(gather_to([None if o is None else o[j] for o in outs], mesh, ROWS)
                     for j in (0, 1))

    return spmv


# ---------------------------------------------------------------------------
# 6) Row-sharded windowed local-gather engine — block-DP + halo exchange
# ---------------------------------------------------------------------------


def window_x_rows(nblocks: int, g: int, nspecs: int) -> int:
    """x rows (of 128) of a shard's halo'd x: its own blocks' rows, the
    window radius before them and the staging slack after them (the JAX
    package's formats/window.py::window_x_rows, the padded x stack its
    kernel reads). The port's kernel reads x directly; here it only sizes
    the halo."""
    return -(-((nblocks - 1) * g) // 8) * 8 + nspecs * 8 + 8


@dataclasses.dataclass
class ShardedWindow:
    """A WindowCSR's blocks, padded to nd * nb_local blocks, row-sharded:
    shard i holds blocks [i*nb_local, (i+1)*nb_local) as a WindowCSR of its
    own (`shards`, shape (own*128, (own + h_right)*128)), whose kernel reads
    the shard's x with its halo: wr rows of the left neighbour before it,
    h_right rows of the right neighbour after it. Each shard starts at an
    8-row x boundary (nb_local*g % 8 == 0), as the Q map's staging offsets
    assume. Wrap-around halo values meet zero slot values. `layout` is the
    unsharded WindowCSR (host), the single-device twin; every shard's
    kernel takes the launch plan of the unsharded layout's plan_blocks
    blocks, so each block adds in the layout's order and y equals its
    product bit for bit."""

    shards: List  # WindowCSR per shard
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0
    g: int = 8
    k_pad: int = 16
    wr: int = 1
    nspecs: int = 2
    nb_local: int = 1
    nd: int = 1
    k_c: int = 0
    layout: Optional[object] = None

    @property
    def plan_blocks(self) -> int:
        """The unsharded bps=1 layout's block count, whatever the padding."""
        return -(-self.shape[0] // (self.g * LANE))

    @property
    def own(self) -> int:
        """x rows (of 128) a shard owns."""
        return self.nb_local * self.g

    @property
    def h_right(self) -> int:
        return window_x_rows(self.nb_local, self.g, self.nspecs) - self.wr - self.own

    @property
    def halo_ok(self) -> bool:
        """The one-step halo reaches the immediate neighbours only; smaller
        shards all-gather x."""
        return self.h_right <= self.own and self.wr <= self.own


def window_sharded_from_jax(vals, sidx, gid, rsrc, shape, nnz: int, g: int, k_pad: int, wr: int,
                            nspecs: int, nb_local: int, nd: int, k_c: int, mesh: Mesh,
                            layout=None) -> ShardedWindow:
    """The JAX op's padded (nd*nb_local*k_pad, 128) block arrays (rsrc
    (nd*nb_local*n_ktiles*128, 128)) -> a WindowCSR per own shard (None for
    another process's)."""
    from ..formats.window import WindowCSR

    if mesh.shape[ROWS] != nd or (nb_local * g) % 8:
        raise ValueError(f"{nd} shards of {nb_local} blocks of g={g} on mesh {mesh.shape}")
    op = ShardedWindow(shards=[], shape=tuple(int(v) for v in shape), nnz=int(nnz), g=int(g),
                       k_pad=int(k_pad), wr=int(wr), nspecs=int(nspecs), nb_local=int(nb_local),
                       nd=int(nd), k_c=int(k_c), layout=layout)
    if layout is not None and layout.nblocks != op.plan_blocks:
        raise ValueError(f"layout of {layout.nblocks} blocks, not {op.plan_blocks} (bps=1)")
    cut = [shard(_to_tensor(a, "cpu"), mesh) for a in (vals, sidx, gid, rsrc)]
    op.shards = each(lambda v, s, gd, r: WindowCSR(
        vals=v, sidx=s, gid=gd, rsrc=r, shape=(op.own * LANE, (op.own + op.h_right) * LANE),
        nnz=op.nnz, g=op.g, k_pad=op.k_pad, wr=op.wr, nspecs=op.nspecs, nblocks=op.nb_local,
        k_c=op.k_c, bps=1, xdirect=False, shared_w=False,
    ), *cut)
    return op


def prepare_window_sharded(csr: CSRMatrix, mesh: Mesh, dtype=torch.float32) -> ShardedWindow:
    """Prepare (prepare_window_auto with xdirect=False and bps=1, so that Q
    is baked relative to each block's own staged window) and shard the
    block arrays over mesh[ROWS], blocks padded to a multiple of nd*c with
    c = 8 / gcd(g, 8) so that every shard starts at an 8-row x boundary."""
    from ..formats.window import prepare_window_auto

    nd = mesh.shape[ROWS]
    mat = prepare_window_auto(csr, dtype=dtype, xdirect=False, bps=1, device="cpu")
    c = 8 // math.gcd(mat.g, 8)
    nb_pad = _ceil_to(mat.nblocks, nd * c)

    def pad_blocks(a, rows_per_block):
        return torch.nn.functional.pad(a, (0, 0, 0, (nb_pad - mat.nblocks) * rows_per_block))

    return window_sharded_from_jax(
        pad_blocks(mat.vals, mat.k_pad), pad_blocks(mat.sidx, mat.k_pad),
        pad_blocks(mat.gid, mat.k_pad), pad_blocks(mat.rsrc, mat.n_ktiles * LANE), mat.shape,
        mat.nnz, mat.g, mat.k_pad, mat.wr, mat.nspecs, nb_pad // nd, nd, mat.k_c, mesh,
        layout=mat,
    )


def pad_x_for_window_sharded(x, op: ShardedWindow, mesh: Mesh, dtype) -> Parts:
    """x -> (nd*nb_local*g, 128) chunk-row layout, row-sharded (each shard
    holds exactly its own blocks' x rows; halos move at run time)."""
    rows = op.nd * op.own
    xt = torch.as_tensor(np.asarray(x)).to(dtype)
    xp = torch.nn.functional.pad(xt, (0, rows * LANE - xt.shape[0]))
    return shard(xp.reshape(rows, LANE), mesh)


def window_shard_spmv(mat, slab: torch.Tensor, x_lo: int, plain: bool = False,
                      plan_blocks: Optional[int] = None) -> torch.Tensor:
    """One shard's product: slab holds x columns x_lo .. of the shard's
    layout (its halo'd x, flat f32). CUDA tensors: one launch of
    window_blocks_kernel, with the launch plan of plan_blocks blocks; CPU
    tensors, or plain=True: its plain version."""
    from ..ops import window_cuda as WC

    if slab.device.type == "cpu" or plain:
        WC._check_window(mat, slab, x_lo)
        return WC.window_spmv_reference(mat, slab, x_lo)
    y = torch.empty(mat.shape[0], dtype=torch.float32, device=slab.device)
    return WC.window_blocks_cuda(mat, slab, y, x_lo, plan_blocks)


def window_slabs(mesh: Mesh, op: ShardedWindow, x_parts: Parts) -> Parts:
    """Each shard's halo'd x (flat f32, x columns -wr*128 .. of its layout):
    the window reach by one ppermute each way (halo_ok), else by an
    all-gather of x and each shard's slice of it."""
    wr, own, h_right = op.wr, op.own, op.h_right
    if op.halo_ok:
        return each(lambda s: s.reshape(-1).to(torch.float32),
                    _halo(list(x_parts), mesh, wr, h_right))
    total = wr + own + h_right

    def window(x_all, i):
        z = torch.zeros((total, LANE), dtype=x_all.dtype, device=x_all.device)
        padded = torch.cat([z[:wr], x_all, z])
        return padded[i * own: i * own + total].reshape(-1).to(torch.float32)

    return each(window, all_gather(list(x_parts), mesh, ROWS), range(op.nd))


def make_window_sharded(mesh: Mesh, op_meta: ShardedWindow, plain: bool = False):
    """y = A @ x (length m, on the first device) with blocks and x
    row-sharded: window_slabs, then one window kernel launch per shard on
    its halo'd x (plain=True: the kernel's plain version, on any device)."""

    def spmv(op: ShardedWindow, x_parts):
        ys = each(lambda s, slab: window_shard_spmv(s, slab, -op.wr * LANE, plain, op.plan_blocks),
                   op.shards, window_slabs(mesh, op, x_parts))
        return gather_to(ys, mesh, ROWS)[: op.shape[0]]

    return spmv


# ---------------------------------------------------------------------------
# 5) Multi-device chunked routed engine — heterogeneous row blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiDeviceRouted:
    """Row-block routed engines pinned round-robin to devices, each with its
    chain (ops/routed_cuda.py::build_chain) on its device. The chunks'
    structures differ, so each runs its own program; x is copied once per
    device."""

    chunks: Tuple  # RoutedCSR per block, on its device
    chains: Tuple  # RoutedChain per block
    devices: Tuple
    bounds: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int


def _routed_multidevice(chunks, bounds, shape, nnz, devices) -> MultiDeviceRouted:
    from ..ops.routed_cuda import build_chain

    return MultiDeviceRouted(chunks=tuple(chunks), chains=tuple(build_chain(c) for c in chunks),
                             devices=tuple(devices), bounds=tuple(int(b) for b in bounds),
                             shape=tuple(int(v) for v in shape), nnz=int(nnz))


def prepare_routed_multidevice(csr: CSRMatrix, devices=None, dtype=torch.float32) -> MultiDeviceRouted:
    """Split rows into routed chunks of about nnz / len(devices) each (the
    greedy split, fit_domains=False, halved where a chunk's domain is too
    large) and prepare chunk i on devices[i % len(devices)]. devices
    default to every card of this process; under a process group a device
    of another rank (a mesh.RankDevice) raises ValueError, as jax.device_put
    does for a device another process owns."""
    from ..formats.routed import _sub_csr, prepare_routed, routed_chunk_bounds

    devices = tuple(addressable(devices) if devices is not None else _default_devices())
    nd = len(devices)
    target = max(int(np.ceil(csr.nnz / nd)), 1)
    bounds = routed_chunk_bounds(csr, chunk_nnz=target, fit_domains=False)
    chunks = [prepare_routed(_sub_csr(csr, r0, r1), dtype=dtype, device=devices[i % nd])
              for i, (r0, r1) in enumerate(zip(bounds[:-1], bounds[1:]))]
    return _routed_multidevice(chunks, bounds, csr.shape, csr.nnz, devices)


def routed_multidevice_from_jax(chunks: Sequence[dict], bounds, shape, nnz: int,
                                devices) -> MultiDeviceRouted:
    """chunks: one ops/routed_cuda.py::routed_from_jax keyword set per JAX
    chunk (its arrays as numpy); chunk i goes to devices[i % len(devices)]."""
    from ..ops.routed_cuda import routed_from_jax

    devices = tuple(addressable(devices))
    mats = [routed_from_jax(**c, device=devices[i % len(devices)]) for i, c in enumerate(chunks)]
    return _routed_multidevice(mats, bounds, shape, nnz, devices)


def routed_multidevice_spmv(op: MultiDeviceRouted, x) -> torch.Tensor:
    """y = A @ x (f32) with each chunk's product enqueued on its device
    before any result is read; y is joined on the first device as a tensor
    (the JAX package returns a numpy array)."""
    from ..ops.routed_cuda import routed_chain_spmv

    xt = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    xt = xt.to(torch.float32)
    per_dev = {}
    for ch in op.chains:  # one copy per device
        if ch.device not in per_dev:
            per_dev[ch.device] = xt.to(ch.device)
    ys = [routed_chain_spmv(ch, per_dev[ch.device]) for ch in op.chains]
    return torch.cat([y.to(op.devices[0]) for y in ys])
