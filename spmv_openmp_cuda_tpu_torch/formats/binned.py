"""Row-binned jagged-ELL device format ("binned CSR").

Counterpart of spmv_openmp_cuda_tpu/formats/binned.py. Rows are permuted by
length (the row_binning pass, the reference's dynamic-scheduling and
chunk-balance analog, ompChunksDivide.h) and grouped into width classes;
each class is a dense (W_c, M_c) or (M_c, W_c) slab, so the product is a
handful of dense multiply-reduces over memory proportional to nnz. The
per-class results are concatenated and each row reads its own slot back
(a gather, no scatter). The prepare is the JAX package's, array for array:
the same flat buffers, offsets and "t"/"r" layouts (the layout choice
counts the TPU's (8, 128) tile padding, kept so that both packages hold the
same arrays). This is the port's float64 fallback mode, native f64 torch
ops on the card.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..config import LANE, SUBLANE
from ..partition.partitioners import row_binning
from .matrix import CSRMatrix, _ceil_to


def width_classes(max_w: int) -> List[int]:
    """Width-class boundaries 8, 16, 32, ... (doubling): per-row padding
    stays below 2x plus alignment."""
    out = [SUBLANE]
    while out[-1] < max_w:
        out.append(out[-1] * 2)
    return out


@dataclasses.dataclass
class BinnedCSR:
    """Width-class slabs packed into one flat buffer.

    Class c is slab_data[class_offsets[c] : + W_c*M_c] read as (W_c, M_c)
    when its layout is "t" (transposed, rows along the minor axis) or
    (M_c, W_c) when "r" (row-major); out_pos[i] is row i's position in the
    concatenated per-class outputs.
    """

    slab_data: torch.Tensor  # 1D: concat of per-class slabs
    slab_cols: torch.Tensor  # 1D int32, same layout
    out_pos: torch.Tensor  # (M_pad,) int32
    class_offsets: Tuple[int, ...]
    class_widths: Tuple[Tuple[int, int], ...]  # (W_c, M_c) per class
    class_layouts: Tuple[str, ...] = ()
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0


def prepare_binned_csr(
    csr: CSRMatrix, dtype: torch.dtype = torch.float32, device="cpu"
) -> BinnedCSR:
    m, n = csr.shape
    rl = csr.compute_row_lens()
    order = row_binning(rl)  # descending length (chunk-balance analog)
    sorted_lens = rl[order]

    classes = width_classes(int(rl.max(initial=1)))
    # rows (in sorted order) go to classes; rows of length 0 go to the
    # smallest class (they read padding and produce 0)
    buf_data: List[np.ndarray] = []
    buf_cols: List[np.ndarray] = []
    class_offsets: List[int] = []
    class_widths: List[Tuple[int, int]] = []
    class_layouts: List[str] = []
    out_positions = np.zeros(m, dtype=np.int64)
    offset = 0
    out_base = 0
    start = 0
    for ci in range(len(classes) - 1, -1, -1):  # largest class first
        w = classes[ci]
        lo = classes[ci - 1] if ci > 0 else 0
        # rows with lo < len <= w
        end = start
        while end < m and sorted_lens[end] > lo:
            end += 1
        if ci == 0:
            end = m  # the smallest class takes everything left (incl. len 0)
        cnt = end - start
        if cnt == 0 and ci != 0:
            start = end
            continue
        # the layout with the smaller footprint under (8, 128) tile padding
        phys_t = w * _ceil_to(max(cnt, 1), LANE)
        phys_r = _ceil_to(max(cnt, 1), SUBLANE) * _ceil_to(w, LANE)
        layout = "t" if phys_t <= phys_r else "r"
        if layout == "t":
            m_c = max(_ceil_to(max(cnt, 1), LANE), LANE)
        else:
            m_c = max(_ceil_to(max(cnt, 1), SUBLANE), SUBLANE)
        data_c = np.zeros((w, m_c), dtype=np.float64)
        cols_c = np.zeros((w, m_c), dtype=np.int32)
        if cnt:
            rows_in_class = order[start:end]
            lens_c = sorted_lens[start:end]
            total = int(lens_c.sum())
            if total:
                row_rep = np.repeat(np.arange(cnt), lens_c)
                within = np.arange(total) - np.repeat(np.cumsum(lens_c) - lens_c, lens_c)
                src = csr.indptr[rows_in_class][row_rep] + within
                data_c[within, row_rep] = csr.data[src]
                cols_c[within, row_rep] = csr.indices[src]
        if layout == "r":
            data_c, cols_c = data_c.T, cols_c.T
        buf_data.append(data_c.ravel())
        buf_cols.append(cols_c.ravel())
        class_offsets.append(offset)
        class_widths.append((w, m_c))
        class_layouts.append(layout)
        out_positions[start:end] = out_base + np.arange(cnt)
        offset += w * m_c
        out_base += m_c
        start = end

    out_pos = np.zeros(max(_ceil_to(max(m, 1), LANE), LANE), dtype=np.int32)
    out_pos[order] = out_positions
    return BinnedCSR(
        slab_data=torch.as_tensor(np.concatenate(buf_data), dtype=dtype, device=device),
        slab_cols=torch.as_tensor(np.concatenate(buf_cols), device=device),
        out_pos=torch.as_tensor(out_pos, device=device),
        class_offsets=tuple(class_offsets),
        class_widths=tuple(class_widths),
        class_layouts=tuple(class_layouts),
        shape=(m, n),
        nnz=csr.nnz,
    )


def binned_spmv(mat: BinnedCSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over the width-class slabs: per class a dense
    multiply-reduce, then the assembly by a gather at out_pos."""
    parts = []
    for off, (w, m_c), layout in zip(mat.class_offsets, mat.class_widths, mat.class_layouts):
        shape = (w, m_c) if layout == "t" else (m_c, w)
        data = mat.slab_data[off : off + w * m_c].reshape(shape)
        cols = mat.slab_cols[off : off + w * m_c]
        xg = x.index_select(0, cols).reshape(shape).to(data.dtype)
        parts.append((data * xg).sum(dim=0 if layout == "t" else 1))
    concat = torch.cat(parts) if len(parts) > 1 else parts[0]
    return concat.index_select(0, mat.out_pos)[: mat.shape[0]]
