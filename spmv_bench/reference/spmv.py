"""y = A x and the CG residual in float64, and the lower-precision controls.

The matrix is the benchmark's own CSR arrays (indptr, column indices and
the float64 values, which hold exactly the numbers the program was handed
at its precision). Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np
import torch

#: the control's precision: the nearest one below the configuration's
LOWER = {"float64": torch.float32, "float32": torch.bfloat16}


def csr_indptr(m: int, rows: np.ndarray) -> np.ndarray:
    """The row pointer of a pattern sorted by row."""
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=indptr[1:])
    return indptr


def product(indptr, cols, data, x, block: int = 8) -> np.ndarray:
    """A @ x in float64, row by row in column order; x is (n,) or (n, k),
    taken `block` columns at a time."""
    x = np.asarray(x, dtype=np.float64)
    one = x.ndim == 1
    xs = x[:, None] if one else x
    m = indptr.shape[0] - 1
    starts = indptr[:-1]
    empty = indptr[1:] == starts
    out = np.empty((m, xs.shape[1]))
    for j in range(0, xs.shape[1], block):
        terms = data[:, None] * xs[cols, j : j + block]
        # a zero row past the end: a row that starts at nnz (empty) sums it
        terms = np.concatenate([terms, np.zeros((1, terms.shape[1]))])
        s = np.add.reduceat(terms, starts, axis=0)
        s[empty] = 0.0
        out[:, j : j + block] = s
    return out[:, 0] if one else out


def abs_product(indptr, cols, data, x) -> np.ndarray:
    """|A| @ |x|: the scale each row's rounding error is measured against."""
    return product(indptr, cols, np.abs(data), np.abs(np.asarray(x, dtype=np.float64)))


def product_error(y, ref: np.ndarray, scale: np.ndarray) -> float:
    """max_i |y_i - ref_i| / (|A| |x|)_i: the largest error of a row against
    the size of its terms, so that a light row counts as much as a heavy
    one. Infinite where y is not finite; a row whose terms are all zero
    must be zero."""
    y = np.asarray(y, dtype=np.float64)
    if y.shape != ref.shape or not np.all(np.isfinite(y)):
        return float("inf")
    err = np.abs(y - ref) / np.maximum(scale, np.finfo(np.float64).tiny)
    return float(err.max(initial=0.0))


def relres(indptr, cols, data, x, b) -> float:
    """||b - A x|| / ||b|| in float64: the true residual of a solve."""
    x = np.asarray(x, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if not np.all(np.isfinite(x)):
        return float("inf")
    return float(np.linalg.norm(b - product(indptr, cols, data, x)) / np.linalg.norm(b))


class ControlSystem:
    """The reference in the program's place, in `dtype`, the precision
    below the configuration's: the inputs rounded to it, products summed in
    float32 for bfloat16, else in `dtype`; answers handed back in the
    configuration's precision, as the program's are."""

    def __init__(self, shape, indptr, cols, data, dtype: torch.dtype, out: torch.dtype, device):
        m = shape[0]
        self.m = m
        self.dtype = dtype
        self.acc = torch.float32 if dtype == torch.bfloat16 else dtype
        self.out = out
        lens = np.diff(indptr)
        self.rows = torch.from_numpy(np.repeat(np.arange(m), lens)).to(device)
        self.cols = torch.from_numpy(np.asarray(cols, dtype=np.int64)).to(device)
        self.vals = torch.from_numpy(np.asarray(data)).to(device).to(dtype)
        self.format = f"control-{str(dtype).removeprefix('torch.')}"

    def _product(self, x: torch.Tensor) -> torch.Tensor:
        t = (self.vals * x.to(self.dtype)[self.cols]).to(self.acc)
        return torch.zeros(self.m, dtype=self.acc, device=x.device).index_add_(0, self.rows, t)

    def product(self, x: torch.Tensor) -> torch.Tensor:
        return self._product(x).to(self.out)

    def solve(self, b: torch.Tensor, rtol: float, maxiter: int):
        """Plain CG from x0 = 0 in the control's precision: (x, iters,
        relres as CG tracks it)."""
        b = b.to(self.acc)
        x = torch.zeros_like(b)
        r = b.clone()
        p = r.clone()
        rs = torch.dot(r, r)
        bnorm = torch.sqrt(torch.dot(b, b))
        k = 0
        while k < maxiter and bool(torch.sqrt(rs) > rtol * bnorm):
            ap = self._product(p)
            alpha = rs / torch.dot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = torch.dot(r, r)
            p = r + (rs_new / rs) * p
            rs = rs_new
            k += 1
        return x.to(self.out), torch.tensor(k), torch.sqrt(rs) / bnorm
