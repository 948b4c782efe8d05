"""Double-float (float-float) arithmetic: f64 semantics on f32 pairs.

Counterpart of spmv_openmp_cuda_tpu/ops/dfloat.py. The reference computes in
IEEE double throughout (its macros.h:63-76). The JAX package carries every
f64 operand as an (hi, lo) pair of f32s, hi = f32(a), lo = f32(a - hi) (48
mantissa bits), and runs the SpMV inner loops error-compensated on f32 units:

- products by Dekker TwoProduct (the hi-hi product exactly, as p + e) plus
  the two cross terms hi*lo and lo*hi in plain f32; lo*lo is dropped;
- sums by branch-free Knuth TwoSum into (acc_hi, acc_lo): each add's
  rounding error is captured exactly into the low word.

The port's df kernels (csrc/df_spmv.cu) compute the same pairs, and the
helpers here are their plain PyTorch versions' arithmetic. Every helper is
one elementwise torch op per step: eager PyTorch rounds each op's result to
f32, so nothing contracts a product into the following add (an FMA there
would absorb the unrounded product and collapse the pair to f32 accuracy).
Do not replace them with fused ops (`torch.addcmul`, `torch.compile`).

The df kernels' shared library is loaded here too (`df_lib`), once for the
three modules that launch its kernels.
"""
from __future__ import annotations

import ctypes
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from . import cuda_lib

Pair = Tuple[torch.Tensor, torch.Tensor]

#: Veltkamp split constant for f32 (2^12 + 1): splits a 24-bit mantissa
#: into two 12-bit halves whose pairwise products are exact in f32
_SPLIT = 4097.0


def split_f64(a) -> Tuple[np.ndarray, np.ndarray]:
    """Host split of an f64 array into its (hi, lo) f32 pair."""
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def split_f64_t(a: torch.Tensor) -> Pair:
    """The same split of an f64 tensor, on its device."""
    a = a.to(torch.float64)
    hi = a.to(torch.float32)
    return hi, (a - hi.to(torch.float64)).to(torch.float32)


def df_combine64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) pair -> f64: the only f64 arithmetic of a df product."""
    return hi.to(torch.float64) + lo.to(torch.float64)


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Knuth TwoSum: s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _veltkamp(a: torch.Tensor) -> Pair:
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Dekker TwoProduct without FMA: p + e == a * b exactly in f32."""
    p = a * b
    ah, al = _veltkamp(a)
    bh, bl = _veltkamp(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_mul_acc(acc_hi, acc_lo, a_hi, a_lo, b_hi, b_lo) -> Pair:
    """acc += a * b, every operand an (hi, lo) f32 pair: TwoProduct of the
    hi words, the cross terms in f32, the product's hi word into acc_hi by
    TwoSum, everything else into the low word."""
    p, e = two_prod(a_hi, b_hi)
    e = e + (a_hi * b_lo + a_lo * b_hi)
    acc_hi, err = two_sum(acc_hi, p)
    return acc_hi, acc_lo + (err + e)


def df_add(ah, al, bh, bl) -> Pair:
    """(ah, al) + (bh, bl): TwoSum of the hi words, low words added."""
    s, e = two_sum(ah, bh)
    return s, al + bl + e


def halve_pairs(parts: Sequence, add: Callable) -> object:
    """Pairwise tree over a list: neighbours (0, 1), (2, 3), ... are added
    until one is left; an odd last element passes to the next round."""
    parts: List = list(parts)
    while len(parts) > 1:
        parts = [
            add(parts[i], parts[i + 1]) if i + 1 < len(parts) else parts[i]
            for i in range(0, len(parts), 2)
        ]
    return parts[0]


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32, as a CUDA FMA (__fmaf_rn) rounds it,
    for f32 (or bf16) a and b and f32 c. The product is exact in f64 (at
    most 48 significant bits); the sum is rounded to odd in f64 (the f64
    sum, moved one step toward the exact sum where it is inexact and its
    last bit even, TwoSum giving the error), which then rounds to f32 as
    the exact sum would."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s, e = two_sum(p, c)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, float("inf")), torch.full_like(s, float("-inf")))
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def df_tree_sum(h: torch.Tensor, lo: torch.Tensor, dim: int) -> Pair:
    """halve_pairs over the slices of (h, lo) along dim, all slices of one
    round at once: the compensated sum of the dim axis (which is removed)."""
    h, lo = h.movedim(dim, 0), lo.movedim(dim, 0)
    while h.shape[0] > 1:
        even = h.shape[0] // 2 * 2
        sh, sl = df_add(h[0:even:2], lo[0:even:2], h[1:even:2], lo[1:even:2])
        if even < h.shape[0]:
            sh, sl = torch.cat([sh, h[even:]]), torch.cat([sl, lo[even:]])
        h, lo = sh, sl
    return h[0], lo[0]


# ---------------------------------------------------------------------------
# The df kernels' library (csrc/df_spmv.cu), shared by ops/spmv_cuda.py,
# ops/window_cuda.py and ops/routed_cuda.py
# ---------------------------------------------------------------------------


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dia_df_launch.argtypes = [p, p, p, i, ll, ll, p, ll, p, i, p]
    lib.dia_df_launch.restype = i
    lib.dia_resid_df_launch.argtypes = [p, p, p, i, ll, ll, p, p, p, p, p, ll, p, i, p]
    lib.dia_resid_df_launch.restype = i
    lib.window_df_launch.argtypes = [
        p, p, p, p, p, i, i, i, i, i, i, i, p, ll, ll, p, i, i, i, i, i, p,
    ]
    lib.window_df_launch.restype = i
    lib.routed_df_chain_launch.argtypes = [p, i, p, ll, p, p, p, p]
    lib.routed_df_chain_launch.restype = i
    lib.df_error_string.argtypes = [i]
    lib.df_error_string.restype = ctypes.c_char_p


def df_lib() -> ctypes.CDLL:
    """csrc/df_spmv.cu, built at first use and loaded once."""
    return cuda_lib.load("df_spmv", _bind)


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        msg = df_lib().df_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
