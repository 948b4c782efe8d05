"""Double-float (float64) routed engine of the PyTorch port against the JAX
package: the df prepare (vals/vals_lo, hdense_hi/hdense_lo, heavy_rows_df)
array for array, the df gather kernel's plain version with the per-plane
permutations and the vectorised TwoSum reduce against the JAX package's
routed_spmv_df, the chunked path, and the JAX layout carried across.

Tolerances, on x ~ N(0, 1): port against JAX max |y_t - y_j| <= 1e-12 *
max|y_j| (both (hi, lo) f32 pairs; the sums' order and the cross terms'
rounding differ); against the exact f64 oracle 1e-11 * max|y|, 1e-10 for
the chunked path (tests/test_routed.py's bounds). The df layout keeps heavy
rows as (hi, lo) pairs, so the oracle is the exact matrix. The JAX engine's
jax_enable_x64 is scoped to each call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu as J
from spmv_openmp_cuda_tpu.formats import routed as jr
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch.formats import routed as tr
from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu_torch.utils import synth as tsynth

_MEMO = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _pair(coo):
    t = T.coo_to_csr(coo)
    return t, J.CSRMatrix(shape=t.shape, indptr=t.indptr, indices=t.indices, data=t.data)


def _x(n, seed=5):
    return np.random.default_rng(seed).standard_normal(n)


def _equal(t, j, what=""):
    t, j = t.numpy(), np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape, (what, t.dtype, j.dtype, t.shape, j.shape)
    np.testing.assert_array_equal(t, j, err_msg=what)


def _rel(y, want) -> float:
    y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    want = np.asarray(want, np.float64)
    assert y.dtype == np.float64 and y.shape == want.shape
    return float(np.abs(y - want).max() / np.abs(want).max())


def _jax_y(fn, *args):
    """The JAX df engine's f64 y (x64 scoped to the call)."""
    with jax.enable_x64(True):
        args = [jnp.asarray(a, jnp.float64) if isinstance(a, np.ndarray) else a for a in args]
        return np.asarray(fn(*args), np.float64)


# ---------------------------------------------------------------------------
# routed
# ---------------------------------------------------------------------------


def _spiked(m, n, spike_nnz, bg_nnz, seed):
    """tests/test_routed.py::_make_spiked: one long row 0 plus scattered nnz."""
    rng = np.random.default_rng(seed)
    heavy_cols = rng.choice(n, size=spike_nnz, replace=False)
    rows = np.r_[np.zeros(spike_nnz, np.int64), rng.integers(0, m, bg_nnz)]
    cols = np.r_[heavy_cols, rng.integers(0, n, bg_nnz)]
    return T.sort_coo(T.COOMatrix((m, n), rows, cols, rng.standard_normal(rows.shape[0])))


ROUTED = {
    "power_law": lambda: tsynth.power_law(4000, 4000, avg_nnz_per_row=5.0, alpha=1.6, seed=17),
    "heavy_row": lambda: _spiked(3000, 30000, 20000, 5000, seed=31),
    "split_level": lambda: _spiked(3000, 30000, 3000, 5000, seed=5),
}


def _routed_prepared(name):
    def make():
        tcsr, jcsr = _pair(ROUTED[name]())
        return tcsr, tr.prepare_routed_df(tcsr), jr.prepare_routed_df(jcsr)

    return _memo(("routed", name), make)


def _jax_mat_fields(jm):
    f = {k: getattr(jm, k) for k in (
        "vals", "pidx", "widx", "perm_products", "lvl_perms", "lvl_masks", "perm_out", "shape",
        "nnz", "n_windows", "rows_a", "runs", "lvl_runs", "out_t", "hdense", "heavy_rows",
        "widx_t", "heavy_lanes", "hvals")}
    for k in ("vals", "pidx", "widx", "hdense"):
        f[k] = None if f[k] is None else np.asarray(f[k])
    return f


@pytest.mark.parametrize("name", list(ROUTED))
def test_routed_df_prepare_and_plain_match_jax(name):
    tcsr, tm, jm = _routed_prepared(name)
    _equal(tm.mat.vals, jm.mat.vals, "vals")
    _equal(tm.vals_lo, jm.vals_lo, "vals_lo")
    _equal(tm.mat.pidx, jm.mat.pidx, "pidx")
    assert tm.heavy_rows_df == jm.heavy_rows_df
    assert (len(tm.heavy_rows_df) > 0) == (name == "heavy_row")
    assert (len(tm.mat.lvl_perms) > 0) == (name in ("power_law", "split_level"))
    if jm.hdense_hi is not None:
        _equal(tm.hdense_hi, jm.hdense_hi, "hdense_hi")
        _equal(tm.hdense_lo, jm.hdense_lo, "hdense_lo")
    assert tm.mat.runs == jm.mat.runs and tm.mat.lvl_runs == jm.mat.lvl_runs
    x = _x(tcsr.shape[1], seed=3)
    y_j = _jax_y(lambda xv: jr.routed_spmv_df(jm, xv), x)
    chain = trc.build_df_chain(tm)
    y_t = trc.routed_df_spmv(chain, torch.from_numpy(x))
    assert _rel(y_t, y_j) <= 1e-12
    # heavy rows are (hi, lo) pairs, not bf16: the exact matrix is the oracle
    assert _rel(y_t, serial_csr_spmv(tcsr, x)) < 1e-11


def test_routed_df_reduce_and_rowdot_match_jax():
    """The vectorised reduce and the heavy-row dot against the JAX package's
    XLA-level functions, eager: bit for bit."""
    tcsr, tm, jm = _routed_prepared("power_law")
    rng = np.random.default_rng(4)
    h = tm.mat.perm_products.h
    sh = rng.standard_normal((h, 128)).astype(np.float32)
    sl = (rng.standard_normal((h, 128)) * 1e-8).astype(np.float32)
    plan = trc.df_reduce_plan(tm.mat.runs, h, torch.device("cpu"))
    got = trc.reduce_runs_df(torch.from_numpy(sh), torch.from_numpy(sl), plan)
    want = jr._reduce_runs_df(jnp.asarray(sh), jnp.asarray(sl), tm.mat.runs)
    _equal(got[0], want[0], "hi")
    _equal(got[1], want[1], "lo")
    hh = rng.standard_normal((3, 1000)).astype(np.float32)
    hl = (rng.standard_normal((3, 1000)) * 1e-8).astype(np.float32)
    xh = rng.standard_normal(1000).astype(np.float32)
    xl = (rng.standard_normal(1000) * 1e-8).astype(np.float32)
    got = trc.df_dense_rowdot(*(torch.from_numpy(a) for a in (hh, hl, xh, xl)))
    want = jr._df_dense_rowdot(*(jnp.asarray(a) for a in (hh, hl, xh, xl)))
    _equal(got[0], want[0], "rowdot hi")
    _equal(got[1], want[1], "rowdot lo")


@pytest.mark.parametrize("name", ["power_law", "split_level"])
def test_routed_df_permutations_are_one_gather_per_plane(name):
    """The df chain applies each planned permutation to each plane as one
    gather through the plan's composed map (kernel B on the card): the
    staged W stages' result bit for bit, one map per plan, and the whole df
    product equal to the one with every stage staged."""
    tcsr, tm, _ = _routed_prepared(name)
    mat = tm.mat
    rng = np.random.default_rng(6)
    for plan in (mat.perm_products, *mat.lvl_perms, mat.perm_out):
        a = torch.from_numpy(rng.standard_normal((plan.h, 128)).astype(np.float32))
        assert torch.equal(trc._permute(plan, a, plain=False), trc._permute(plan, a, plain=True))
        assert list(plan.maps) == [("whole", False, plan.h)]
    chain = trc.build_df_chain(tm)
    x = torch.from_numpy(_x(tcsr.shape[1], seed=8))
    assert torch.equal(trc.routed_df_spmv(chain, x), trc.routed_df_spmv(chain, x, plain=True))


def test_routed_df_chunked():
    """The smallest chunked case: every column a multiple of 128 piles the
    gather slots onto one residue, so 24,000 nnz overflow one domain.
    prepare_routed_df_auto takes the float32 chunk bounds (found by the
    domain test alone) and df-prepares each chunk."""
    rng = np.random.default_rng(21)
    rows = np.repeat(np.arange(8000), 3)
    cols = rng.integers(0, 128, rows.size) * 128
    rows, cols = np.unique(np.stack([rows, cols]), axis=1)
    tcsr, jcsr = _pair(T.sort_coo(T.COOMatrix((8000, 16384), rows, cols, rng.standard_normal(rows.size))))
    mat = tr.prepare_routed_df_auto(tcsr)
    assert isinstance(mat, tr.RoutedChunks) and len(mat.chunks) == 3
    assert all(isinstance(c, tr.RoutedDF) for c in mat.chunks)
    # no block needed halving: the bounds are the JAX package's fit
    assert list(mat.bounds) == jr._fit_chunk_bounds(jcsr)
    x = _x(16384, seed=2)
    y = trc.routed_df_spmv(trc.build_df_chain(mat), torch.from_numpy(x))
    assert _rel(y, serial_csr_spmv(tcsr, x)) < 1e-10


def test_routed_df_from_jax_round_trip():
    """The port's df engine on the JAX package's prepared arrays gives the
    same y as on the port's own prepare (the same arrays)."""
    tcsr, tm, jm = _routed_prepared("heavy_row")
    fm = trc.routed_df_from_jax(
        _jax_mat_fields(jm.mat), np.asarray(jm.vals_lo), np.asarray(jm.hdense_hi),
        np.asarray(jm.hdense_lo), jm.heavy_rows_df)
    x = torch.from_numpy(_x(tcsr.shape[1]))
    assert torch.equal(trc.routed_df_spmv(trc.build_df_chain(fm), x),
                       trc.routed_df_spmv(trc.build_df_chain(tm), x))
    # heavy rows without their dense block
    with pytest.raises(ValueError, match="heavy"):
        trc.routed_df_from_jax(_jax_mat_fields(jm.mat), np.asarray(jm.vals_lo),
                               heavy_rows_df=jm.heavy_rows_df)


def test_routed_df_wrappers_check_on_the_cpu():
    rcsr, rm, _ = _routed_prepared("power_law")
    chain = trc.build_df_chain(rm)
    with pytest.raises(TypeError):
        trc.routed_df_spmv(chain, torch.zeros(rcsr.shape[1]))
    with pytest.raises(ValueError):
        trc.routed_df_spmv(chain, torch.zeros(rcsr.shape[1] - 1, dtype=torch.float64))
    with pytest.raises(ValueError):
        trc.build_df_chain(dataclasses.replace(rm, vals_lo=rm.vals_lo[:-128]))
    z = torch.zeros(rcsr.shape[1])
    with pytest.raises(ValueError, match="CUDA"):
        trc.routed_df_gather_cuda(rm.mat.vals, rm.vals_lo, rm.mat.pidx, rm.mat.widx,
                                  rm.mat.perm_products.t, z, z, z, z)
    assert trc.routed_df_gather_cuda.launches == 0
