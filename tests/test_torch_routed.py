"""Routed slice of the PyTorch port against the JAX package: the Clos
planning and the host prepare must be array-equal (every stage array, bf16
bit for bit, and every static field), and the plain versions of the four
CUDA routed kernels must agree with the JAX Pallas kernels (interpret mode on
the CPU) on the same operands.

Tolerances: data movement and products are exact, so they must be equal.
Sums (the reduce, the heavy rows, whole products) are f32 sums of the same
terms in another order: |y_t - y_j| <= 1e-5*|y_j| + 1e-6*max|y_j| on
x ~ N(0, 1). Against the f64 oracle of the matrix as stored (heavy rows, and
with bf16 gather values every value, rounded to bf16):
1e-5*max|y| + 1e-6."""
import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu as J
from spmv_openmp_cuda_tpu.formats import routed as jr
from spmv_openmp_cuda_tpu.models import auto as jauto
from spmv_openmp_cuda_tpu.ops import route as jroute
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch import cli
from spmv_openmp_cuda_tpu_torch.formats import routed as tr
from spmv_openmp_cuda_tpu_torch.io.mmio import write_mtx
from spmv_openmp_cuda_tpu_torch.io.vectors import fill_rnd_vector
from spmv_openmp_cuda_tpu_torch.models import auto as tauto
from spmv_openmp_cuda_tpu_torch.ops import registry
from spmv_openmp_cuda_tpu_torch.ops import route as troute
from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu_torch.utils import synth as tsynth
from spmv_openmp_cuda_tpu_torch.utils.compare import vectors_diff

LANE = 128


def _spiked(m, n, spike_nnz, bg_nnz, seed):
    """tests/test_routed.py::_make_spiked: one long row 0 plus scattered nnz."""
    rng = np.random.default_rng(seed)
    heavy_cols = rng.choice(n, size=spike_nnz, replace=False)
    rows = np.r_[np.zeros(spike_nnz, np.int64), rng.integers(0, m, bg_nnz)]
    cols = np.r_[heavy_cols, rng.integers(0, n, bg_nnz)]
    return T.sort_coo(T.COOMatrix((m, n), rows, cols, rng.standard_normal(rows.shape[0])))


def _many_rows_one_split(seed=3):
    """17,000 short rows (n_g1 >= 128 groups) and one 300-nnz row: one t = 1
    level, fused into the level-1 reduce by the JAX package."""
    rng = np.random.default_rng(seed)
    m = n = 17000
    rows = np.r_[np.full(300, 5, np.int64), rng.integers(0, m, 40000)]
    cols = np.r_[rng.choice(n, 300, replace=False), rng.integers(0, n, 40000)]
    rows, cols = np.unique(np.stack([rows, cols]), axis=1)
    return T.sort_coo(T.COOMatrix((m, n), rows, cols, rng.standard_normal(rows.shape[0])))


def _heavy_many(seed=51):
    """70 heavy rows of 600 nnz: with heavy_threshold=512 a dense block of
    more than 64 rows (the JAX package's XLA-dot branch)."""
    rng = np.random.default_rng(seed)
    n_heavy, per_row, m, n = 70, 600, 200, 8000
    rows = np.concatenate([np.full(per_row, r) for r in range(n_heavy)] + [rng.integers(n_heavy, m, 1500)])
    cols = np.concatenate([rng.choice(n, size=per_row, replace=False) for _ in range(n_heavy)]
                          + [rng.integers(0, n, 1500)])
    rows, cols = np.unique(np.stack([rows, cols]), axis=1)
    return T.COOMatrix((m, n), rows, cols, rng.standard_normal(rows.shape[0]))


def _small(mn=9000, nnz=40000, seed=7):
    """tests/test_routed.py::test_routed_small_single_kernel's matrix."""
    rng = np.random.default_rng(seed)
    rows, cols = np.unique(np.stack([rng.integers(0, mn, nnz), rng.integers(0, mn, nnz)]), axis=1)
    return T.COOMatrix((mn, mn), rows, cols, rng.standard_normal(rows.shape[0]))


MATRICES = {
    "power_law": lambda: tsynth.power_law(4000, 4000, avg_nnz_per_row=5.0, alpha=1.6, seed=17),
    "random_uniform": lambda: tsynth.random_uniform(2500, 2500, density=0.003, seed=17),
    "spiked_dense": lambda: _spiked(3000, 30000, 20000, 5000, seed=31),
    "split_level": lambda: _spiked(3000, 30000, 3000, 5000, seed=5),
    "fused_level": _many_rows_one_split,
    "heavy_many": _heavy_many,
    "small": _small,
    "chunked": lambda: tsynth.power_law(6000, 6000, avg_nnz_per_row=6.0, alpha=1.5, seed=9),
}

#: prepare keywords per case (both packages); "chunked" runs the greedy split
PREPARE_KW = {"heavy_many": dict(heavy_threshold=512)}

_MEMO = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _csrs(name):
    """(port CSR, JAX CSR) of a case: the same arrays."""
    def make():
        t = T.coo_to_csr(MATRICES[name]())
        return t, J.CSRMatrix(shape=t.shape, indptr=t.indptr, indices=t.indices, data=t.data)

    return _memo(("csr", name), make)


def _prepared(name, bf16=False):
    """(port layout, JAX layout) of a case, prepared once per module."""
    def make():
        tcsr, jcsr = _csrs(name)
        if name == "chunked":
            kw = dict(chunk_nnz=3000, fit_domains=False)
            return (
                tr.prepare_routed_chunked(tcsr, vals_dtype=torch.bfloat16 if bf16 else None, **kw),
                jr.prepare_routed_chunked(jcsr, vals_dtype=jnp.bfloat16 if bf16 else None, **kw),
            )
        kw = PREPARE_KW.get(name, {})
        return (
            tr.prepare_routed(tcsr, vals_dtype=torch.bfloat16 if bf16 else None, **kw),
            jr.prepare_routed(jcsr, vals_dtype=jnp.bfloat16 if bf16 else None, **kw),
        )

    return _memo(("prep", name, bf16), make)


def _x(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _equal(t, j, what=""):
    t, j = _np(t), _np(j)
    assert t.dtype == j.dtype and t.shape == j.shape, (what, t.dtype, j.dtype, t.shape, j.shape)
    np.testing.assert_array_equal(t, j, err_msg=what)


def _close(y_t, y_j):
    y_t, y_j = _np(y_t).astype(np.float64), np.asarray(y_j, np.float64)
    assert y_t.shape == y_j.shape
    bound = 1e-5 * np.abs(y_j) + 1e-6 * np.abs(y_j).max()
    assert np.all(np.abs(y_t - y_j) <= bound), np.abs(y_t - y_j).max()


PLAN_FIELDS = ("r1", "w1", "w2", "w3", "r3", "wc")
STATIC = ("shape", "nnz", "n_windows", "rows_a", "runs", "lvl_runs", "out_t", "heavy_rows",
          "widx_t", "heavy_lanes")


def _plan_equal(tp, jp, what):
    assert tp.t == jp.t, what
    for f in PLAN_FIELDS:
        a, b = getattr(tp, f), getattr(jp, f)
        assert (a is None) == (b is None), (what, f)
        if a is not None:
            _equal(a, b, f"{what}.{f}")


def _routed_equal(tm, jm):
    for f in ("vals", "pidx", "widx"):
        _equal(getattr(tm, f), getattr(jm, f), f)
    assert (tm.hdense is None) == (jm.hdense is None) and jm.hvals is None
    if tm.hdense is not None:
        _equal(tm.hdense, jm.hdense, "hdense")
    _plan_equal(tm.perm_products, jm.perm_products, "perm_products")
    _plan_equal(tm.perm_out, jm.perm_out, "perm_out")
    assert len(tm.lvl_perms) == len(jm.lvl_perms)
    for k, (tp, jp) in enumerate(zip(tm.lvl_perms, jm.lvl_perms)):
        _plan_equal(tp, jp, f"lvl_perms[{k}]")
        _equal(tm.lvl_masks[k], jm.lvl_masks[k], f"lvl_masks[{k}]")
    for f in STATIC:
        assert getattr(tm, f) == getattr(jm, f), f


def _layout_equal(tm, jm):
    if isinstance(jm, jr.RoutedChunks):
        assert isinstance(tm, tr.RoutedChunks)
        assert tm.bounds == jm.bounds and tm.shape == jm.shape and tm.nnz == jm.nnz
        assert len(tm.chunks) == len(jm.chunks)
        for a, b in zip(tm.chunks, jm.chunks):
            _routed_equal(a, b)
    else:
        _routed_equal(tm, jm)


# ---------------------------------------------------------------------------
# planning and prepare
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 4])
def test_plan_permutation_matches_jax(t):
    rng = np.random.default_rng(t)
    perm = rng.permutation(t * LANE * LANE)
    _plan_equal(troute.plan_permutation(perm, t), jroute.plan_permutation(perm, t), "plan")
    src_row = rng.permutation(np.repeat(np.arange(t * LANE), LANE))
    tp, tm = troute.plan_row_to_slot(src_row, perm, t)
    jp, jm = jroute.plan_row_to_slot(src_row, perm, t)
    _plan_equal(tp, jp, "row_to_slot")
    np.testing.assert_array_equal(tm, jm)
    assert troute.pick_t(129) == jroute.pick_t(129) == 2
    with pytest.raises(ValueError):
        troute.pick_t(LANE * LANE + 1)


@pytest.mark.parametrize("name", ["power_law", "random_uniform", "spiked_dense", "split_level",
                                  "fused_level", "heavy_many", "chunked"])
def test_prepare_routed_array_equal(name):
    tm, jm = _prepared(name)
    _layout_equal(tm, jm)
    mat = tm.chunks[0] if name == "chunked" else tm
    if name == "spiked_dense":
        assert mat.heavy_rows == (0,) and mat.hdense.shape[0] == 1
    if name in ("split_level", "fused_level"):
        assert len(mat.lvl_perms) == 1 and not mat.heavy_rows
    if name == "fused_level":
        assert mat.lvl_perms[0].t == 1 and mat.runs[-1][3] + mat.runs[-1][1] >= LANE
    if name == "chunked":
        assert len(tm.chunks) >= 3


@pytest.mark.parametrize("name", ["power_law", "spiked_dense", "chunked"])
def test_prepare_routed_bf16_bit_for_bit(name):
    tm, jm = _prepared(name, bf16=True)
    _layout_equal(tm, jm)
    f32, _ = _prepared(name)
    a = f32.chunks[0] if name == "chunked" else f32
    b = tm.chunks[0] if name == "chunked" else tm
    # the bf16 prepare is the f32 layout with vals cast
    assert torch.equal(a.vals.to(torch.bfloat16), b.vals)


def test_prepare_routed_auto_agrees():
    tcsr, jcsr = _csrs("power_law")
    _layout_equal(tr.prepare_routed_auto(tcsr), jr.prepare_routed_auto(jcsr))
    for r0, r1 in ((0, 700), (1200, 4000)):
        assert tr._predict_domain_rows(tcsr, r0, r1) == jr._predict_domain_rows(jcsr, r0, r1)
    assert tr._fit_chunk_bounds(tcsr, 500) == jr._fit_chunk_bounds(jcsr, 500)
    lens = np.diff(tcsr.indptr)
    assert tr._pick_heavy_threshold(tcsr, lens) == jr._pick_heavy_threshold(jcsr, lens)


def test_prepare_raises_what_the_port_lacks(monkeypatch):
    tcsr, jcsr = _csrs("heavy_many")
    # a dense heavy block over the cap needs the pooled tiles: shrink the cap
    monkeypatch.setattr(tr, "_DENSE_HEAVY_MAX_BYTES", 1000)
    with pytest.raises(NotImplementedError, match="_heavy_sums"):
        tr.prepare_routed(tcsr, heavy_threshold=512)
    monkeypatch.undo()
    with pytest.raises(NotImplementedError, match="multi-device"):
        tr.prepare_routed(tcsr, schema={"rows_a": 128})
    with pytest.raises(NotImplementedError, match="float32"):
        tr.prepare_routed(tcsr, dtype=torch.float64)
    empty = T.CSRMatrix((5, 5), np.zeros(6, np.int64), np.zeros(0, np.int64), np.zeros(0))
    with pytest.raises(tr.RoutedError):
        tr.prepare_routed(empty)
    with pytest.raises(jr.RoutedError):
        jr.prepare_routed(J.CSRMatrix((5, 5), np.zeros(6, np.int64), np.zeros(0, np.int64), np.zeros(0)))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX Pallas kernels
# ---------------------------------------------------------------------------


def _from_jax(jm):
    if isinstance(jm, jr.RoutedChunks):
        return trc.routed_chunks_from_jax([_fields(c) for c in jm.chunks], jm.bounds, jm.shape, jm.nnz)
    return trc.routed_from_jax(**_fields(jm))


def _fields(jm):
    f = {k: getattr(jm, k) for k in (
        "vals", "pidx", "widx", "perm_products", "lvl_perms", "lvl_masks", "perm_out", "shape",
        "nnz", "n_windows", "rows_a", "runs", "lvl_runs", "out_t", "hdense", "heavy_rows",
        "widx_t", "heavy_lanes", "hvals")}
    for k in ("vals", "pidx", "widx", "hdense"):
        f[k] = None if f[k] is None else np.asarray(f[k])
    return f


def _xw(jm, x):
    return jr._pack_xw(jm, jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("name,bf16", [("power_law", False), ("power_law", True),
                                       ("spiked_dense", False), ("fused_level", False)])
def test_gather_matches_jax(name, bf16):
    _, jm = _prepared(name, bf16)
    tm = _from_jax(jm)
    x = _x(tm.shape[1])
    xt = torch.as_tensor(x, dtype=torch.float32)
    xw = _xw(jm, x)
    y_w1 = trc.routed_gather(tm, xt)
    _equal(y_w1, jr._gather_w1(jm, xw), "_gather_w1 single-block")
    # widx_t=() forces the JAX per-tile grid kernel (:1005)
    _equal(y_w1, jr._gather_w1(dataclasses.replace(jm, widx_t=()), xw), "_gather_w1 grid")
    _equal(trc.routed_gather(tm, xt, w1=False), jr._gather_products(jm, xw), "_gather_products")


def _random_plan(t, seed):
    perm = np.random.default_rng(seed).permutation(t * LANE * LANE)
    return troute.plan_permutation(perm, t), jroute.plan_permutation(perm, t)


@pytest.mark.parametrize("t", [1, 4])
def test_w_stage_matches_jax(t):
    tp, jp = _random_plan(t, seed=10 + t)
    x = np.random.default_rng(t).standard_normal((t * LANE, LANE)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _equal(trc.w_stage(xt, tp.w1), jroute._whole_w_call(xj, jp.w1), "w")
    _equal(trc.w_stage(xt, tp.w1, r=tp.r1), jroute._whole_w_call(xj, jp.w1, r=jp.r1), "r, w")
    _equal(trc.w_stage(xt, tp.w3, ra=tp.r3), jroute._whole_w_call(xj, jp.w3, r_after=jp.r3), "w, ra")
    # the per-grid-tile kernels the JAX package runs for t > 64
    for kern, targs, jargs in (
        (jroute._tile_kernel, dict(w=tp.w2), (jp.w2,)),
        (jroute._row_and_tile_kernel, dict(w=tp.w1, r=tp.r1), (jp.r1, jp.w1)),
        (jroute._tile_and_row_kernel, dict(w=tp.w3, ra=tp.r3), (jp.w3, jp.r3)),
    ):
        yj = jroute._tiled_call(kern, 1 + len(jargs), t, jnp.float32)(xj, *jargs)
        _equal(trc.w_stage(xt, **targs), yj, kern.__name__)
    _equal(trc.apply_sw_w2_sw(tp, xt), jroute.apply_sw_w2_sw(jp, xj), "sw_w2_sw")
    _equal(trc.apply_permutation_to_mid(tp, xt), jroute.apply_permutation_to_mid(jp, xj), "to_mid")
    for skip in (False, True):
        _equal(trc.apply_permutation_from_w1(tp, xt, skip), jroute.apply_permutation_from_w1(jp, xj, skip),
               "from_w1")
        _equal(trc.apply_permutation(tp, xt, skip), jroute.apply_permutation(jp, xj, skip), "apply")
    _equal(trc.apply_w_stage(tp.w2[LANE:], xt[LANE:]) if t > 1 else trc.apply_w_stage(tp.w2, xt),
           jroute.apply_w_stage(jp.w2[LANE:], xj[LANE:]) if t > 1 else jroute.apply_w_stage(jp.w2, xj),
           "row slice")
    # the whole stage chain is the planned bijection
    want = np.empty(t * LANE * LANE, np.float32)
    want[np.random.default_rng(10 + t).permutation(t * LANE * LANE)] = x.reshape(-1)
    np.testing.assert_array_equal(trc.apply_permutation(tp, xt).numpy().reshape(-1), want)


@pytest.mark.parametrize("name", ["fused_level", "power_law"])
def test_w3_r3_reduce_matches_jax(name):
    _, jm = _prepared(name)
    tm = _from_jax(jm)
    x = _x(tm.shape[1], seed=2)
    x5 = jroute.apply_sw_w2_sw(jm.perm_products, jr._gather_w1(jm, _xw(jm, x)))
    x5t = torch.from_numpy(np.array(x5))
    pp, jpp = tm.perm_products, jm.perm_products
    lvl = None
    if name == "fused_level":
        lp, jlp = tm.lvl_perms[0], jm.lvl_perms[0]
        lvl = (jlp.r1, jlp.wc, jlp.r3, jm.lvl_masks[0], jm.lvl_runs[0])
    res = jr._w3_r3_reduce(x5, jpp, jm.runs, w1_next=jm.perm_out.w1, lvl=lvl)
    # with fewer than 128 groups there is no full tile for W1'
    sums_j, sums_w1_j = res if isinstance(res, tuple) else (res, None)
    assert (sums_w1_j is None) == (name == "power_law")
    sums = trc.perm_reduce(x5t, tm.runs, pp.r3, trc.MODE_W3, W=pp.w3)
    n_g1 = sums.shape[0]
    _close(sums, np.asarray(sums_j)[:n_g1])
    if lvl is not None:
        # the fused level: a second launch over the first 128 sums rows
        lv = trc.perm_reduce(sums, tm.lvl_runs[0], lp.r3, trc.MODE_T1, W=lp.wc, r1=lp.r1,
                             mask=tm.lvl_masks[0], src_rows=min(n_g1, LANE))
        _close(lv, np.asarray(sums_j)[n_g1:])
    # W1' of the leading full tiles: kernel B over the same sums
    if sums_w1_j is not None:
        k = sums_w1_j.shape[0]
        _close(trc.apply_w_stage(tm.perm_out.w1[:k], sums[:k]), sums_w1_j)


def test_perm_reduce_t1_and_reduce_runs_fused_match_jax():
    _, jm = _prepared("split_level")
    tm = _from_jax(jm)
    lp, jlp = tm.lvl_perms[0], jm.lvl_perms[0]
    assert lp.t == 1
    rng = np.random.default_rng(4)
    prev = rng.standard_normal((LANE, LANE)).astype(np.float32)
    yj = jr._perm_reduce_t1(jnp.asarray(prev), jlp, jm.lvl_masks[0], jm.lvl_runs[0])
    yt = trc.perm_reduce(torch.from_numpy(prev), tm.lvl_runs[0], lp.r3, trc.MODE_T1, W=lp.wc,
                         r1=lp.r1, mask=tm.lvl_masks[0])
    _close(yt, yj)
    # _reduce_runs_fused: R3, mask, run sums over a slab (W3 off)
    slab = rng.standard_normal((tm.perm_products.h, LANE)).astype(np.float32)
    pp = tm.perm_products
    yj = jr._reduce_runs_fused(jnp.asarray(slab), jm.perm_products.r3, jm.runs)
    _close(trc.perm_reduce(torch.from_numpy(slab), tm.runs, pp.r3, trc.MODE_DIRECT), yj)
    yj = jr._reduce_runs_fused(jnp.asarray(prev), jlp.r3, jm.lvl_runs[0], mask=jm.lvl_masks[0])
    _close(trc.perm_reduce(torch.from_numpy(prev), tm.lvl_runs[0], lp.r3, trc.MODE_DIRECT,
                           mask=tm.lvl_masks[0]), yj)


@pytest.mark.parametrize("name", ["spiked_dense", "heavy_many"])
def test_hdense_mv_matches_jax(name):
    _, jm = _prepared(name)
    tm = _from_jax(jm)
    x = _x(tm.shape[1], seed=3)
    xt, xj = torch.as_tensor(x, dtype=torch.float32), jnp.asarray(x, jnp.float32)
    assert trc._hdense_in_kernel(tm.hdense) == (name == "spiked_dense")
    for placed in (False, True):
        _close(trc.hdense_mv(tm, xt, placed=placed), jr._hdense_mv(jm, xj, placed=placed))


def _stored_oracle(tcsr, chain, x):
    return serial_csr_spmv(trc.stored_csr(tcsr, chain), x)


@pytest.mark.parametrize("name", ["power_law", "random_uniform", "spiked_dense", "split_level",
                                  "fused_level", "heavy_many", "chunked"])
def test_routed_spmv_matches_jax_and_oracle(name):
    tcsr, _ = _csrs(name)
    tm, jm = _prepared(name)
    x = _x(tcsr.shape[1], seed=5)
    xj = jnp.asarray(x, jnp.float32)
    y_j = jr.routed_auto_spmv(jm, xj)
    chain = trc.build_chain(_from_jax(jm))
    y_t = trc.routed_chain_spmv(chain, torch.as_tensor(x, dtype=torch.float32))
    assert y_t.dtype == torch.float32 and y_t.shape == (tcsr.shape[0],)
    _close(y_t, y_j)
    o = _stored_oracle(tcsr, chain, x)
    assert np.abs(y_t.double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6
    # the port's own prepare gives the same operands, so the same y
    assert torch.equal(trc.routed_spmv(tm, torch.as_tensor(x, dtype=torch.float32)), y_t)


def test_bf16_routed_spmv_matches_jax_and_stored_oracle():
    tcsr, _ = _csrs("spiked_dense")
    tm, jm = _prepared("spiked_dense", bf16=True)
    x = _x(tcsr.shape[1], seed=6)
    chain = trc.build_chain(tm)
    y = trc.routed_chain_spmv(chain, torch.as_tensor(x, dtype=torch.float32))
    _close(y, jr.routed_spmv(jm, jnp.asarray(x, jnp.float32)))
    o = _stored_oracle(tcsr, chain, x)
    assert np.abs(y.double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6


def test_small_domain_chain_matches_the_fused_jax_kernel():
    tcsr, _ = _csrs("small")
    tm, jm = _prepared("small")
    assert tm.perm_products.t <= 4 and tm.out_t <= 4 and not tm.lvl_perms
    x = _x(tcsr.shape[1], seed=7)
    y_j = jr._routed_small_spmv(jm, _xw(jm, x))
    chain = trc.build_chain(tm)
    # the staged chain: A, B (SW.W2.SW^-1), C, then the output permutation
    assert chain.counts["gather"] == 1 and chain.counts["perm_reduce"] == 1
    y_t = trc.routed_chain_spmv(chain, torch.as_tensor(x, dtype=torch.float32))
    _close(y_t, np.asarray(y_j)[: tcsr.shape[0]])
    o = serial_csr_spmv(tcsr, x)
    assert np.abs(y_t.double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6


def test_chain_stages_and_counts():
    tm, _ = _prepared("fused_level")
    chain = trc.build_chain(tm)
    kinds = [type(s).__name__ for s in chain.stages]
    # one level of t = 1: a second reduce launch stands in for the fused level
    assert kinds == ["GatherStage", "WStage", "ReduceStage", "ReduceStage", "ZeroStage",
                     "WStage", "WStage", "WStage"]
    assert chain.counts["perm_reduce"] == 2 and chain.counts["hdense"] == 0
    assert chain.segments == ()  # encoded only for a CUDA device
    enc = trc._encode(chain.stages)
    assert len(enc) == 1 and enc[0].dtype == np.int64
    tm, _ = _prepared("heavy_many")
    enc = trc._encode(trc.build_chain(tm).stages)
    # the > 64-row heavy block's matmul splits the program in two
    assert len(enc) == 3 and isinstance(enc[1], trc.HDenseStage)


def test_program_encoding_matches_the_interpreter():
    # csrc/routed_spmv.cu reads each op as its code and a fixed number of
    # operands (kOpWords); the chain's program must parse with that table
    # into one op per stage, Buf operands tagged (1 scratch, 2 y)
    src = open(os.path.join(os.path.dirname(trc.__file__), "..", "csrc", "routed_spmv.cu")).read()
    words = [int(v) for v in re.search(r"kOpWords\[\] = \{([^}]*)\}", src).group(1).split(",")]
    tm, _ = _prepared("spiked_dense")
    chain = trc.build_chain(tm)
    assert chain.counts["hdense"] == 1
    (prog,) = trc._encode(chain.stages)
    ops, i = [], 0
    while i < len(prog):
        ops.append(int(prog[i]))
        i += words[int(prog[i])]
    assert i == len(prog)
    codes = {trc.GatherStage: 1, trc.WStage: 2, trc.ReduceStage: 3, trc.HDenseStage: 4,
             trc.ZeroStage: 5}
    assert ops == [codes[type(s)] for s in chain.stages]
    last = chain.stages[-1]
    assert last.out.kind == "y" and int(prog[-2]) >> 56 == 2  # the output permutation into y
    # a stage's program is the op its wrapper sends alone
    g = chain.stages[0]
    assert list(prog[: words[1]]) == trc._gather_op(g.vals, g.pidx, g.widx, g.w1, g.n_tiles, g.out)
    # operands read with vector loads must be aligned for them
    with pytest.raises(ValueError, match="aligned"):
        trc._hdense_op(torch.zeros(2, 2 * LANE + 4, dtype=torch.bfloat16)[:, 4:], None, None)


def test_chain_is_the_same_for_every_domain_size():
    # the JAX package sends h1 > 8192 through other TPU kernels (VMEM
    # limits); the port runs the same gather -> SW.W2.SW^-1 -> W3.R3.reduce
    # chain at t = 128 (index arrays all zero: geometry only)
    h = 128 * LANE
    zeros = torch.zeros(h, LANE, dtype=torch.int8)
    one = torch.zeros(LANE, LANE, dtype=torch.int8)
    mat = tr.RoutedCSR(
        vals=torch.zeros(LANE, LANE), pidx=one, widx=torch.zeros(1, dtype=torch.int32),
        perm_products=troute.PlannedPermutation(None, zeros, zeros, zeros, zeros, None, 128),
        lvl_perms=(), perm_out=troute.PlannedPermutation(None, one, one, one, one, one, 1),
        shape=(100, 100), nnz=0, n_windows=1, rows_a=LANE, runs=((0, 1, 1, 0),), out_t=1,
    )
    chain = trc.build_chain(mat)
    assert [type(s).__name__ for s in chain.stages] == [
        "GatherStage", "WStage", "ReduceStage", "ZeroStage", "WStage"]
    gather, w2, reduce_ = chain.stages[:3]
    assert gather.n_tiles == w2.n_tiles == w2.t == 128 and w2.sw and reduce_.mode == trc.MODE_W3


def test_routed_from_jax_checks_ranges():
    _, jm = _prepared("split_level")
    ok = _fields(jm)
    assert trc.routed_from_jax(**ok).vals.dtype == torch.float32
    bad = dict(ok, pidx=np.asarray(ok["pidx"]).copy())
    bad["pidx"][0, 0] = -1
    with pytest.raises(ValueError):
        trc.routed_from_jax(**bad)
    with pytest.raises(ValueError):
        trc.routed_from_jax(**dict(ok, widx=np.asarray(ok["widx"]) + ok["n_windows"]))
    w2 = np.asarray(jm.perm_products.w2).copy()
    w2[3, 3] = -5
    with pytest.raises(ValueError):
        trc.routed_from_jax(**dict(ok, perm_products=dict(
            {f: getattr(jm.perm_products, f) for f in PLAN_FIELDS}, w2=w2, t=jm.perm_products.t)))
    with pytest.raises(ValueError):
        trc.routed_from_jax(**dict(ok, runs=ok["runs"] + ((10**6, 1, 1, 10**6),)))
    with pytest.raises(ValueError):
        trc.routed_from_jax(**dict(ok, lvl_masks=(np.full((LANE, LANE), 2.0, np.float32),)))
    with pytest.raises(NotImplementedError, match="_heavy_sums"):
        trc.routed_from_jax(**dict(ok, hvals=np.zeros((LANE, LANE), np.float32)))


def test_wrapper_checks_on_the_cpu():
    tm, _ = _prepared("power_law")
    chain = trc.build_chain(tm)
    x = torch.as_tensor(_x(4000), dtype=torch.float32)
    with pytest.raises(TypeError):
        trc.routed_chain_spmv(chain, x.double())
    with pytest.raises(ValueError):
        trc.routed_chain_spmv(chain, x[:-1])
    with pytest.raises(ValueError):
        trc.routed_chain_spmv(chain, x.to("meta"))
    with pytest.raises(ValueError):
        trc.build_chain(dataclasses.replace(tm, vals=tm.vals[:-LANE]))
    with pytest.raises(TypeError):
        trc.build_chain(dataclasses.replace(tm, pidx=tm.pidx.int()))
    # the kernel launchers take CUDA tensors only: no plain fallback
    with pytest.raises(ValueError, match="CUDA"):
        trc.routed_gather_cuda(tm.vals, tm.pidx, tm.widx, None, 2, x, torch.zeros(2 * LANE * LANE))
    assert all(fn.launches == 0 for fn in trc._COUNTERS.values())


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["caida_like", "sg_rand_like", "webbase_like"])
def test_select_format_routed_at_published_size(name):
    tcsr = T.coo_to_csr(tsynth.preset(name))
    jcsr = J.CSRMatrix(shape=tcsr.shape, indptr=tcsr.indptr, indices=tcsr.indices, data=tcsr.data)
    assert tauto.select_format(tcsr) == jauto.select_format(jcsr) == "routed"


@pytest.mark.parametrize("mode", ["PL_CSR_ROUTED", "PL_CSR_ROUTED_BF16"])
def test_registered_modes_on_the_cpu(mode):
    tcsr, jcsr = _csrs("power_law")
    spec = registry.get(mode)
    assert spec.impl == "cuda"
    chain = spec.prepare(tcsr, None, T.Config(), torch.device("cpu"))
    jdt = jnp.bfloat16 if mode.endswith("BF16") else None
    _layout_equal(chain.mat, _prepared("power_law", bf16=jdt is not None)[1])
    x = fill_rnd_vector(tcsr.shape[1], seed=4)
    y = spec.jitted(chain)(torch.as_tensor(x, dtype=torch.float32))
    assert vectors_diff(y.double().numpy(), serial_csr_spmv(tcsr, x)).ok


def test_auto_spmv_routed_matches_jax():
    tcsr, jcsr = _csrs("power_law")
    tm = tauto.AutoSpMV.from_csr(tcsr, device="cpu")
    jm = jauto.AutoSpMV.from_csr(jcsr)
    assert tm.format == jm.format == "routed"
    _layout_equal(tm._operands.mat, jm._operands)
    x = _x(tcsr.shape[1], seed=8)
    y = tm(x)
    _close(y, jm(x))
    o = _stored_oracle(tcsr, tm._operands, x)
    assert np.abs(y.double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6


def test_auto_spmv_routed_refusal_names_binned(monkeypatch):
    tcsr, _ = _csrs("power_law")

    def refuse(*a, **k):
        raise tr.RoutedError("too large")

    monkeypatch.setattr(tauto, "prepare_routed_chain", refuse)
    # the JAX package's fallback: the binned engine takes the matrix
    model = tauto.AutoSpMV.from_csr(tcsr, device="cpu")
    assert model.format == "binned"
    x = _x(tcsr.shape[1], seed=8)
    o = serial_csr_spmv(tcsr, x)
    assert np.abs(model(x).double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6


@pytest.fixture
def power_law_mtx(tmp_path):
    path = str(tmp_path / "power_law.mtx")
    write_mtx(path, MATRICES["power_law"]())
    return path


@pytest.mark.parametrize("mode", ["AUTO", "PL_CSR_ROUTED_BF16"])
def test_cli_cpu_check_routed(power_law_mtx, mode, capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    rc = cli.main([power_law_mtx, "RNDVECT", mode, "--device", "cpu", "--check", "--no-dump"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "#check: OK" in out
    want = "PL_CSR_ROUTED" if mode == "AUTO" else mode
    line = [ln for ln in out.splitlines() if ln.startswith("computeMode:")][-1]
    assert line.startswith(f"computeMode:{want} elapsed:")
    if mode == "AUTO":
        assert "#auto: format=routed -> PL_CSR_ROUTED" in out


def test_cli_auto_falls_back_to_routed(tmp_path, capsys, monkeypatch):
    # the window cost scan accepts, the exact prepare refuses: AUTO falls
    # through to PL_CSR_ROUTED as the JAX package's CLI does
    from spmv_openmp_cuda_tpu_torch.formats import window as tw

    path = str(tmp_path / "m.mtx")
    write_mtx(path, tsynth.fem_like(m=6000, n=6000, nnz=120000, spread=500, lo=10, hi=28, seed=9))

    def refuse(*a, **k):
        raise tw.WindowError("padding above the cap")

    monkeypatch.setitem(registry._REGISTRY, "PL_CSR_WINDOW",
                        dataclasses.replace(registry.get("PL_CSR_WINDOW"), prepare=refuse))
    rc = cli.main([path, "RNDVECT", "AUTO", "--device", "cpu", "--check", "--no-dump"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "#auto: PL_CSR_WINDOW infeasible (padding above the cap); falling back to PL_CSR_ROUTED" in out
    assert "#check: OK" in out and "computeMode:PL_CSR_ROUTED " in out
    assert cli.main([path, "RNDVECT", "PL_CSR_WINDOW", "--device", "cpu", "--no-dump"]) == 1
