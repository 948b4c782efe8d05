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
from fractions import Fraction

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
from torch_numpy_path import numpy_path


@pytest.fixture(autouse=True, scope="module")
def _numpy_prepare():
    """The port's numpy prepare paths (see torch_numpy_path)."""
    with numpy_path():
        yield


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
                tr.prepare_routed_chunked(tcsr, vals_dtype=torch.bfloat16 if bf16 else None, device="cpu", **kw),
                jr.prepare_routed_chunked(jcsr, vals_dtype=jnp.bfloat16 if bf16 else None, **kw),
            )
        kw = PREPARE_KW.get(name, {})
        return (
            tr.prepare_routed(tcsr, vals_dtype=torch.bfloat16 if bf16 else None, device="cpu", **kw),
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


POOLED = ("hvals", "hpidx", "hwidx", "hreduce", "hlo", "hhi")


def _routed_equal(tm, jm):
    for f in ("vals", "pidx", "widx"):
        _equal(getattr(tm, f), getattr(jm, f), f)
    assert (tm.hdense is None) == (jm.hdense is None)
    if tm.hdense is not None:
        _equal(tm.hdense, jm.hdense, "hdense")
    for f in POOLED:
        a, b = getattr(tm, f), getattr(jm, f)
        assert (a is None) == (b is None), f
        if a is not None:
            # hreduce: the port keeps the 0/1 matrix on the host in f32
            _equal(a, b if f != "hreduce" else np.asarray(b, np.float32), f)
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
    _plan_equal(troute.plan_permutation(perm, t, device="cpu"), jroute.plan_permutation(perm, t), "plan")
    src_row = rng.permutation(np.repeat(np.arange(t * LANE), LANE))
    tp, tm = troute.plan_row_to_slot(src_row, perm, t, device="cpu")
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
    _layout_equal(tr.prepare_routed_auto(tcsr, device="cpu"), jr.prepare_routed_auto(jcsr))
    for r0, r1 in ((0, 700), (1200, 4000)):
        assert tr._predict_domain_rows(tcsr, r0, r1) == jr._predict_domain_rows(jcsr, r0, r1)
    assert tr._fit_chunk_bounds(tcsr, 500) == jr._fit_chunk_bounds(jcsr, 500)
    lens = np.diff(tcsr.indptr)
    assert tr._pick_heavy_threshold(tcsr, lens) == jr._pick_heavy_threshold(jcsr, lens)


def test_prepare_raises_what_the_port_lacks(monkeypatch):
    tcsr, jcsr = _csrs("heavy_many")
    # a dense heavy block over the cap takes the pooled tiles, as in the
    # JAX package: shrink both caps
    monkeypatch.setattr(tr, "_DENSE_HEAVY_MAX_BYTES", 1000)
    monkeypatch.setattr(jr, "_DENSE_HEAVY_MAX_BYTES", 1000)
    tm = tr.prepare_routed(tcsr, heavy_threshold=512, device="cpu")
    jm = jr.prepare_routed(jcsr, heavy_threshold=512)
    assert tm.hdense is None and tm.hvals is not None and len(tm.heavy_rows) == 70
    _routed_equal(tm, jm)
    x = _x(tcsr.shape[1], seed=9)
    _close(trc.routed_spmv(tm, torch.as_tensor(x, dtype=torch.float32)),
           jr.routed_spmv(jm, jnp.asarray(x, jnp.float32)))
    monkeypatch.undo()
    # a schema (the multi-device path's) too small for the chunk raises in both
    schema = dict(tr.merge_routed_schemas([tr.routed_schema_stats(tcsr)]), rows_a=128)
    with pytest.raises(tr.RoutedError, match="exceed schema"):
        tr.prepare_routed(tcsr, schema=schema, device="cpu")
    with pytest.raises(jr.RoutedError, match="exceed schema"):
        jr.prepare_routed(jcsr, schema=schema)
    with pytest.raises(NotImplementedError, match="float32"):
        tr.prepare_routed(tcsr, dtype=torch.float64, device="cpu")
    empty = T.CSRMatrix((5, 5), np.zeros(6, np.int64), np.zeros(0, np.int64), np.zeros(0))
    with pytest.raises(tr.RoutedError):
        tr.prepare_routed(empty, device="cpu")
    with pytest.raises(jr.RoutedError):
        jr.prepare_routed(J.CSRMatrix((5, 5), np.zeros(6, np.int64), np.zeros(0, np.int64), np.zeros(0)))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX Pallas kernels
# ---------------------------------------------------------------------------


def _from_jax(jm):
    if isinstance(jm, jr.RoutedChunks):
        return trc.routed_chunks_from_jax([_fields(c) for c in jm.chunks], jm.bounds, jm.shape, jm.nnz,
                                          device="cpu")
    return trc.routed_from_jax(**_fields(jm), device="cpu")


def _fields(jm):
    f = {k: getattr(jm, k) for k in (
        "vals", "pidx", "widx", "perm_products", "lvl_perms", "lvl_masks", "perm_out", "shape",
        "nnz", "n_windows", "rows_a", "runs", "lvl_runs", "out_t", "hdense", "heavy_rows",
        "widx_t", "heavy_lanes", *POOLED)}
    for k in ("vals", "pidx", "widx", "hdense", *POOLED):
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
    return troute.plan_permutation(perm, t, device="cpu"), jroute.plan_permutation(perm, t)


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


def _round_f32(v: Fraction) -> np.float32:
    """The f32 nearest the exact v, ties to even (an exact oracle)."""
    f = np.float32(float(v))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - v) for c in cands)
    near = [c for c in cands if abs(Fraction(float(c)) - v) == best]
    return min(near, key=lambda c: int(np.asarray(c).view(np.uint32)) & 1)


def test_fma_f32_rounds_once():
    # a * b + c rounded once, as a CUDA FMA: (2^30 + 1) * 2^-54 + 1 lies just
    # above the f32 midpoint 1 + 2^-24; rounding it to f64 first would land
    # on the midpoint and round to even (1.0)
    from spmv_openmp_cuda_tpu_torch.ops.dfloat import fma_f32

    a = torch.tensor([1047553 * 2.0 ** -30, 205.0])
    b = torch.tensor([1025 * 2.0 ** -24, 5237765 * 2.0 ** -54])
    one = torch.ones(2)
    assert fma_f32(a, b, one).tolist() == [1 + 2.0 ** -23] * 2
    assert (a.double() * b.double() + 1).float().tolist() == [1.0, 1.0]
    rng = np.random.default_rng(9)
    a = (rng.standard_normal(2000) * 2.0 ** rng.integers(-30, 30, 2000)).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * 2.0 ** rng.integers(-40, 10, 2000)).astype(np.float32)
    a.view(np.uint32)[:500] &= 0xFFFF0000  # bf16 values, as kernel D's H
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = [_round_f32(Fraction(float(p)) * Fraction(float(q)) + Fraction(float(r)))
            for p, q, r in zip(a, b, c)]
    assert np.array_equal(got.view(np.uint32), np.asarray(want, np.float32).view(np.uint32))


def _np_fma(a, b, c):
    """f32 a * b + c rounded once: the f64 sum rounded to odd, then to f32."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    return np.where((e != 0) & even, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)),
                    s).astype(np.float32)


def _np_tree(v):
    """A warp's shuffle tree over the last axis of 32 lanes (lane 0's sum)."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def _np_hdense(h: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Kernel D on numpy float32, one CTA of 256 threads per (heavy row,
    chunk of 4096 columns) and then the close: thread t's products at
    columns chunk*4096 + (it*256 + t)*8 + u fused into its sum from +0 (a
    group of 8 at or past n_pad skipped, x zero past n), the warp trees,
    the tree of the 8 warp sums; per row, the chunk sums dealt to 32 lanes
    in turn from +0, then the tree."""
    n_h, n_pad = h.shape
    n = x.shape[0]
    n_cta = -(-n_pad // 4096)
    part = np.zeros((n_h, n_cta), np.float32)
    t = np.arange(256)
    for k in range(n_h):
        for b in range(n_cta):
            acc = np.zeros(256, np.float32)
            for it in range(2):
                c0 = b * 4096 + (it * 256 + t) * 8
                inside = c0 < n_pad
                for u in range(8):
                    c = c0 + u
                    hv = np.where(inside, h[k, np.minimum(c, n_pad - 1)], np.float32(0))
                    xv = np.where(c < n, x[np.minimum(c, n - 1)], np.float32(0))
                    acc = np.where(inside, _np_fma(hv, xv, acc), acc)
            warps = _np_tree(acc.reshape(8, 32))
            part[k, b] = _np_tree(np.concatenate([warps, np.zeros(24, np.float32)]))
    y = np.zeros(n_h, np.float32)
    for k in range(n_h):
        lanes = np.zeros(32, np.float32)
        for i in range(n_cta):
            lanes[i % 32] += part[k, i]
        y[k] = _np_tree(lanes)
    return y


def _bf16_block(n_h, n, seed):
    n_pad = -(-n // LANE) * LANE
    rng = np.random.default_rng(seed)
    h = torch.as_tensor(rng.standard_normal((n_h, n_pad)), dtype=torch.float32)
    h[:, n:] = 0
    h[:, rng.random(n_pad) < 0.5] = 0  # sparse columns, as a heavy row's
    return h.to(torch.bfloat16)


@pytest.mark.parametrize("n_h, n", [(1, 30000), (8, 9000), (3, 150000)])
def test_hdense_in_order_matches_a_cta_emulation(n_h, n):
    # one chunk short of n_pad, a few, and more chunks than lanes (37)
    hd = _bf16_block(n_h, n, seed=n_h)
    x = _x(n, seed=2).astype(np.float32)
    y = trc.hdense_in_order(hd, torch.from_numpy(x))
    want = _np_hdense(hd.float().numpy(), x)
    assert y.dtype == torch.float32 and y.shape == (n_h,)
    assert np.array_equal(y.numpy().view(np.uint32), want.view(np.uint32))
    yr = trc.hdense_reference(hd, torch.from_numpy(x)).numpy()
    assert np.abs(y.numpy() - yr).max() <= 1e-5 * np.abs(yr).max() + 1e-6


def test_hdense_in_order_matches_jax():
    _, jm = _prepared("spiked_dense")
    tm = _from_jax(jm)
    x = _x(tm.shape[1], seed=3)
    y = trc.hdense_in_order(tm.hdense, torch.as_tensor(x, dtype=torch.float32)).double().numpy()
    y_j = np.asarray(jr._hdense_mv(jm, jnp.asarray(x, jnp.float32)), np.float64)
    y_r = trc.hdense_reference(tm.hdense, torch.as_tensor(x, dtype=torch.float32)).double().numpy()
    for ref in (y_j, y_r):
        assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max() + 1e-6


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
    # one launch of the small kernel; its plain version is the staged chain
    assert [type(s).__name__ for s in chain.stages] == ["SmallStage"]
    assert chain.counts["small"] == 1 and sum(chain.counts.values()) == 1
    staged = trc.build_chain(tm, fuse_small=False)
    assert staged.counts["gather"] == 1 and staged.counts["perm_reduce"] == 1
    y_t = trc.routed_chain_spmv(chain, torch.as_tensor(x, dtype=torch.float32))
    assert torch.equal(y_t, trc.routed_chain_spmv(staged, torch.as_tensor(x, dtype=torch.float32)))
    _close(y_t, np.asarray(y_j)[: tcsr.shape[0]])
    o = serial_csr_spmv(tcsr, x)
    assert np.abs(y_t.double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6


def test_chain_stages_and_counts():
    tm, _ = _prepared("fused_level")
    chain = trc.build_chain(tm)
    kinds = [type(s).__name__ for s in chain.stages]
    # one level of t = 1: a second reduce launch stands in for the fused
    # level; the products domain's W stages are composed into the first
    # reduce's offsets, the three-stage output permutation (out_t 2) into
    # one gather
    assert tm.out_t == 2
    assert kinds == ["GatherStage", "ReduceStage", "ReduceStage", "ZeroStage", "PermuteStage"]
    assert chain.counts == {"gather": 1, "permute": 1, "perm_reduce": 2, "hdense": 0, "heavy": 0,
                            "small": 0}
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
    codes = {trc.GatherStage: 1, trc.PermuteStage: 2, trc.ReduceStage: 3, trc.HDenseStage: 4,
             trc.ZeroStage: 5, trc.HeavyStage: 6, trc.SmallStage: 7}
    assert ops == [codes[type(s)] for s in chain.stages]
    last = chain.stages[-1]
    # the output permutation into y: src, map, n = m, out (tag 2)
    assert last.out.kind == "y" and int(prog[-1]) >> 56 == 2 and int(prog[-2]) == tm.shape[0]
    assert int(prog[-3]) == last.imap.idx.data_ptr() and last.imap.idx.dtype == torch.int32
    # D's op: H, n_h, n_pad, target, out, its sums and its ticket, both in
    # the scratch (tag 1), the sums after the ticket; the ticket is the word
    # after the assembly domain, which the memset before D zeroes with it
    d = next(s for s in chain.stages if isinstance(s, trc.HDenseStage))
    z = next(s for s in chain.stages if isinstance(s, trc.ZeroStage))
    dop = trc._hdense_op(d.hdense, d.target, d.out, d.part)
    assert words[4] == len(dop) == 8 and dop in [list(prog[j:j + 8]) for j in range(len(prog))]
    sums, ticket = dop[-2], dop[-1]
    assert ticket >> 56 == 1 and sums == ticket + 4
    off = (1 << 56) - 1
    assert z.out == d.out and (z.out.off + z.n) * 4 == (ticket & off) + 4
    assert chain.scratch_elems * 4 >= (sums & off) + 4 * (trc._hdense_part_elems(tm.hdense) - 1)
    # a stage's program is the op its wrapper sends alone
    g = chain.stages[0]
    assert list(prog[: words[1]]) == trc._gather_op(g.vals, g.pidx, g.widx, g.w1, g.n_tiles, g.out)
    # operands read with vector loads must be aligned for them
    with pytest.raises(ValueError, match="aligned"):
        trc._hdense_op(torch.zeros(2, 2 * LANE + 4, dtype=torch.bfloat16)[:, 4:], None, None, None)
    # A reads its tiles (vals, pidx, W1 rows) with 16-byte loads
    off8 = torch.zeros(LANE * LANE + 1, dtype=torch.int8)[1:].reshape(LANE, LANE)
    off32 = torch.zeros(LANE * LANE + 1)[1:].reshape(LANE, LANE)
    for i, bad in ((0, off32), (1, off8), (3, off8)):
        a = [g.vals, g.pidx, g.widx, g.w1]
        a[i] = bad
        with pytest.raises(ValueError, match="aligned"):
            trc._gather_op(*a, g.n_tiles, g.out)
    with pytest.MonkeyPatch.context() as mp:  # the heavy row in pooled tiles
        mp.setattr(tr, "_dense_heavy_ok", lambda *a: False)
        pchain = trc.build_chain(tr.prepare_routed(_csrs("spiked_dense")[0], device="cpu"))
    (pprog,) = trc._encode(pchain.stages)
    h = pchain.stages[-1]
    assert isinstance(h, trc.HeavyStage) and int(pprog[-words[6]]) == 6
    op = trc._heavy_op(h.hvals, h.hpidx, h.hwidx, h.hlo, h.hhi, h.slot_ptr, h.slot_idx, h.rows,
                       h.part, h.out)
    assert len(op) == words[6] and list(pprog[-words[6]:]) == op
    part = op[12]
    assert part >> 56 == 1 and (part & ((1 << 56) - 1)) % 16 == 0
    assert pchain.scratch_elems >= h.part.off + trc.heavy_part_elems(h.hvals)
    assert trc.heavy_part_elems(h.hvals) == 4 * h.hvals.shape[0]
    with pytest.raises(ValueError, match="aligned"):
        trc._heavy_op(h.hvals, h.hpidx, h.hwidx, off8, h.hhi, h.slot_ptr, h.slot_idx, h.rows,
                      h.part, h.out)


def test_chain_is_the_same_for_every_domain_size():
    # the JAX package sends h1 > 8192 through other TPU kernels (VMEM
    # limits); the port runs the same gather -> (SW.W2.SW^-1, W3, R3
    # composed) reduce chain at t = 128 (index arrays all zero: geometry
    # only)
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
        "GatherStage", "ReduceStage", "ZeroStage", "PermuteStage"]
    gather, reduce_ = chain.stages[:2]
    steps = reduce_.imap.steps
    assert gather.n_tiles == steps.t == 128 and steps.h == h and reduce_.src == gather.out
    assert [(st.sw, st.w is mat.perm_products.w2 or st.w is mat.perm_products.w3) for st in
            steps.steps] == [(True, True), (False, True)]
    # one slab row read (the run's), one real gather tile: the rest read -1
    assert reduce_.imap.idx.shape == (1, LANE) and steps.src_rows == LANE
    assert int(reduce_.imap.idx.max()) < LANE * LANE


# ---------------------------------------------------------------------------
# the composed index maps against the staged W stages
# ---------------------------------------------------------------------------


def _synthetic_levels(seed=11):
    """A hand-made domain (random plans and masks: geometry, not a matrix)
    with two levels: t = 2 read from 142 rows of sums (below its 256-row
    slab) and t = 1 read from 51 rows, both masked; two of the products
    domain's four tiles are pad tiles, and the output permutation has two
    tiles."""
    rng = np.random.default_rng(seed)

    def row_to_slot(t):
        src_row = rng.permutation(np.repeat(np.arange(t * LANE), LANE))
        return troute.plan_row_to_slot(src_row, rng.permutation(t * LANE * LANE), t, device="cpu")[0]

    def mask(t):
        return torch.from_numpy((rng.random((t * LANE, LANE)) < 0.7).astype(np.float32))

    rows_a = 2 * LANE
    return tr.RoutedCSR(
        vals=torch.from_numpy(rng.standard_normal((rows_a, LANE)).astype(np.float32)),
        pidx=torch.from_numpy(rng.integers(0, LANE, (rows_a, LANE)).astype(np.int8)),
        widx=torch.from_numpy(rng.integers(0, 2, rows_a // LANE).astype(np.int32)),
        perm_products=row_to_slot(4),
        lvl_perms=tuple(troute.plan_permutation(rng.permutation(t * LANE * LANE), t, device="cpu")
                        for t in (2, 1)),
        lvl_masks=(mask(2), mask(1)), perm_out=row_to_slot(2), shape=(30000, 20000), nnz=0,
        n_windows=2, rows_a=rows_a, runs=((0, 2, 128, 0), (256, 140, 1, 2)),
        lvl_runs=(((0, 1, 100, 0), (100, 50, 2, 1)), ((0, 2, 60, 0),)), out_t=2,
    )


def _staged_plan(plan, src, src_rows, from_w1=False):
    """The W stages of a whole plan (or, from_w1, of SW.W2.SW^-1, W3 and
    R3) one by one with w_stage_reference, as the chain ran them before
    they were composed."""
    t, h = plan.t, plan.h
    if plan.t == 1 and plan.wc is not None and not from_w1:
        return trc.w_stage_reference(src, src_rows, plan.r1, plan.wc, plan.r3, 1, False, 1)
    if not from_w1:
        src, src_rows = trc.w_stage_reference(src, src_rows, plan.r1, plan.w1, None, t, False, t), h
    a = trc.w_stage_reference(src, src_rows, None, plan.w2, None, t, True, t)
    return trc.w_stage_reference(a, h, None, plan.w3, plan.r3, t, False, t)


@pytest.mark.parametrize("name", ["synthetic", "power_law", "spiked_dense", "fused_level", "small",
                                  "chunked"])
def test_composed_maps_give_the_staged_chain_bit_for_bit(name):
    """Each C and B stage's plain version (a read through its composed
    offsets) against the staged plain chain on the same buffers: A's
    products through SW.W2.SW^-1 and W3.R3 (pad tiles), each level's W
    stages from its rows of sums (src_rows below the slab, t = 1 and t > 1,
    masked), the output permutation's W stages; chunk after chunk."""
    mat = _synthetic_levels() if name == "synthetic" else _prepared(name)[0]
    chain = trc.build_chain(mat, fuse_small=False)
    domains = iter(mat.chunks if isinstance(mat, tr.RoutedChunks) else (mat,))
    x = torch.as_tensor(_x(mat.shape[1], seed=12), dtype=torch.float32)
    bufs = trc._buffers(chain, x)
    bufs["s"].fill_(float("nan"))
    seen = []
    for stage in chain.stages:
        if isinstance(stage, trc.GatherStage):
            d, level = next(domains), 0
            groups = [trc._n_groups(r) for r in (d.runs, *d.lvl_runs)]
        want = None
        if isinstance(stage, (trc.ReduceStage, trc.PermuteStage)):
            src = bufs[stage.src.kind][stage.src.off :].reshape(-1, LANE)
        if isinstance(stage, trc.ReduceStage):
            if level == 0:
                g = _staged_plan(d.perm_products, src, d.perm_products.h, from_w1=True)
                runs = d.runs
            else:
                perm, runs = d.lvl_perms[level - 1], d.lvl_runs[level - 1]
                g = _staged_plan(perm, src, min(groups[level - 1], perm.h)) * d.lvl_masks[level - 1]
                seen.append((perm.t, min(groups[level - 1], perm.h) < perm.h))
            want = trc._reduce_runs(g, runs).reshape(-1)
            level += 1
        elif isinstance(stage, trc.PermuteStage):
            want = _staged_plan(d.perm_out, src, d.perm_out.h).reshape(-1)[: d.shape[0]]
        trc.run_stage(stage, bufs, plain=True)
        if want is not None:
            got = trc._view(bufs, stage.out, stage.out_elems())
            assert torch.equal(got, want), (name, type(stage).__name__, level)
            # the chain's own staged reference (chip_smoke.py's check) agrees
            if isinstance(stage, trc.PermuteStage):
                assert torch.equal(trc.staged_stage(stage, bufs), want)
    if name == "synthetic":
        # a t = 2 and a t = 1 level, each read from fewer rows than its slab
        assert seen == [(2, True), (1, True)]
        assert not torch.isnan(bufs["y"]).any()
    assert torch.equal(bufs["y"], trc.routed_spmv_reference(chain, x))


@pytest.mark.parametrize("rows", [0, 32, 128])
def test_reduce_chunks_tile_the_groups(rows, monkeypatch):
    """Kernel C's CTAs: consecutive groups whose rows tile the chunk's rows
    in order, within _CHUNK_ROWS rows (a wider group alone) and 128 groups;
    wide groups first, as the groups come."""
    monkeypatch.setattr(trc, "_CHUNK_ROWS", rows)
    runs = ((0, 3, 128, 0), (384, 2, 40, 3), (464, 300, 1, 5), (764, 10, 7, 305))
    ch = trc.reduce_chunks(runs, "cpu").numpy()
    tab = trc.groups_table(runs, "cpu").numpy()
    assert ch.dtype == np.int32 and ch.shape[1] == 4
    assert ch[0, 2] == 0 and ch[-1, 3] == tab.shape[0] and (ch[1:, 2] == ch[:-1, 3]).all()
    for row0, row1, g0, g1 in ch:
        assert row0 == tab[g0, 0] and row1 == tab[g1 - 1].sum()
        assert (tab[g0 + 1 : g1, 0] == tab[g0 : g1 - 1].sum(1)).all()  # rows in order, no gap
        assert g1 - g0 <= 128 and (g1 - g0 == 1 or row1 - row0 <= rows)
    if rows == 0:
        assert ch.shape[0] == tab.shape[0]
    if rows == 32:
        # the 128- and 40-row groups alone, the one-row groups 32 at a time
        assert list(ch[:5, 3] - ch[:5, 2]) == [1, 1, 1, 1, 1] and ch[5, 3] - ch[5, 2] == 32
    # a gap between groups closes a chunk
    monkeypatch.setattr(trc, "_CHUNK_ROWS", 32)
    gap = trc.reduce_chunks(((0, 2, 1, 0), (5, 2, 1, 2)), "cpu").numpy()
    assert gap.tolist() == [[0, 2, 0, 2], [5, 7, 2, 4]]


def test_maps_compose_on_integer_ids():
    # ids past 2**24, where float32 ids round, come through the planned
    # bijection exactly: the composition runs on int64
    t = 4
    n = t * LANE * LANE
    perm = np.random.default_rng(5).permutation(n)
    plan = troute.plan_permutation(perm, t, device="cpu")
    base = 2**24 + 1
    ids = torch.arange(n, dtype=torch.int64).reshape(-1, LANE) + base
    want = np.empty(n, np.int64)
    want[perm] = np.arange(n) + base
    steps = trc.plan_steps(plan)
    np.testing.assert_array_equal(steps.apply(ids).reshape(-1).numpy(), want)
    rounded = steps.apply(ids.to(torch.float32)).reshape(-1).to(torch.int64).numpy()
    assert not np.array_equal(rounded, want)
    # the map of the whole plan: int32 offsets, cached once per form
    imap = trc.plan_map(plan)
    assert imap.idx.dtype == torch.int32 and imap.span == n and trc.plan_map(plan) is imap
    np.testing.assert_array_equal(imap.idx.reshape(-1).numpy(), want - base)
    assert trc.plan_map(plan, skip_r3=True) is not imap and len(plan.maps) == 2
    assert not dataclasses.replace(plan, r3=plan.r3.clone()).maps  # a new plan: a new cache
    # rows past src_rows read as -1 (zero)
    short = trc.plan_map(plan, src_rows=LANE)
    assert set(short.idx[short.idx >= 0].tolist()) == set(range(LANE * LANE))
    assert int((short.idx < 0).sum()) == n - LANE * LANE
    with pytest.raises(ValueError, match="int32"):
        trc._int32_offsets(torch.tensor([2**31], dtype=torch.int64))


@pytest.mark.parametrize("t", [2, 8])
def test_composed_gather_matches_jax(t):
    """Every form the port applies a planned permutation in, one gather
    through its composed map (plain version), against the JAX package's
    route.apply_*; a source shorter than the domain reads as zero."""
    tp, jp = _random_plan(t, seed=20 + t)
    x = np.random.default_rng(t).standard_normal((t * LANE, LANE)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for form, tfn, jfn in (("sw_w2_sw", trc.apply_sw_w2_sw, jroute.apply_sw_w2_sw),
                           ("to_mid", trc.apply_permutation_to_mid, jroute.apply_permutation_to_mid)):
        _equal(trc.permute(xt, trc.plan_map(tp, form)).reshape(t * LANE, LANE), jfn(jp, xj), form)
        _equal(tfn(tp, xt), jfn(jp, xj), form)
    for skip in (False, True):
        for form, tfn, jfn in (("from_w1", trc.apply_permutation_from_w1,
                                jroute.apply_permutation_from_w1),
                               ("whole", trc.apply_permutation, jroute.apply_permutation)):
            _equal(tfn(tp, xt, skip), jfn(jp, xj, skip), f"{form} skip_r3={skip}")
    k = LANE + 3
    xs = np.zeros_like(x)
    xs[:k] = x[:k]
    _equal(trc.apply_permutation(tp, xt[:k]), jroute.apply_permutation(jp, jnp.asarray(xs)), "short")


@pytest.mark.parametrize("case", ["w", "r, w", "w, ra", "sw", "src_rows"])
def test_one_stage_map_is_the_w_stage(case):
    """The map kernel B takes for a single W stage on the card (w_stage on a
    CUDA tensor), run through its plain version: the plain W stage."""
    t = 4
    tp, _ = _random_plan(t, seed=30)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((t * LANE, LANE)).astype(np.float32))
    kw = {"w": dict(w=tp.w1), "r, w": dict(w=tp.w1, r=tp.r1), "w, ra": dict(w=tp.w3, ra=tp.r3),
          "sw": dict(w=tp.w2, sw=True), "src_rows": dict(w=tp.w3, ra=tp.r3)}[case]
    src_rows = 2 * LANE + 5 if case == "src_rows" else t * LANE
    step = trc.WStep(kw["w"], r=kw.get("r"), ra=kw.get("ra"), sw=kw.get("sw", False))
    imap = trc.index_map(trc.Steps((step,), t, t * LANE, src_rows), x.device)
    want = trc.w_stage(x, t=t, src_rows=src_rows, **kw)
    assert torch.equal(trc.permute(x, imap).reshape(t * LANE, LANE), want)
    assert torch.equal(want, trc.w_stage_reference(x, src_rows, kw.get("r"), kw["w"], kw.get("ra"),
                                                   t, kw.get("sw", False), t))


def test_routed_from_jax_checks_ranges():
    _, jm = _prepared("split_level")
    ok = _fields(jm)
    assert trc.routed_from_jax(device="cpu", **ok).vals.dtype == torch.float32
    bad = dict(ok, pidx=np.asarray(ok["pidx"]).copy())
    bad["pidx"][0, 0] = -1
    with pytest.raises(ValueError):
        trc.routed_from_jax(device="cpu", **bad)
    with pytest.raises(ValueError):
        trc.routed_from_jax(**dict(ok, widx=np.asarray(ok["widx"]) + ok["n_windows"]), device="cpu")
    w2 = np.asarray(jm.perm_products.w2).copy()
    w2[3, 3] = -5
    with pytest.raises(ValueError):
        trc.routed_from_jax(**dict(ok, perm_products=dict(
            {f: getattr(jm.perm_products, f) for f in PLAN_FIELDS}, w2=w2, t=jm.perm_products.t)), device="cpu")
    with pytest.raises(ValueError):
        trc.routed_from_jax(**dict(ok, runs=ok["runs"] + ((10**6, 1, 1, 10**6),)), device="cpu")
    with pytest.raises(ValueError):
        trc.routed_from_jax(**dict(ok, lvl_masks=(np.full((LANE, LANE), 2.0, np.float32),)), device="cpu")
    # pooled heavy tiles without hlo/hhi: the JAX package's legacy layout
    with pytest.raises(ValueError, match="do-not-port"):
        trc.routed_from_jax(**dict(ok, hvals=np.zeros((LANE, LANE), np.float32)), device="cpu")


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
