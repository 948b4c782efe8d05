"""Pooled heavy rows and small routed domains of the PyTorch port against the
JAX package, on the CPU.

Pooled heavy tiles (the JAX package's _build_heavy, read by its _heavy_sums
kernel; the port's kernel E) must be array-equal to the JAX layout (bf16 bit
for bit), and the plain version of kernel E (`heavy_sums_reference`) must
agree with the Pallas kernel in interpret mode. Small domains (the JAX
`small_ok` test) must plan the one-launch small kernel exactly where the JAX
package takes `_routed_small_spmv`, and its plain version must equal the
staged chain's.

Tolerances: layouts and data movement are exact. Sums are f32 sums of the
same terms in another order (the JAX kernel differences a lane cumsum):
|y_t - y_j| <= 1e-5*|y_j| + 1e-6*max|y_j| on x ~ N(0, 1). Against the f64
oracle of the matrix as stored: 1e-5*max|y| + 1e-6."""
import ctypes
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
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch import cli
from spmv_openmp_cuda_tpu_torch.io.mmio import write_mtx
from spmv_openmp_cuda_tpu_torch.ops import registry  # noqa: F401  (imports the ops in order)
from spmv_openmp_cuda_tpu_torch.formats import routed as tr
from spmv_openmp_cuda_tpu_torch.models import auto as tauto
from spmv_openmp_cuda_tpu_torch.ops import lanes_cuda as tlc
from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc
from spmv_openmp_cuda_tpu_torch.ops import window_cuda as twc
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from torch_numpy_path import numpy_path


@pytest.fixture(autouse=True, scope="module")
def _numpy_prepare():
    """The port's numpy prepare paths (see torch_numpy_path)."""
    with numpy_path():
        yield


LANE = 128
POOLED = ("hvals", "hpidx", "hwidx", "hreduce", "hlo", "hhi")


def _heavy_rows_matrix(m, n, n_heavy, per_row, bg_nnz, seed, vals="uniform"):
    """n_heavy rows of per_row distinct columns each, then bg_nnz scattered
    entries in the other rows (tests/test_routed.py's pooled matrices)."""
    rng = np.random.default_rng(seed)
    rows = [np.full(per_row, r) for r in range(n_heavy)] + [rng.integers(n_heavy, m, bg_nnz)]
    cols = [rng.choice(n, size=per_row, replace=False) for _ in range(n_heavy)] + \
        [rng.integers(0, n, bg_nnz)]
    rows, cols = np.unique(np.stack([np.concatenate(rows), np.concatenate(cols)]), axis=1)
    v = rng.uniform(-3e-5, 3e-5, rows.shape[0]) if vals == "uniform" else \
        rng.standard_normal(rows.shape[0])
    return T.COOMatrix((m, n), rows, cols, v)


#: case -> (matrix, heavy_threshold, force the pooled tiles)
CASES = {
    # tests/test_routed.py::test_routed_heavy_pooled_multi_row: 10 rows
    # share tiles, row-slot runs span tile boundaries
    "pool10": (lambda: _heavy_rows_matrix(2000, 40000, 10, 5000, 8000, 11), 4096, True),
    # tests/test_routed.py::test_routed_heavy_pool_cap_split: 106 rows, two
    # pools of at most 96
    "pool_cap": (lambda: _heavy_rows_matrix(156, 20000, 106, 600, 2000, 21), 512, True),
    # pooled with no patching: 40 heavy rows of 200,000 columns would take a
    # 16 MB dense block, over the 12 MB cap
    "natural": (lambda: _heavy_rows_matrix(3000, 200000, 40, 17000, 12000, 1, vals="normal"),
                None, False),
}

_MEMO = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _csrs(case):
    def make():
        t = T.coo_to_csr(CASES[case][0]())
        return t, J.CSRMatrix(shape=t.shape, indptr=t.indptr, indices=t.indices, data=t.data)

    return _memo(("csr", case), make)


def _prepared(case, bf16=False):
    """(port layout, JAX layout) of a case, prepared once per module."""
    def make():
        tcsr, jcsr = _csrs(case)
        _, thr, force = CASES[case]
        with pytest.MonkeyPatch.context() as mp:
            if force:  # SPMV_DENSE_HEAVY=0 for JAX, no dense block in the port
                mp.setenv("SPMV_DENSE_HEAVY", "0")
                mp.setattr(tr, "_dense_heavy_ok", lambda *a: False)
            return (
                tr.prepare_routed(tcsr, heavy_threshold=thr,
                                  vals_dtype=torch.bfloat16 if bf16 else None, device="cpu"),
                jr.prepare_routed(jcsr, heavy_threshold=thr,
                                  vals_dtype=jnp.bfloat16 if bf16 else None),
            )

    return _memo(("prep", case, bf16), make)


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


def _pooled_equal(tm, jm):
    assert tm.hdense is None and jm.hdense is None and tm.hvals is not None
    assert tm.heavy_rows == jm.heavy_rows and tm.heavy_lanes == jm.heavy_lanes == ()
    for f in POOLED:
        j = getattr(jm, f)
        _equal(getattr(tm, f), np.asarray(j, np.float32) if f == "hreduce" else j, f)
    for f in ("vals", "pidx", "widx"):
        _equal(getattr(tm, f), getattr(jm, f), f)
    for f in ("shape", "nnz", "n_windows", "rows_a", "runs", "lvl_runs", "out_t", "widx_t"):
        assert getattr(tm, f) == getattr(jm, f), f


def _fields(jm):
    f = {k: getattr(jm, k) for k in (
        "vals", "pidx", "widx", "perm_products", "lvl_perms", "lvl_masks", "perm_out", "shape",
        "nnz", "n_windows", "rows_a", "runs", "lvl_runs", "out_t", "hdense", "heavy_rows",
        "widx_t", "heavy_lanes", *POOLED)}
    for k in ("vals", "pidx", "widx", "hdense", *POOLED):
        f[k] = None if f[k] is None else np.asarray(f[k])
    return f


def _stored_oracle(tcsr, chain, x):
    return serial_csr_spmv(trc.stored_csr(tcsr, chain), x)


# ---------------------------------------------------------------------------
# pooled heavy tiles: layout, kernel E's plain version, whole products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_build_heavy_array_equal(case):
    tcsr, jcsr = _csrs(case)
    _, jm = _prepared(case)
    rows_h = np.asarray(jm.heavy_rows, np.int64)
    for name, a, b in zip(POOLED, tr._build_heavy(rows_h, tcsr), jr._build_heavy(rows_h, jcsr)):
        _equal(a, b, name)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_pooled_prepare_array_equal(case, bf16):
    tm, jm = _prepared(case, bf16)
    _pooled_equal(tm, jm)
    assert tm.hvals.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert tm.hlo.dtype == tm.hhi.dtype == tm.hpidx.dtype == torch.int8
    assert isinstance(tm.hreduce, np.ndarray)  # host only: the chain reads its slot map
    if case == "pool_cap":
        assert len(tm.heavy_rows) == 106 and np.asarray(tm.hreduce).shape[0] == 106


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_heavy_sums_reference_matches_jax(case, bf16):
    tm, jm = _prepared(case, bf16)
    x = _x(tm.shape[1], seed=2)
    slot_ptr, slot_idx = trc.heavy_slot_map(tm.hreduce, "cpu")
    y_t = trc.heavy_sums_reference(tm.hvals, tm.hpidx, tm.hwidx, tm.hlo, tm.hhi, slot_ptr,
                                   slot_idx, torch.as_tensor(x, dtype=torch.float32))
    y_j = jr._heavy_sums(jm, jr._pack_xw(jm, jnp.asarray(x, jnp.float32)))
    assert y_t.shape == (len(tm.heavy_rows),)
    _close(y_t, y_j)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_pooled_routed_spmv_matches_jax_and_oracle(case, bf16):
    tcsr, _ = _csrs(case)
    tm, jm = _prepared(case, bf16)
    chain = trc.build_chain(tm)
    assert isinstance(chain.stages[-1], trc.HeavyStage) and chain.counts["heavy"] == 1
    assert chain.counts["hdense"] == 0 and chain.counts["small"] == 0
    x = _x(tcsr.shape[1], seed=5)
    y = trc.routed_chain_spmv(chain, torch.as_tensor(x, dtype=torch.float32))
    assert y.dtype == torch.float32 and y.shape == (tcsr.shape[0],)
    _close(y, jr.routed_spmv(jm, jnp.asarray(x, jnp.float32)))
    o = _stored_oracle(tcsr, chain, x)
    assert np.abs(y.double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6
    # the program parses with the interpreter's table, E's op last
    src = open(os.path.join(os.path.dirname(trc.__file__), "..", "csrc", "routed_spmv.cu")).read()
    words = [int(v) for v in re.search(r"kOpWords\[\] = \{([^}]*)\}", src).group(1).split(",")]
    # D's op as the encoder writes it: H n_h n_pad target out, its sums and ticket
    d_op = trc._hdense_op(torch.zeros(1, 128, dtype=torch.bfloat16), None, None, trc.Buf("s"))
    assert words[trc._OP_HDENSE] == len(d_op) == 8 and d_op[-2] == d_op[-1] + 4
    (prog,) = trc._encode(chain.stages)
    ops, i = [], 0
    while i < len(prog):
        ops.append(int(prog[i]))
        i += words[int(prog[i])]
    assert i == len(prog) and ops[-1] == 6 and int(prog[-1]) >> 56 == 2  # E adds into y


@pytest.mark.parametrize("bf16", [False, True])
def test_routed_from_jax_pooled_round_trip(bf16):
    tcsr, _ = _csrs("pool10")
    tm, jm = _prepared("pool10", bf16)
    mat = trc.routed_from_jax(**_fields(jm), device="cpu")
    _pooled_equal(mat, jm)
    x = torch.as_tensor(_x(tcsr.shape[1], seed=6), dtype=torch.float32)
    # the port's own prepare gives the same operands, so the same y
    assert torch.equal(trc.routed_spmv(mat, x), trc.routed_spmv(tm, x))


def test_routed_from_jax_checks_pooled_ranges():
    _, jm = _prepared("pool10")
    ok = _fields(jm)
    trc.routed_from_jax(device="cpu", **ok)

    def bad(field, edit):
        a = np.asarray(ok[field]).copy()
        edit(a)
        with pytest.raises(ValueError):
            trc.routed_from_jax(**dict(ok, **{field: a}), device="cpu")

    bad("hpidx", lambda a: a.__setitem__((0, 0), -3))
    bad("hwidx", lambda a: a.__setitem__(0, ok["n_windows"]))
    bad("hlo", lambda a: a.__setitem__((0, 0), -2))
    bad("hreduce", lambda a: a.__setitem__((slice(None), np.flatnonzero(a[0])[0]), 1.0))
    # an empty run (hlo, hhi], and two slots' runs over the same lanes
    r, j = np.argwhere(np.asarray(ok["hhi"]) >= 1)[0]
    bad("hlo", lambda a: a.__setitem__((r, j), ok["hhi"][r, j]))
    j2 = np.flatnonzero(ok["hhi"][r] < 0)[0]
    lo, hi = ok["hlo"].copy(), ok["hhi"].copy()
    lo[r, j2], hi[r, j2] = lo[r, j], hi[r, j]
    with pytest.raises(ValueError, match="overlap"):
        trc.routed_from_jax(**dict(ok, hlo=lo, hhi=hi), device="cpu")
    with pytest.raises(ValueError):
        trc.routed_from_jax(**dict(ok, hhi=None), device="cpu")


def test_stored_csr_keeps_pooled_f32_rows_exact():
    tcsr, _ = _csrs("natural")
    heavy = np.repeat(np.isin(np.arange(tcsr.shape[0]), _prepared("natural")[0].heavy_rows),
                      np.diff(tcsr.indptr))
    for bf16 in (False, True):
        chain = trc.build_chain(_prepared("natural", bf16)[0])
        data = trc.stored_csr(tcsr, chain).data
        if bf16:
            # rounded once, as prepare casts the f64 values to bf16
            want = torch.from_numpy(tcsr.data).to(torch.bfloat16).double().numpy()
            np.testing.assert_array_equal(data, want)
        else:
            np.testing.assert_array_equal(data, tcsr.data)
        assert heavy.sum() == 40 * 17000
    # a dense heavy block still stores its rows in bf16 in the f32 mode
    spiked = T.coo_to_csr(_heavy_rows_matrix(3000, 30000, 1, 20000, 5000, 31, vals="normal"))
    chain = trc.build_chain(tr.prepare_routed(spiked, device="cpu"))
    assert chain.mat.hdense is not None
    d = trc.stored_csr(spiked, chain).data
    i1 = spiked.indptr[1]
    np.testing.assert_array_equal(
        d[:i1], torch.from_numpy(spiked.data[:i1].astype(np.float32)).to(torch.bfloat16).double())
    np.testing.assert_array_equal(d[i1:], spiked.data[i1:])


def test_auto_spmv_pooled_matches_jax_and_oracle():
    tcsr, jcsr = _csrs("natural")
    tm = tauto.AutoSpMV.from_csr(tcsr, device="cpu")
    jm = jauto.AutoSpMV.from_csr(jcsr)
    assert tm.format == jm.format == "routed"
    assert tm._operands.counts["heavy"] == 1 and jm._operands.hvals is not None
    _pooled_equal(tm._operands.mat, jm._operands)
    x = _x(tcsr.shape[1], seed=8)
    y = tm(x)
    _close(y, jm(x))
    o = _stored_oracle(tcsr, tm._operands, x)
    assert np.abs(y.double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6


def test_cli_auto_on_pooled_heavy_rows(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    path = str(tmp_path / "pooled.mtx")
    write_mtx(path, CASES["natural"][0]())
    rc = cli.main([path, "RNDVECT", "AUTO", "--device", "cpu", "--check", "--no-dump"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "#auto: format=routed -> PL_CSR_ROUTED" in out and "#check: OK" in out
    rc = cli.main([path, "RNDVECT", "PL_CSR_ROUTED_BF16", "--device", "cpu", "--check", "--no-dump"])
    out = capsys.readouterr().out
    assert rc == 0 and "#check: OK" in out, out


# ---------------------------------------------------------------------------
# small domains: one launch where the JAX package takes _routed_small_spmv
# ---------------------------------------------------------------------------


def _jax_small_ok(mat) -> bool:
    """The JAX package's test (formats/routed.py::routed_spmv), with its x
    windows in f32 (the slab dtype of both modes)."""
    xw_bytes = mat.n_windows * LANE * LANE * 4
    return (
        len(mat.widx_t) == mat.vals.shape[0] // LANE
        and mat.perm_products.t <= 4
        and mat.perm_out.t <= 4
        and (mat.perm_out.t > 1 or mat.perm_out.wc is not None)
        and mat.perm_out.r1 is None
        and not mat.lvl_perms
        and mat.hvals is None
        and mat.hdense is None
        and xw_bytes <= 2 * 2**20
    )


def _random(mn, nnz, seed=7, n=None, col_max=None):
    rng = np.random.default_rng(seed)
    n = n or mn
    cols = rng.integers(0, col_max or n, nnz)
    rows, cols = np.unique(np.stack([rng.integers(0, mn, nnz), cols]), axis=1)
    return T.COOMatrix((mn, n), rows, cols, rng.standard_normal(rows.shape[0]))


def _level_row():
    coo = _random(3000, 5000, seed=5)
    rng = np.random.default_rng(5)
    rows = np.r_[coo.rows, np.zeros(300, np.int64)]
    cols = np.r_[coo.cols, rng.choice(3000, 300, replace=False)]
    rows, cols = np.unique(np.stack([rows, cols]), axis=1)
    return T.COOMatrix((3000, 3000), rows, cols, rng.standard_normal(rows.shape[0]))


#: shape -> (matrix, JAX small_ok expected); the first three are
#: tests/test_routed.py::test_routed_small_single_kernel's, the rest fail
#: one clause each: t > 4, a level, a dense heavy block, pooled heavy tiles,
#: more than 32 x windows
SMALL_SHAPES = {
    "9000": (lambda: _random(9000, 40000), True),
    "6000": (lambda: _random(6000, 15000), True),
    "25000": (lambda: _random(25000, 35000), True),
    "t_over_4": (lambda: _random(30000, 120000), False),
    "level": (_level_row, False),
    "dense_heavy": (lambda: _heavy_rows_matrix(3000, 30000, 1, 20000, 5000, 31, vals="normal"),
                    False),
    # 37 x windows, all nnz in the first one (one gather tile)
    "windows": (lambda: _random(600, 3000, n=600000, col_max=16384), False),
}


def _small_prepared(shape):
    def make():
        tcsr = T.coo_to_csr(SMALL_SHAPES[shape][0]())
        jcsr = J.CSRMatrix(shape=tcsr.shape, indptr=tcsr.indptr, indices=tcsr.indices, data=tcsr.data)
        return tcsr, tr.prepare_routed(tcsr, device="cpu"), jr.prepare_routed(jcsr)

    return _memo(("small", shape), make)


@pytest.mark.parametrize("shape", list(SMALL_SHAPES))
def test_small_stage_where_jax_takes_the_small_kernel(shape):
    tcsr, tm, jm = _small_prepared(shape)
    expect = SMALL_SHAPES[shape][1]
    assert _jax_small_ok(jm) == expect == trc.small_ok(tm)
    chain = trc.build_chain(tm)
    assert (chain.counts["small"] == 1) == expect
    if expect:
        assert [type(s).__name__ for s in chain.stages] == ["SmallStage"]
        assert sum(chain.counts.values()) == 1
    else:
        assert not any(isinstance(s, trc.SmallStage) for s in chain.stages)
    if shape == "windows":
        assert tm.n_windows > 32 and tm.perm_products.t <= 4 and not tm.lvl_perms
    # the plain result: the staged chain's, bit for bit, and the JAX package's
    x = torch.as_tensor(_x(tcsr.shape[1], seed=3), dtype=torch.float32)
    y = trc.routed_chain_spmv(chain, x)
    assert torch.equal(y, trc.routed_chain_spmv(trc.build_chain(tm, fuse_small=False), x))
    if expect:
        _close(y, jr.routed_spmv(jm, jnp.asarray(x.numpy(), jnp.float32)))


#: the SMALL_SHAPES whose domain has no levels and no heavy rows: the
#: staged chain is gather, W2, reduce and the output permutation, which
#: compose into per-row slot lists (small_ok holds for the first three)
LIST_SHAPES = ["9000", "6000", "25000", "t_over_4", "windows"]


@pytest.mark.parametrize("shape", LIST_SHAPES)
def test_small_lists_give_the_staged_chain_bit_for_bit(shape):
    tcsr, tm, jm = _small_prepared(shape)
    staged = trc.build_chain(tm, fuse_small=False)
    g = staged.stages[0]
    row_ptr, row_slots = trc._small_lists(staged.stages)
    assert row_ptr.shape == (tcsr.shape[0] + 1,) and row_slots.numel() <= tm.perm_products.h * LANE
    x = torch.as_tensor(_x(tcsr.shape[1], seed=4), dtype=torch.float32)
    # a plain torch loop over the lists in C's order: the staged chain's
    # plain result, bit for bit
    y = trc.small_reference(g.vals, g.pidx, g.widx, row_ptr, row_slots, x)
    assert torch.equal(y, trc.routed_spmv_reference(staged, x))
    if SMALL_SHAPES[shape][1]:  # the JAX package takes _routed_small_spmv
        _close(y, jr.routed_spmv(jm, jnp.asarray(x.numpy(), jnp.float32)))
    o = serial_csr_spmv(tcsr, x.double().numpy())
    assert np.abs(y.double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6


def test_small_stage_on_a_forced_clause():
    # a layout without static windows (widx_t) fails the JAX test; the
    # port's refuses a products or output plan with r1 (its router folds it)
    _, tm, jm = _small_prepared("6000")
    assert not _jax_small_ok(dataclasses.replace(jm, widx_t=()))
    chain = trc.build_chain(dataclasses.replace(tm, widx_t=()))
    assert chain.counts["small"] == 0 and chain.counts["gather"] == 1
    r1 = torch.zeros(tm.perm_out.h, LANE, dtype=torch.int8)
    with pytest.raises(ValueError, match="r1"):
        trc.build_chain(dataclasses.replace(tm, perm_out=dataclasses.replace(tm.perm_out, r1=r1)))


def test_small_program_parses():
    _, tm, _ = _small_prepared("25000")
    chain = trc.build_chain(tm)
    assert tm.out_t == 2  # the three-stage output permutation
    src = open(os.path.join(os.path.dirname(trc.__file__), "..", "csrc", "routed_spmv.cu")).read()
    words = [int(v) for v in re.search(r"kOpWords\[\] = \{([^}]*)\}", src).group(1).split(",")]
    # D's op as the encoder writes it: H n_h n_pad target out, its sums and ticket
    d_op = trc._hdense_op(torch.zeros(1, 128, dtype=torch.bfloat16), None, None, trc.Buf("s"))
    assert words[trc._OP_HDENSE] == len(d_op) == 8 and d_op[-2] == d_op[-1] + 4
    (prog,) = trc._encode(chain.stages)
    assert int(prog[0]) == 7 and words[7] == len(prog) == 9
    st = chain.stages[0]
    # operands: the gather tiles, the per-row slot lists, the y it writes
    # (tag 2) and m; no scratch, and the chain allocates none
    assert [int(v) for v in prog[2:7]] == [t.data_ptr() for t in (st.vals, st.pidx, st.widx,
                                                                   st.row_ptr, st.row_slots)]
    assert int(prog[-2]) >> 56 == 2 and int(prog[-1]) == tm.shape[0]
    assert not any(int(v) >> 56 == 1 for v in prog[1:]) and chain.scratch_elems == 0
    # the composed lists: one per row of y, each a run of real gather slots,
    # at most one slot per slab slot (h1*128)
    ptr, slots = st.row_ptr, st.row_slots
    assert ptr.shape == (tm.shape[0] + 1,) and ptr.dtype == slots.dtype == torch.int32
    assert int(ptr[0]) == 0 and bool((ptr[1:] >= ptr[:-1]).all()) and int(ptr[-1]) == slots.numel()
    assert slots.numel() <= tm.perm_products.h * LANE
    assert int(slots.min()) >= 0 and int(slots.max()) < tm.vals.numel()


def test_new_wrappers_take_cuda_tensors_only():
    tm, _ = _prepared("pool10")
    chain = trc.build_chain(tm)
    st = chain.stages[-1]
    x = torch.zeros(tm.shape[1])
    y = torch.zeros(tm.shape[0])
    with pytest.raises(ValueError, match="CUDA"):
        trc.routed_heavy_cuda(st.hvals, st.hpidx, st.hwidx, st.hlo, st.hhi, st.slot_ptr,
                              st.slot_idx, st.rows, x, y)
    _, sm, _ = _small_prepared("6000")
    small = trc.build_chain(sm)
    with pytest.raises(ValueError, match="CUDA"):
        trc.routed_small_cuda(small.stages[0], torch.zeros(6000), torch.zeros(6000))
    assert trc.routed_heavy_cuda.launches == trc.routed_small_cuda.launches == 0


@pytest.mark.parametrize("mod,src,names", [
    (trc, "routed_spmv.cu", {"routed_chain_launch", "routed_error_string"}),
    (twc, "window_spmv.cu", {"window_launch", "window_error_string"}),
    (tlc, "lanes_spmv.cu", {"lanes_launch", "lanes_error_string"}),
])
def test_bindings_match_the_source(mod, src, names):
    """The sources are compiled only on a machine with nvcc: hold each C
    function's parameter list against the ctypes argtypes bound to it."""
    text = open(os.path.join(os.path.dirname(mod.__file__), "..", "csrc", src)).read()
    body = text[text.index('extern "C" {'):]
    sigs = dict(re.findall(r"^(?:int|long long|const char\*) (\w+)\(([^)]*)\)", body, re.M))

    class Fake:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = Fake()
    mod._bind(lib)
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    for name, params in sigs.items():
        want = [kinds.get(re.sub(r"\s+\w+$", "", p.strip()), ctypes.c_void_p)
                for p in params.split(",")]
        assert getattr(lib, name).argtypes == want, name
    assert set(sigs) == names


# ---------------------------------------------------------------------------
# kernel E's order of adds: a CTA per residue quarter against a CTA per tile
# ---------------------------------------------------------------------------


def _row_sums_order(slots, slot_ptr, slot_idx):
    """routed_row_sums_kernel on numpy float32: heavy row k's slots dealt to
    32 lanes in turn, each lane's sum from +0, then the shuffle tree."""
    out = np.zeros(slot_ptr.shape[0] - 1, np.float32)
    for k in range(out.shape[0]):
        acc = np.zeros(32, np.float32)
        for i in range(slot_ptr[k], slot_ptr[k + 1]):
            lane = (i - slot_ptr[k]) % 32
            acc[lane] = acc[lane] + slots[slot_idx[i]]
        for off in (16, 8, 4, 2, 1):
            acc[:off] = acc[:off] + acc[off:2 * off]
        out[k] = acc[0]
    return out


def _one_cta_per_tile_order(tm, x):
    """The adds of kernel E as one CTA per pooled tile made them, on numpy
    float32: residue a's run of slot j (lanes (hlo, hhi]) summed in lane order
    from +0 and left in its last lane; per slot, four quarters of 32 residues,
    each summed in order from +0 (runs only), added in order; then the row
    sums."""
    n_tiles = tm.hvals.shape[0] // LANE
    hv = tm.hvals.to(torch.float32).numpy()
    hp = tm.hpidx.numpy().astype(np.int64)
    lo, hi = tm.hlo.numpy().astype(np.int64), tm.hhi.numpy().astype(np.int64)
    xf = x.astype(np.float32)
    a = np.tile(np.arange(LANE), n_tiles)[:, None]
    col = np.repeat(tm.hwidx.numpy().astype(np.int64), LANE)[:, None] * LANE * LANE + hp * LANE + a
    xv = np.where(col < xf.shape[0], xf[np.minimum(col, xf.shape[0] - 1)], np.float32(0))
    p = hv * xv
    rows = np.arange(p.shape[0])
    for j in range(LANE):
        has = hi[:, j] >= 0
        acc = np.zeros(p.shape[0], np.float32)
        for k in range(int((hi[:, j] - lo[:, j]).max(initial=0))):
            c = lo[:, j] + 1 + k
            m = has & (c <= hi[:, j])
            acc[m] = acc[m] + p[rows[m], c[m]]
        p[rows[has], hi[has, j]] = acc[has]
    slots = np.zeros((n_tiles, LANE), np.float32)
    for q in range(4):
        red = np.zeros((n_tiles, LANE), np.float32)
        for r in range(32 * q, 32 * q + 32):
            t_rows = np.arange(n_tiles) * LANE + r
            h = hi[t_rows]
            v = p[t_rows[:, None], np.maximum(h, 0)]
            red = np.where(h >= 0, red + v, red)
        slots = red if q == 0 else slots + red
    slot_ptr, slot_idx = trc.heavy_slot_map(tm.hreduce, "cpu")
    return _row_sums_order(slots.reshape(-1), slot_ptr.numpy(), slot_idx.numpy())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_quarter_split_keeps_the_one_cta_per_tile_order(case, bf16):
    # kernel E as a CTA per (tile, residue quarter), its close adding a
    # slot's quarters in order (heavy_sums_in_order), gives the one CTA per
    # tile kernel's sums bit for bit, and heavy_sums_reference's within the
    # module's tolerance
    tm, _ = _prepared(case, bf16)
    x = _x(tm.shape[1], seed=5)
    xt = torch.as_tensor(x, dtype=torch.float32)
    slot_ptr, slot_idx = trc.heavy_slot_map(tm.hreduce, "cpu")
    args = (tm.hvals, tm.hpidx, tm.hwidx, tm.hlo, tm.hhi, slot_ptr, slot_idx, xt)
    y = trc.heavy_sums_in_order(*args)
    assert y.dtype == torch.float32 and y.shape == (len(tm.heavy_rows),)
    want = _one_cta_per_tile_order(tm, x)
    np.testing.assert_array_equal(y.numpy().view(np.int32), want.view(np.int32))
    _close(y, trc.heavy_sums_reference(*args).numpy())
    # E's scratch: 128 slot sums per tile and quarter, 16-byte aligned in
    # the chain's scratch
    chain = trc.build_chain(tm)
    st = chain.stages[-1]
    assert trc.heavy_part_elems(tm.hvals) == 4 * tm.hvals.shape[0]
    assert st.part.off % 4 == 0 and chain.scratch_elems >= st.part.off + 4 * tm.hvals.shape[0]


def _walk(prod, lo, hi, segs):
    """Kernel E's walk of one residue row on numpy float32, as
    csrc/routed_spmv.cu runs it: lane flags from the runs (1 start, 2 end),
    the row in `segs` segments of lanes, the thread of a segment summing
    the runs that start in it to their ends, 16 lanes a chunk: the chunk's
    starts and ends as lane masks, the ends it owns, the sum restarted at
    each start and left in each owned end's lane. The segments' threads run
    last to first, so each reads lanes a later one has overwritten where
    it can."""
    fl = np.zeros(LANE, np.int64)
    for j in np.flatnonzero(hi >= 0):
        s = lo[j] + 1
        if s == hi[j]:
            fl[s] = 3
        else:
            fl[s], fl[hi[j]] = 1, 2
    row = prod.copy()
    seg_lanes = LANE // segs
    for seg in reversed(range(segs)):
        c0, c1 = seg * seg_lanes // 16, (seg + 1) * seg_lanes // 16
        acc, seen, is_open = np.float32(0), False, False
        for c in range(c0, LANE // 16):
            more = c < c1
            if not (is_open or more):
                break
            chunk = row[16 * c:16 * c + 16].copy()
            st = sum(int(fl[16 * c + k] & 1) << k for k in range(16))
            en = sum(int(fl[16 * c + k] >> 1 & 1) << k for k in range(16))
            if more:
                low = st & -st
                own = en & (0xFFFF if seen else (0xFFFF & ~(low - 1) if st else 0))
                seen = seen or st != 0
            else:
                own = en & -en if is_open else 0
            hs, he = st.bit_length() - 1, en.bit_length() - 1
            is_open = (hs > he or (hs == he and hs < 0 and is_open)) if more else \
                (is_open and own == 0)
            for k in range(16):
                acc = np.float32((np.float32(0) if st >> k & 1 else acc) + chunk[k])
                if own >> k & 1:
                    row[16 * c + k] = acc
    return row


def test_segmented_walk_sums_each_run_once():
    # E's walk over lane segments (kWalkSegs, and one segment) leaves each
    # run's sum, added in lane order from +0, in its last lane, bit for bit:
    # runs with gaps between them, slots in any order, runs across
    # segments; and sampled rows of the pooled cases
    src = open(os.path.join(os.path.dirname(trc.__file__), "..", "csrc", "routed_spmv.cu")).read()
    segs = int(re.search(r"constexpr int kWalkSegs = (\d+);", src).group(1))
    rng = np.random.default_rng(8)
    rows = []
    for _ in range(150):
        cuts = np.sort(rng.choice(np.arange(1, LANE), rng.integers(1, 50), replace=False))
        bounds = np.r_[0, cuts, LANE]
        runs = [(a - 1, b - 1) for a, b in zip(bounds[:-1], bounds[1:]) if rng.random() < 0.8]
        lo, hi = np.full(LANE, -1), np.full(LANE, -1)
        for (l, h), j in zip(runs, rng.permutation(LANE)[:len(runs)]):
            lo[j], hi[j] = l, h
        rows.append((rng.standard_normal(LANE).astype(np.float32), lo, hi))
    tm, _ = _prepared("pool10")
    pick = rng.choice(tm.hvals.shape[0], 40, replace=False)
    for r in pick:
        rows.append((rng.standard_normal(LANE).astype(np.float32),
                     tm.hlo[r].numpy().astype(np.int64), tm.hhi[r].numpy().astype(np.int64)))
    for prod, lo, hi in rows:
        for n_segs in sorted({1, segs}):
            got = _walk(prod, lo, hi, n_segs)
            for j in np.flatnonzero(hi >= 0):
                acc = np.float32(0)
                for c in range(lo[j] + 1, hi[j] + 1):
                    acc = np.float32(acc + prod[c])
                assert got[hi[j]].view(np.int32) == acc.view(np.int32), (n_segs, j)
