"""Double-float (float64) routed engine of the PyTorch port against the JAX
package: the df prepare (vals/vals_lo, hdense_hi/hdense_lo, heavy_rows_df)
array for array, the df chain's plain versions (K3, C-df through composed
offsets, the output gather, D-df) against the JAX package's routed_spmv_df,
_reduce_runs_df and _df_dense_rowdot and bit for bit against the staged
chain (the W stages one by one, reduce_runs_df, df_dense_rowdot), the
kernels' order of sums emulated on numpy float32, the planned program, the
chunked path, and the JAX layout carried across.

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
from torch_numpy_path import numpy_path


@pytest.fixture(autouse=True, scope="module")
def _numpy_prepare():
    """The port's numpy prepare paths (see torch_numpy_path)."""
    with numpy_path():
        yield


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
        return tcsr, tr.prepare_routed_df(tcsr, device="cpu"), jr.prepare_routed_df(jcsr)

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
    """The df chain reads each planned permutation through its plan's
    composed map, once per slab slot and plane: C-df's offsets (the products
    domain, each level) and the output gather's map select, bit for bit,
    what the W stages applied one by one give over the same source rows; the
    whole df product is the staged chain's bit for bit."""
    tcsr, tm, _ = _routed_prepared(name)
    mat = tm.mat
    chain = trc.build_df_chain(tm)
    maps = [s.imap for s in chain.stages if isinstance(s, (trc.DFReduceStage, trc.DFPermuteStage))]
    plans = [mat.perm_products, *mat.lvl_perms, mat.perm_out]
    assert len(maps) == len(plans)
    rng = np.random.default_rng(6)
    for plan, imap in zip(plans, maps):
        a = torch.from_numpy(rng.standard_normal((plan.h, 128)).astype(np.float32))
        staged = trc.staged_reference(trc.plan_steps(plan, src_rows=imap.steps.src_rows), a)
        got = trc.permute_reference(a, imap.idx, imap.idx.numel()).reshape(-1, 128)
        assert trc.bits_equal(got, staged[: got.shape[0]])
    x = torch.from_numpy(_x(tcsr.shape[1], seed=8))
    assert trc.bits_equal(trc.routed_df_spmv(chain, x), trc.routed_df_staged_reference(chain, x))


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
    mat = tr.prepare_routed_df_auto(tcsr, device="cpu")
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


@pytest.mark.parametrize("prepare", [
    trc.prepare_routed_chain, trc.prepare_routed_df_chain, tr.prepare_routed_df,
    tr.prepare_routed_df_auto,
])
def test_routed_prepares_default_to_the_card(monkeypatch, prepare):
    """Given no device, the routed prepares run on the card, and without one
    they raise (formats/matrix.py::target_device) before any work: none
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    csr = T.coo_to_csr(tsynth.power_law(400, 400, avg_nnz_per_row=4.0, seed=3))
    with pytest.raises(RuntimeError, match="is_available"):
        prepare(csr)


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
    z64 = torch.zeros(rcsr.shape[1], dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        trc.routed_df_gather_cuda(rm.mat.vals, rm.vals_lo, rm.mat.pidx, rm.mat.widx,
                                  rm.mat.perm_products.t, z64, z)
    with pytest.raises(ValueError, match="CUDA"):
        trc.routed_df_split_cuda(z64, z, z)
    red = next(s for s in chain.stages if isinstance(s, trc.DFReduceStage))
    with pytest.raises(ValueError, match="CUDA"):
        trc.routed_df_reduce_cuda(z, red.imap, red.mask, red.groups, red.chunks, z)
    with pytest.raises(ValueError, match="CUDA"):
        trc.routed_df_permute_cuda(z, red.imap, 8, z64)
    hh = torch.zeros(2, 256)
    with pytest.raises(ValueError, match="CUDA"):
        trc.routed_df_rowdot_cuda(hh, hh, torch.zeros(2, dtype=torch.int32), trc.rowdot_plan(256),
                                  z, z, z64)
    assert all(fn.launches == 0 for fn in trc._DF_COUNTERS.values())



# ---------------------------------------------------------------------------
# the routed df kernels' plain versions and their order of sums (the kernels
# themselves run on the card: tests/test_torch_gpu.py, chip_smoke.py)
# ---------------------------------------------------------------------------


def _np_df_add(ah, al, bh, bl):
    """dfloat.df_add on numpy float32 (each op rounded, none fused)."""
    s = ah + bh
    bb = s - ah
    e = (ah - (s - bb)) + (bh - bb)
    return s, (al + bl) + e


class _Stack:
    """csrc/df_spmv.cu's DfStack, vectorised over the lanes (or threads)
    that push in step: a binary counter of partial sums."""

    def __init__(self, levels):
        self.h, self.l = [None] * levels, [None] * levels

    def push(self, n, vh, vl):
        for k in range(len(self.h)):
            if not (n >> k) & 1:
                self.h[k], self.l[k] = vh, vl
                return vh, vl
            vh, vl = _np_df_add(self.h[k], self.l[k], vh, vl)
            self.h[k], self.l[k] = vh, vl
        return vh, vl


def _kernel_group_sums(sh, sl, runs):
    """C-df's order: each group's rows pushed in order; a width that is no
    power of two closes from the stack's levels of its bits, the lowest plus
    +0 first, then each higher level on the left; (n_groups, 128) per
    plane."""
    out_h, out_l = [], []
    for row0, ng, width, _g0 in runs:
        for j in range(ng):
            st = _Stack(8)
            for n in range(width):
                r = row0 + j * width + n
                h, lo = st.push(n, sh[r], sl[r])
            if width & (width - 1):
                bits = [k for k in range(8) if (width >> k) & 1]
                h, lo = st.h[bits[0]] + np.float32(0), st.l[bits[0]] + np.float32(0)
                for k in bits[1:]:
                    h, lo = _np_df_add(st.h[k], st.l[k], h, lo)
            out_h.append(h)
            out_l.append(lo)
    return np.stack(out_h), np.stack(out_l)


def _bits(t):
    t = np.ascontiguousarray(t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t))
    return t.view({8: np.int64, 4: np.int32}[t.itemsize])


def _signed_planes(rng, rows):
    """(hi, lo) f32 planes of normal values, a tenth of them +0 or -0, and
    lo words 1e-8 of hi."""
    h = rng.standard_normal((rows, 128)).astype(np.float32)
    pick = rng.random((rows, 128))
    h[pick < 0.1] = np.float32(0.0)
    h[pick < 0.05] = np.float32(-0.0)
    lo = (h * np.float32(1e-8) * rng.standard_normal((rows, 128)).astype(np.float32))
    return h, lo.astype(np.float32)


def _jax_df_reduce(sh, sl, runs, mask=None):
    got = jr._reduce_runs_df(jnp.asarray(sh), jnp.asarray(sl), runs,
                             mask=None if mask is None else jnp.asarray(mask))
    return np.array(got[0]), np.array(got[1])


@pytest.mark.parametrize("name", ["power_law", "split_level"])
def test_df_perm_reduce_plain_matches_the_staged_reduce_and_jax(name):
    """Plain C-df through each level's composed offsets against the parent's
    reduce_runs_df over the permuted slab (bit for bit) and the JAX
    package's _reduce_runs_df over its apply_permutation (equal values),
    the masked levels included; the kernel's order of sums (_Stack) gives
    the plain version's bits."""
    from spmv_openmp_cuda_tpu.ops import route as jroute

    _tcsr, tm, jm = _routed_prepared(name)
    mat = tm.mat
    chain = trc.build_df_chain(tm)
    reds = [s for s in chain.stages if isinstance(s, trc.DFReduceStage)]
    plans = [(mat.perm_products, jm.mat.perm_products, None, None)] + [
        (p, jp, mk, jmk) for p, jp, mk, jmk in zip(mat.lvl_perms, jm.mat.lvl_perms, mat.lvl_masks,
                                                  jm.mat.lvl_masks)]
    assert len(reds) == len(plans) >= 2 and any(s.mask is not None for s in reds)
    rng = np.random.default_rng(11)
    for stage, (plan, jplan, mask, jmask) in zip(reds, plans):
        src_rows = stage.imap.steps.src_rows
        sh, sl = _signed_planes(rng, src_rows)
        got = trc.df_perm_reduce_reference(torch.from_numpy(sh), torch.from_numpy(sl),
                                           stage.imap.idx, stage.mask, stage.runs, stage.tree)
        pad = [torch.from_numpy(np.pad(a, ((0, plan.h - src_rows), (0, 0)))) for a in (sh, sl)]
        slab = [trc.staged_reference(trc.plan_steps(plan), a) for a in pad]
        want = trc.reduce_runs_df(*slab, trc.df_reduce_plan(stage.runs, plan.h, torch.device("cpu")),
                                  mask)
        for k in range(2):
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
        jslab = [np.asarray(jroute.apply_permutation(jplan, jnp.asarray(a.numpy()))) for a in pad]
        np.testing.assert_array_equal(jslab[0], slab[0].numpy())
        jh, jl = _jax_df_reduce(*jslab, stage.runs, jmask)
        assert torch.equal(got[0], torch.from_numpy(jh)) and torch.equal(got[1], torch.from_numpy(jl))
        kh, kl = _kernel_group_sums(*(a.numpy() for a in slab) if mask is None else
                                    (a.numpy() * mask.numpy() for a in slab), stage.runs)
        np.testing.assert_array_equal(_bits(kh), _bits(got[0]))
        np.testing.assert_array_equal(_bits(kl), _bits(got[1]))


@pytest.mark.parametrize("width", [1, 2, 3, 5, 7, 70, 128])
def test_df_perm_reduce_plain_on_hand_made_runs(width):
    """Runs of one width over a slab read through scattered offsets (-1
    among them), signed zeros among the values, with and without a mask:
    the plain C-df equals the parent's reduce_runs_df bit for bit and the
    JAX package's _reduce_runs_df in value; the kernel's order (_Stack with
    +0 pads) gives its bits. An all-zero group keeps the padded tree's
    signs: the JAX halve tree, which pads nothing, can differ there only."""
    rng = np.random.default_rng(width)
    ng = 5
    rows = ng * width + 3  # three slab rows past the groups
    runs = ((3, ng, width, 0),)
    src_rows = rows + 17
    sh, sl = _signed_planes(rng, src_rows)
    sh[:, 5], sl[:, 5] = np.float32(-0.0), np.float32(-0.0)  # lane 5: all -0
    off = rng.permutation(src_rows * 128)[: rows * 128].astype(np.int64)
    off[rng.random(off.shape) < 0.1] = -1
    off = torch.from_numpy(off.astype(np.int32)).reshape(rows, 128)
    mask = torch.from_numpy((rng.random((rows, 128)) < 0.8).astype(np.float32))
    for mk in (None, mask):
        got = trc.df_perm_reduce_reference(torch.from_numpy(sh), torch.from_numpy(sl), off, mk,
                                           runs)
        slab = [trc.permute_reference(torch.from_numpy(a), off, off.numel()).reshape(rows, 128)
                for a in (sh, sl)]
        want = trc.reduce_runs_df(*slab, trc.df_reduce_plan(runs, rows, torch.device("cpu")), mk)
        for k in range(2):
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
        jh, jl = _jax_df_reduce(slab[0].numpy(), slab[1].numpy(), runs,
                                None if mk is None else mk.numpy())
        assert torch.equal(got[0], torch.from_numpy(jh)) and torch.equal(got[1], torch.from_numpy(jl))
        ms = [a.numpy() if mk is None else (a * mk).numpy() for a in slab]
        kh, kl = _kernel_group_sums(ms[0], ms[1], runs)
        np.testing.assert_array_equal(_bits(kh), _bits(got[0]))
        np.testing.assert_array_equal(_bits(kl), _bits(got[1]))


def _kernel_threads(p2):
    """The threads per row the D-df kernel runs with (rowdot_plan), and the
    smaller powers of two it would take on a narrower block."""
    return [p for p in (128 << k for k in range(11)) if p <= p2] or [p2]


def _kernel_rowdot(ph, pl, threads):
    """D-df's order on the padded products: thread p streams its columns p
    + threads*k in bit-reversed k order through a _Stack, then threads p
    and p + half pair, half = threads/2 .. 1."""
    p2 = ph.shape[1]
    kk = p2 // threads
    bits = kk.bit_length() - 1
    st = _Stack(16)
    for j in range(kk):
        k = int(format(j, f"0{bits}b")[::-1], 2) if bits else 0
        cols = np.arange(threads) + threads * k
        h, lo = st.push(j, ph[:, cols], pl[:, cols])
    while h.shape[1] > 1:
        half = h.shape[1] // 2
        h, lo = _np_df_add(h[:, :half], lo[:, :half], h[:, half:], lo[:, half:])
    return h[:, 0], lo[:, 0]


@pytest.mark.parametrize("n", [1, 127, 128, 1000, 5000])
def test_df_rowdot_plain_matches_the_dense_rowdot_and_jax(n):
    """Plain D-df against the parent's df_dense_rowdot (bit for bit) and the
    JAX package's _df_dense_rowdot (equal values) for every thread count of
    the kernel, on a sparse block (stored zeros times negative x: -0
    products) with x shorter than the block; the kernel's order (its stack
    over bit-reversed columns, then the halving over threads) gives the same
    bits."""
    rng = np.random.default_rng(n)
    hh = rng.standard_normal((3, n)).astype(np.float32)
    hh[rng.random((3, n)) < 0.7] = np.float32(0.0)
    hl = (hh * np.float32(1e-8) * rng.standard_normal((3, n)).astype(np.float32)).astype(np.float32)
    nx = max(n - 3, 1)
    xh = rng.standard_normal(nx).astype(np.float32)
    xl = (xh * np.float32(1e-8) * rng.standard_normal(nx).astype(np.float32)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (hh, hl, xh, xl)]
    want = trc.df_dense_rowdot(*args)
    pad = [np.pad(a, (0, n - nx)) for a in (xh, xl)]
    jh, jl = jr._df_dense_rowdot(*(jnp.asarray(a) for a in (hh, hl, *pad)))
    assert torch.equal(want[0], torch.from_numpy(np.array(jh)))
    assert torch.equal(want[1], torch.from_numpy(np.array(jl)))
    ph, pl, p2 = trc._rowdot_products(*args)
    for threads in _kernel_threads(p2):
        got = trc.df_rowdot_reference(*args, threads)
        for k in range(2):
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
        kh, kl = _kernel_rowdot(ph.numpy(), pl.numpy(), threads)
        np.testing.assert_array_equal(_bits(kh), _bits(want[0]))
        np.testing.assert_array_equal(_bits(kl), _bits(want[1]))
    if n % 128 == 0:
        assert all(trc.rowdot_plan(n, n_h).threads in _kernel_threads(p2) for n_h in (1, 3, 8, 20))


def test_df_rowdot_plan():
    """D-df's launch plan: four residues a thread, one CTA of up to 512
    threads per row, more CTAs of 512 per row (up to 32) while all rows'
    CTAs stay within 256, the block's padded width covered exactly."""
    for n_pad, n_h, want in ((128, 8, (128, 32, 0, 1)), (256, 8, (256, 64, 0, 1)),
                             (1024, 1, (1024, 256, 0, 1)), (2560, 1, (4096, 512, 0, 2)),
                             (40_960, 8, (65536, 512, 0, 32)), (40_960, 200, (2048, 512, 5, 1)),
                             (192_256, 8, (65536, 512, 2, 32)), (192_256, 1, (65536, 512, 2, 32)),
                             (1_000_064, 4, (65536, 512, 4, 32)),
                             (1_000_064, 7, (65536, 512, 4, 32)),
                             (1_000_064, 40, (8192, 512, 7, 4))):
        plan = trc.rowdot_plan(n_pad, n_h)
        assert (plan.threads, plan.cta, plan.log_k, plan.groups) == want
        assert plan.threads << plan.log_k == 1 << (n_pad - 1).bit_length()
        assert plan.cta * plan.groups * 4 == plan.threads
        assert plan.groups == 1 or plan.cta == 512
    for bad, n_h in ((0, 1), (100, 1), (2**30, 1000)):
        with pytest.raises(ValueError):
            trc.rowdot_plan(bad, n_h)


def _chunked_df():
    def make():
        rng = np.random.default_rng(21)
        rows = np.repeat(np.arange(8000), 3)
        cols = rng.integers(0, 128, rows.size) * 128
        rows, cols = np.unique(np.stack([rows, cols]), axis=1)
        tcsr = T.coo_to_csr(T.sort_coo(T.COOMatrix((8000, 16384), rows, cols,
                                                   rng.standard_normal(rows.size))))
        return tcsr, tr.prepare_routed_df_auto(tcsr, device="cpu")

    return _memo(("routed", "chunked"), make)


def _op_words():
    """csrc/df_spmv.cu's words per op of the df program (kDfOpWords)."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(trc.__file__), "..", "csrc", "df_spmv.cu")).read()
    words = re.search(r"kDfOpWords\[\] = \{([^}]*)\}", src).group(1)
    return [int(w) for w in words.split(",")]


@pytest.mark.parametrize("name", ["power_law", "heavy_row", "chunked"])
def test_df_chain_launch_list(name):
    """The planned program of a df product: the split of x where a domain
    has dense heavy rows, then per domain K3, C-df per level, the output
    gather, D-df for the dense heavy rows; the counts those make, the
    program's words as csrc/df_spmv.cu reads them, every stage inside the
    scratch (x's planes, then each domain's (hi, lo) pairs past them) or in
    its domain's rows of y."""
    if name == "chunked":
        tcsr, mat = _chunked_df()
    else:
        tcsr, mat, _ = _routed_prepared(name)
    chain = trc.build_df_chain(mat)
    heavy = any(mdf.heavy_rows_df for mdf in chain.domains)
    want = ["df_split"] if heavy else []
    for mdf in chain.domains:
        want += ["df_gather"] + ["df_reduce"] * (1 + len(mdf.mat.lvl_perms)) + ["df_permute"]
        want += ["df_rowdot"] if mdf.heavy_rows_df else []
    assert [s.kernel for s in chain.stages] == want
    assert chain.counts == {k: want.count(k) for k in trc._DF_COUNTERS}
    closes = [s for s in chain.stages if isinstance(s, trc.DFRowdotStage) and s.plan.groups > 1]
    assert trc.df_chain_launches(chain) == len(want) + len(closes)
    assert len(closes) == (name == "heavy_row")  # 16 CTAs for its one row of 30,080 columns
    assert len(chain.domains) == (3 if name == "chunked" else 1)
    assert (chain.counts["df_rowdot"] > 0) == (name == "heavy_row")
    words = _op_words()
    for s in chain.stages:
        op = trc._df_stage_op(s)
        assert len(op) == words[op[0]]
        if isinstance(s, (trc.DFGatherStage, trc.DFReduceStage)):
            assert s.out.kind == "s" and s.out.off % 2 == 0
            assert s.out.off + 2 * s.out_elems() <= chain.scratch_elems
            assert s.out.off >= (2 * tcsr.shape[1] if heavy else 0)  # past x's planes
        if isinstance(s, trc.DFRowdotStage):
            assert (s.x.off, s.n_x, s.x_plane % 64) == (0, tcsr.shape[1], 0)
    outs = [s for s in chain.stages if isinstance(s, trc.DFPermuteStage)]
    assert [s.out.off for s in outs] == list(chain.bounds[:-1])
    assert [s.out.off + s.n for s in outs] == list(chain.bounds[1:])
    x = torch.from_numpy(_x(tcsr.shape[1], seed=9))
    y = trc.routed_df_spmv(chain, x)
    assert trc.bits_equal(y, trc.routed_df_staged_reference(chain, x))
    assert _rel(y, serial_csr_spmv(tcsr, x.numpy())) < (1e-10 if name == "chunked" else 1e-11)
