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
from spmv_openmp_cuda_tpu_torch.ops import dfloat as tdf
from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu_torch.utils import synth as tsynth
from torch_numpy_path import numpy_path
import torch_df_cases as df_cases


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


def _reduce_levels(chain):
    """(imap, mask, runs, tree, stage) of every C-df level of the chain in
    order: level 0 (its offsets into K3's products), the level its last CTA
    closes, the later levels."""
    out = []
    for s in chain.stages:
        if isinstance(s, trc.DFGatherReduceStage):
            out.append((s.imap, None, s.runs, s.tree, s))
            if s.tail is not None:
                out.append((s.tail.imap, s.tail.mask, s.tail.runs, s.tail.tree, s.tail))
        elif isinstance(s, trc.DFReduceStage):
            out.append((s.imap, s.mask, s.runs, s.tree, s))
    return out


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
    maps = [lv[0] for lv in _reduce_levels(chain)] + [
        s.imap for s in chain.stages if isinstance(s, trc.DFPermuteStage)]
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
        np.asarray(jm.hdense_lo), jm.heavy_rows_df, device="cpu")
    x = torch.from_numpy(_x(tcsr.shape[1]))
    assert torch.equal(trc.routed_df_spmv(trc.build_df_chain(fm), x),
                       trc.routed_df_spmv(trc.build_df_chain(tm), x))
    # heavy rows without their dense block
    with pytest.raises(ValueError, match="heavy"):
        trc.routed_df_from_jax(_jax_mat_fields(jm.mat), np.asarray(jm.vals_lo),
                               heavy_rows_df=jm.heavy_rows_df, device="cpu")


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
    first = chain.stages[0]
    assert isinstance(first, trc.DFGatherReduceStage) and first.tail is not None
    with pytest.raises(ValueError, match="CUDA"):
        trc.routed_df_gather_reduce_cuda(first.vals, first.cols, first.groups, first.chunks, z64, z)
    red = first.tail
    with pytest.raises(ValueError, match="CUDA"):
        trc.routed_df_reduce_cuda(z, red.imap, red.mask, red.groups, red.chunks, z)
    with pytest.raises(ValueError, match="CUDA"):
        trc.routed_df_permute_cuda(z, red.imap, 8, z64)
    hh = torch.zeros(2, 256)
    with pytest.raises(ValueError, match="CUDA"):
        trc.routed_df_rowdot_cuda(hh, hh, torch.zeros(2, dtype=torch.int32), trc.rowdot_plan(256),
                                  z64, z64)
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
    reds = _reduce_levels(chain)
    plans = [(mat.perm_products, jm.mat.perm_products, None, None)] + [
        (p, jp, mk, jmk) for p, jp, mk, jmk in zip(mat.lvl_perms, jm.mat.lvl_perms, mat.lvl_masks,
                                                  jm.mat.lvl_masks)]
    assert len(reds) == len(plans) >= 2 and any(lv[1] is not None for lv in reds)
    rng = np.random.default_rng(11)
    for (imap, smask, runs, tree, _stage), (plan, jplan, mask, jmask) in zip(reds, plans):
        src_rows = imap.steps.src_rows
        sh, sl = _signed_planes(rng, src_rows)
        got = trc.df_perm_reduce_reference(torch.from_numpy(sh), torch.from_numpy(sl),
                                           imap.idx, smask, runs, tree)
        pad = [torch.from_numpy(np.pad(a, ((0, plan.h - src_rows), (0, 0)))) for a in (sh, sl)]
        slab = [trc.staged_reference(trc.plan_steps(plan), a) for a in pad]
        want = trc.reduce_runs_df(*slab, trc.df_reduce_plan(runs, plan.h, torch.device("cpu")),
                                  mask)
        for k in range(2):
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
        jslab = [np.asarray(jroute.apply_permutation(jplan, jnp.asarray(a.numpy()))) for a in pad]
        np.testing.assert_array_equal(jslab[0], slab[0].numpy())
        jh, jl = _jax_df_reduce(*jslab, runs, jmask)
        assert torch.equal(got[0], torch.from_numpy(jh)) and torch.equal(got[1], torch.from_numpy(jl))
        kh, kl = _kernel_group_sums(*(a.numpy() for a in slab) if mask is None else
                                    (a.numpy() * mask.numpy() for a in slab), runs)
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


def _rev(j, bits):
    return int(format(j, f"0{bits}b")[::-1], 2) if bits else 0


def _halve(h, lo, axis):
    """The halving tree over one axis (a power of two): index a with a +
    half, half = size/2 .. 1, the lower on the left; drops the axis."""
    while h.shape[axis] > 1:
        half = h.shape[axis] // 2
        a, b = np.split(h, 2, axis), np.split(lo, 2, axis)
        h, lo = _np_df_add(a[0], b[0], a[1], b[1])
    return h.squeeze(axis), lo.squeeze(axis)


def _kernel_rowdot_ctas(ph, pl, plan):
    """csrc/df_spmv.cu's D-df in its own index arithmetic on the padded
    products (n_h, p2): thread (warp w, lane) of CTA g owns the quad of
    residues 4*(lane + 32*(g + G*w)) + i and streams each one's columns p +
    P*k in bit-reversed k order (a _Stack); the warps pair (w with w +
    half); each CTA leaves its pairs at plane rev(m) * S + s (g = s + S*m,
    M = min(G, 16)); the closer of each s streams each (row, residue)'s M
    pairs in that order (a _Stack), the last of the S closers the S sums at
    their bit-reversed planes (s with s + half), then lanes (l with l +
    off, off = 16 .. 1) and the quad (0 with 2, 1 with 3, then 0 with 1).
    The rows of a tile run one after the other, each the same steps."""
    n_h, p2 = ph.shape
    cta, G, K = plan.cta, plan.groups, 1 << plan.log_k
    W, P = cta // 32, 4 * cta * G
    assert P * K == p2
    w = np.arange(W)[:, None, None, None]
    g = np.arange(G)[None, :, None, None]
    lane = np.arange(32)[None, None, :, None]
    p = 4 * (lane + 32 * (g + G * w)) + np.arange(4)  # (W, G, 32, 4)
    st = _Stack(16)
    for j in range(K):
        col = p + P * _rev(j, plan.log_k)
        h, lo = st.push(j, ph[:, col], pl[:, col])
    h, lo = _halve(h, lo, 1)  # the warps: (n_h, G, 32, 4)
    M = min(G, 16)
    S = G // M
    st = _Stack(16)
    for j in range(M):
        m = _rev(j, M.bit_length() - 1)
        sh, sl = st.push(j, h[:, S * m : S * m + S], lo[:, S * m : S * m + S])  # (n_h, S, 32, 4)
    sh, sl = _halve(sh, sl, 1)  # g's low bits: (n_h, 32, 4)
    for off in (16, 8, 4, 2, 1):
        nh, nl = _np_df_add(sh[:, :off], sl[:, :off], sh[:, off : 2 * off], sl[:, off : 2 * off])
        sh, sl = np.concatenate([nh, sh[:, off:]], 1), np.concatenate([nl, sl[:, off:]], 1)
    qh, ql = sh[:, 0], sl[:, 0]  # (n_h, 4)
    a0 = _np_df_add(qh[:, 0], ql[:, 0], qh[:, 2], ql[:, 2])
    a1 = _np_df_add(qh[:, 1], ql[:, 1], qh[:, 3], ql[:, 3])
    return _np_df_add(*a0, *a1)


def _plans_of(p2):
    """D-df plans of a padded width p2: other splits of p2 into CTAs of 32
    .. 256 threads and 1 .. 256 CTAs a tile (one or two closing steps)."""
    out = []
    for cta in (32, 64, 256):
        for groups in (1, 2, 32, 64, 256):
            threads = 4 * cta * groups
            if threads <= p2 and (p2 // threads).bit_length() - 1 <= 15:
                out.append(trc.RowdotPlan(threads, cta, (p2 // threads).bit_length() - 1, groups))
    return out


@pytest.mark.parametrize("n", [1, 127, 128, 1000, 5000])
def test_df_rowdot_plain_matches_the_dense_rowdot_and_jax(n):
    """Plain D-df against the parent's df_dense_rowdot (bit for bit) and the
    JAX package's _df_dense_rowdot (equal values) for every residue count of
    the kernel, on a sparse block (stored zeros times negative x: -0
    products) with x shorter than the block; the kernel's order (its CTAs'
    index arithmetic, warps, lanes and closing CTA: _kernel_rowdot_ctas)
    gives the same bits for every plan that covers the width."""
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
    plans = _plans_of(p2)
    if n % 128 == 0:
        plans.append(trc.rowdot_plan(n, 3))
        assert all(trc.rowdot_plan(n, n_h).threads in _kernel_threads(p2) for n_h in (1, 3, 8, 20))
    for plan in plans:
        kh, kl = _kernel_rowdot_ctas(ph.numpy(), pl.numpy(), plan)
        np.testing.assert_array_equal(_bits(kh), _bits(want[0]), err_msg=str(plan))
        np.testing.assert_array_equal(_bits(kl), _bits(want[1]), err_msg=str(plan))


def test_df_rowdot_kernel_order_on_caida_shape():
    """_kernel_rowdot_ctas on caida_like's heavy-block width (192,256
    columns: p2 = 2^18) under rowdot_plan's launch for its 8 rows (tiles of
    2 rows, 64 CTAs of 256 threads each, four columns per residue: four
    closers, then one) and under its launch for one row (256 CTAs, one
    column per residue: 16 closers of 16 CTAs each), on 2 rows:
    df_dense_rowdot's bits."""
    rng = np.random.default_rng(3)
    n = 192_256
    hh = rng.standard_normal((2, n)).astype(np.float32)
    hh[rng.random((2, n)) < 0.9] = np.float32(0.0)
    hl = (hh * np.float32(1e-8)).astype(np.float32)
    xh = rng.standard_normal(n - 12).astype(np.float32)
    xl = (xh * np.float32(3e-9)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (hh, hl, xh, xl)]
    want = trc.df_dense_rowdot(*args)
    ph, pl, _p2 = trc._rowdot_products(*args)
    plan, one = trc.rowdot_plan(n, 8), trc.rowdot_plan(n, 1)
    assert (plan.cta, plan.groups, plan.tile, plan.log_k, trc._rowdot_closers(plan)) == (256, 64, 2, 2, 4)
    assert (one.cta, one.groups, one.tile, one.log_k, trc._rowdot_closers(one)) == (256, 256, 1, 0, 16)
    for plan in (plan, one):
        kh, kl = _kernel_rowdot_ctas(ph.numpy(), pl.numpy(), plan)
        np.testing.assert_array_equal(_bits(kh), _bits(want[0]))
        np.testing.assert_array_equal(_bits(kl), _bits(want[1]))


def test_df_rowdot_plan():
    """D-df's launch plan: four residues a thread, CTAs of 256 threads
    (fewer on a block narrower than 1024 padded columns), as many CTAs per
    tile (up to 256) as leave a residue 4 columns, tiles of up to 4 rows, as
    few as make about 256 CTAs in all, more CTAs per tile where tiles of
    one row make fewer, the block's padded width covered exactly; its
    scratch and tickets; the wrapper's check refuses any other plan."""
    for n_pad, n_h, want in (
            (128, 1, (128, 32, 0, 1, 1)), (256, 5, (256, 64, 0, 1, 1)),
            (2560, 5, (4096, 256, 0, 4, 1)), (40_960, 1, (65536, 256, 0, 64, 1)),
            (192_256, 8, (65536, 256, 2, 64, 2)), (192_256, 4, (65536, 256, 2, 64, 1)),
            (192_256, 1, (262144, 256, 0, 256, 1)),
            (1_000_064, 7, (262144, 256, 2, 256, 4)), (1_000_064, 3, (262144, 256, 2, 256, 3)),
            (1_000_064, 40, (262144, 256, 2, 256, 4))):
        plan = trc.rowdot_plan(n_pad, n_h)
        assert (plan.threads, plan.cta, plan.log_k, plan.groups, plan.tile) == want
        assert plan.threads << plan.log_k == 1 << (n_pad - 1).bit_length()
        assert plan.cta * plan.groups * 4 == plan.threads
    for bad, n_h in ((0, 1), (100, 1), (2**40, 1), (256, 0)):
        with pytest.raises(ValueError):
            trc.rowdot_plan(bad, n_h)
    plan = trc.rowdot_plan(192_256, 8)
    assert trc._rowdot_part_elems(plan, 8) == 8 * 128 * (64 + 4) * 2
    assert trc._rowdot_tickets(17, plan, "cpu").tolist() == [0] * (9 * 5)
    hh = torch.zeros(8, 192_256)
    args = (hh, hh, torch.arange(8, dtype=torch.int32))
    x, y = torch.zeros(192_256, dtype=torch.float64), torch.zeros(8, dtype=torch.float64)
    trc._check_rowdot(*args, plan, x, y)
    for bad in (dataclasses.replace(plan, tile=1), dataclasses.replace(plan, tile=4),
                trc.RowdotPlan(32768, 256, 3, 32, 1), trc.rowdot_plan(192_256, 4)):
        with pytest.raises(ValueError, match="D-df plan"):
            trc._check_rowdot(*args, bad, x, y)


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
    """The planned program of a df product: per domain C-df level 0 (forming
    K3's products; closing the level after it where that level is one
    tile) and C-df per later level; then one output gather of every domain;
    then per domain D-df for the dense heavy rows; one launch each
    (caida_like: 3); the counts those make, the program's words as
    csrc/df_spmv.cu reads them, every stage inside the scratch (the
    domains' (hi, lo) pairs, then D-df's CTA sums) or in y: the gather
    over all of y's rows."""
    if name == "chunked":
        tcsr, mat = _chunked_df()
    else:
        tcsr, mat, _ = _routed_prepared(name)
    chain = trc.build_df_chain(mat)
    want, closed = [], []
    for mdf in chain.domains:
        tail = bool(mdf.mat.lvl_perms) and mdf.mat.lvl_perms[0].t == 1
        closed.append(tail)
        want += ["df_gather_reduce"] + ["df_reduce"] * (len(mdf.mat.lvl_perms) - tail)
    want += ["df_permute"] + ["df_rowdot" for mdf in chain.domains if mdf.heavy_rows_df]
    assert [s.kernel for s in chain.stages] == want
    assert [s.tail is not None for s in chain.stages if isinstance(s, trc.DFGatherReduceStage)] == closed
    assert chain.counts == {k: want.count(k) for k in trc._DF_COUNTERS}
    assert trc.df_chain_launches(chain) == len(want)
    assert len(chain.domains) == (3 if name == "chunked" else 1)
    assert (chain.counts["df_rowdot"] > 0) == (name == "heavy_row")
    if name != "chunked":  # one level, one tile: closed by level 0's last CTA
        assert closed == [name != "heavy_row"]
        assert trc.df_chain_launches(chain) == (3 if name == "heavy_row" else 2)
    words = _op_words()
    for s in chain.stages:
        op = trc._df_stage_op(s)
        assert len(op) == words[op[0]]
        if isinstance(s, (trc.DFGatherReduceStage, trc.DFReduceStage)):
            for st in (s, getattr(s, "tail", None)):
                if st is not None:
                    assert st.out.kind == "s" and st.out.off % 2 == 0
                    assert st.out.off + 2 * st.out_elems() <= chain.scratch_elems
        if isinstance(s, trc.DFGatherReduceStage):
            rows = s.imap.idx.shape[0]
            assert s.vals.shape == (rows, 128, 2) and s.cols.shape == (rows, 128)
            assert s.cols.dtype == torch.int32 and not s.ticket.any()
        if isinstance(s, trc.DFRowdotStage):
            assert s.part.off % 2 == 0 and s.n_x == tcsr.shape[1]
            assert s.part.off + trc._rowdot_part_elems(s.plan, s.hh.shape[0]) <= chain.scratch_elems
            assert s.tickets.shape == (trc._rowdot_ticket_words(s.plan, s.hh.shape[0]),)
            assert not s.tickets.any() and s.plan == trc.rowdot_plan(s.hh.shape[1], s.hh.shape[0])
    (out,) = [s for s in chain.stages if isinstance(s, trc.DFPermuteStage)]
    assert (out.src, out.out, out.n) == (trc.Buf("s", 0), trc.Buf("y", 0), tcsr.shape[0])
    assert out.imap.idx.numel() >= out.n and 2 * out.imap.span <= chain.scratch_elems
    x = torch.from_numpy(_x(tcsr.shape[1], seed=9))
    y = trc.routed_df_spmv(chain, x)
    assert trc.bits_equal(y, trc.routed_df_staged_reference(chain, x))
    assert _rel(y, serial_csr_spmv(tcsr, x.numpy())) < (1e-10 if name == "chunked" else 1e-11)


def _level_rows(mdf) -> int:
    """Rows of a domain's level sums: every level's groups (the output
    plan's source rows)."""
    return trc._n_groups(mdf.mat.runs) + sum(trc._n_groups(r) for r in mdf.mat.lvl_runs)


@pytest.mark.parametrize("name", ["chunked", "heavy_row"])
def test_df_output_gather_is_one_map(name):
    """The one output gather of a df product: its map is each domain's
    output plan's map shifted by the domain's region of the scratch (in
    pairs) and placed at its row bound, -1 kept, the rows past m -1; the
    domains' regions and D-df's CTA sums are disjoint and inside the
    scratch; the plain product is bit for bit the staged chain, and within
    1e-12 * max|y| of the JAX package's routed_df_auto_spmv."""
    if name == "chunked":
        # the JAX package's RoutedChunks as its prepare_routed_df_auto makes
        # it, from the bounds test_routed_df_chunked holds equal to its fit
        tcsr, mat = _chunked_df()
        jcsr = J.CSRMatrix(shape=tcsr.shape, indptr=tcsr.indptr, indices=tcsr.indices,
                           data=tcsr.data)
        b = mat.bounds
        jmat = jr.RoutedChunks(
            chunks=tuple(jr.prepare_routed_df(jr._sub_csr(jcsr, r0, r1))
                         for r0, r1 in zip(b[:-1], b[1:])),
            bounds=tuple(b), shape=tcsr.shape, nnz=tcsr.nnz)
    else:
        tcsr, mat, jmat = _routed_prepared(name)
    chain = trc.build_df_chain(mat)
    starts = [s.out.off for s in chain.stages if isinstance(s, trc.DFGatherReduceStage)]
    sizes = [2 * mdf.mat.perm_out.h * 128 for mdf in chain.domains]
    assert starts == list(np.r_[0, np.cumsum(sizes)[:-1]])
    (out,) = [s for s in chain.stages if isinstance(s, trc.DFPermuteStage)]
    flat = out.imap.idx.reshape(-1)
    for mdf, start, r0, r1 in zip(chain.domains, starts, chain.bounds[:-1], chain.bounds[1:]):
        dom = trc.plan_map(mdf.mat.perm_out, src_rows=_level_rows(mdf)).idx.reshape(-1)[: r1 - r0]
        want = torch.where(dom >= 0, dom + start // 2, dom)
        assert torch.equal(flat[r0:r1], want)
    assert out.imap.span <= sum(sizes) // 2
    if len(chain.domains) > 1:
        assert out.imap.steps is None and (flat[tcsr.shape[0]:] == -1).all()
    rowdot = [s for s in chain.stages if isinstance(s, trc.DFRowdotStage)]
    assert bool(rowdot) == (name == "heavy_row")
    for s in rowdot:
        assert s.part.off == sum(sizes)
        assert s.part.off + trc._rowdot_part_elems(s.plan, s.hh.shape[0]) <= chain.scratch_elems
    assert chain.scratch_elems >= sum(sizes)
    x = _x(tcsr.shape[1], seed=12)
    xt = torch.from_numpy(x)
    y = trc.routed_df_spmv(chain, xt, plain=True)
    assert trc.bits_equal(y, trc.routed_df_staged_reference(chain, xt))
    assert _rel(y, _jax_y(lambda xv: jr.routed_df_auto_spmv(jmat, xv), x)) <= 1e-12


# ---------------------------------------------------------------------------
# C-df level 0: K3's products formed where they are summed, and the
# one-tile level its last CTA closes
# ---------------------------------------------------------------------------


def _parent_level0(d):
    """The parent's plain K3 (products of the n_tiles tiles, pad tiles zero)
    followed by plain C-df through the offsets."""
    xh, xl = tdf.split_f64_t(d["x"])
    ph, pl = trc.routed_df_gather_reference(d["vals"], d["vals_lo"], d["pidx"], d["widx"],
                                            d["n_tiles"], xh, xl)
    return trc.df_perm_reduce_reference(ph.reshape(-1), pl.reshape(-1), d["off"], None, d["runs"])


@pytest.mark.parametrize("case", list(df_cases.LEVEL0_RUNS))
def test_df_gather_reduce_plain_is_k3_then_c_df(case):
    """Level 0's plain version over the composed operands (each slot's value
    pair and x column) is bit for bit the parent's plain K3 followed by plain
    C-df, on hand-made tiles holding both kinds of empty slot apart: offsets
    -1 and offsets into pad tiles read (+0, +0), while real slots keep their
    products, -0 words included (a -0 or negative value where x is a signed
    zero, a column past x's end). A sentinel merging the two kinds (an empty
    slot given a real column) changes the bits."""
    d = df_cases.level0_case(df_cases.LEVEL0_RUNS[case])
    vals, cols = trc.gather_reduce_operands(d["vals"], d["vals_lo"], d["pidx"], d["widx"], d["off"])
    want = _parent_level0(d)
    got = trc.df_gather_reduce_reference(vals, cols, d["x"], d["runs"])
    for k in range(2):
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    off = d["off"].long()
    real = (off >= 0) & (off < d["vals"].numel())
    assert ((off == -1).any() and (off >= d["vals"].numel()).any() and real.any())
    assert (cols[~real] == -1).all() and (vals[~real] == 0).all()
    assert not torch.signbit(vals[~real]).any()  # +0 pairs
    n_x = d["x"].shape[0]
    assert (cols[real] >= n_x).any()  # columns past x's end
    ph, _pl = trc.gather_reduce_products(vals, cols, d["x"])
    neg_zero = real & (ph == 0) & torch.signbit(ph)
    assert neg_zero.any()  # real products with a -0 hi word
    # a sentinel merging the kinds: real slots of a zero value or a column
    # past x's end read as empty. Where a group of a power-of-two width
    # sums to a -0 word (no +0 pad turns it +0), the bits change.
    merge = real & ((vals[..., 0] == 0) | (cols >= n_x))
    mvals = torch.where(merge[..., None], torch.zeros_like(vals), vals)
    mcols = torch.where(merge, torch.full_like(cols, -1), cols)
    merged = trc.df_gather_reduce_reference(mvals, mcols, d["x"], d["runs"])
    signed = bool(torch.signbit(want[0][want[0] == 0]).any())
    assert signed == (case == "mixed")
    if signed:
        assert not (trc.bits_equal(merged[0], want[0]) and trc.bits_equal(merged[1], want[1]))


@pytest.mark.parametrize("name", ["power_law", "split_level", "heavy_row"])
def test_df_gather_reduce_plain_on_the_chain(name):
    """Level 0 of the df chain on synthetic routed matrices: its plain
    version bit for bit the parent's plain K3 followed by plain C-df through
    the products plan's composed offsets, and in value the JAX package's
    _gather_products_df then _reduce_runs_df over its apply_permutation."""
    from spmv_openmp_cuda_tpu.ops import route as jroute

    tcsr, tm, jm = _routed_prepared(name)
    chain = trc.build_df_chain(tm)
    s = chain.stages[0]
    assert isinstance(s, trc.DFGatherReduceStage)
    x = torch.from_numpy(_x(tcsr.shape[1], seed=12))
    mat = tm.mat
    d = {"vals": mat.vals, "vals_lo": tm.vals_lo, "pidx": mat.pidx, "widx": mat.widx,
         "n_tiles": mat.perm_products.t, "x": x, "off": s.imap.idx, "runs": s.runs}
    want = _parent_level0(d)
    got = trc.df_gather_reduce_reference(s.vals, s.cols, x, s.runs, s.tree)
    for k in range(2):
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    xh, xl = (jnp.asarray(a.numpy()) for a in tdf.split_f64_t(x))
    jp = jr._gather_products_df(jm.mat, jm.vals_lo, jr._pack_xw(jm.mat, xh), jr._pack_xw(jm.mat, xl))
    h1 = jm.mat.perm_products.h
    jslab = [jroute.apply_permutation(jm.mat.perm_products, jnp.pad(a, ((0, h1 - a.shape[0]), (0, 0))))
             for a in jp]
    jh, jl = jr._reduce_runs_df(*jslab, jm.mat.runs)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jh), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tdf.df_combine64(*got).numpy(),
                               tdf.df_combine64(torch.from_numpy(np.array(jh)),
                                                torch.from_numpy(np.array(jl))).numpy(),
                               rtol=0, atol=1e-12 * float(np.abs(np.asarray(jh)).max()))


def _reduce_warps():
    """csrc/df_spmv.cu's warps per C-df CTA (kReduceWarps)."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(trc.__file__), "..", "csrc", "df_spmv.cu")).read()
    return int(re.search(r"constexpr int kReduceWarps = (\d+);", src).group(1))


def _kernel_task_sums(sh, sl, runs):
    """C-df's order by its warp tasks (df_reduce_tasks, in CTA-sets of
    kReduceWarps): a task of a chunk of at most 32 rows pushes the chunk's
    rows through a _Stack and closes each group from the stack's levels
    (_kernel_group_sums); a wider group's blocks of 32 rows are tasks of
    their own, each closed as a group of its rows plus one +0 pair where it
    has fewer than 32, and the group's sum is the adjacent-pair tree over its
    p2/32 block sums, +0 pairs past its blocks. (n_groups, 128) per plane."""
    chunks = trc.reduce_chunks(runs, "cpu")
    tasks = trc.df_reduce_tasks(chunks).numpy().reshape(-1, _reduce_warps(), 4)
    chunks = chunks.numpy()
    table = trc.groups_table(runs, "cpu").numpy()
    out_h = np.full((table.shape[0], 128), np.nan, np.float32)
    out_l = out_h.copy()
    zero = np.zeros(32, np.float32)
    seen = set()
    for tset in tasks:
        blocks = {}
        for c, band, j, nb in tset:
            if c < 0:
                continue
            seen.add((int(c), int(band), int(j)))
            row0, row1, g0, g1 = chunks[c]
            lanes = slice(32 * band, 32 * band + 32)
            if nb == 1:
                sub = tuple((int(table[g, 0]), 1, int(table[g, 1]), g - g0) for g in range(g0, g1))
                out_h[g0:g1, lanes], out_l[g0:g1, lanes] = _kernel_group_sums(
                    sh[:, lanes], sl[:, lanes], sub)
                continue
            r0 = row0 + 32 * j
            n = min(32, row1 - r0)
            kh, kl = _kernel_group_sums(sh[:, lanes], sl[:, lanes], ((r0, 1, n, 0),))
            kh, kl = kh[0], kl[0]
            if n < 32:
                kh, kl = _np_df_add(kh, kl, zero, zero)
            blocks[(c, band, j)] = (kh, kl)
        for c, band, j, nb in tset:
            if c < 0 or nb == 1 or j != 0:
                continue
            row0, row1, g0, _g1 = chunks[c]
            v = [blocks.get((c, band, jj), (zero, zero)) for jj in range(4)]
            a = _np_df_add(*v[0], *v[1])
            if row1 - row0 > 64:
                a = _np_df_add(*a, *_np_df_add(*v[2], *v[3]))
            out_h[g0, 32 * band : 32 * band + 32], out_l[g0, 32 * band : 32 * band + 32] = a
    want = {(c, b, j) for c, (r0, r1, _g0, _g1) in enumerate(chunks) for b in range(4)
            for j in range(1 if r1 - r0 <= 32 else -(-(r1 - r0) // 32))}
    assert seen == want  # every task once
    return out_h, out_l


def _kernel_closed_level(src_h, src_l, off, mask, runs):
    """The closing CTA's order over a one-tile level: its warps run the
    level's CTA-sets in turn (_kernel_task_sums), each slot read through its
    offset (-1: +0) and masked by a multiply."""
    o = off.numpy().astype(np.int64)
    sh = np.where(o >= 0, src_h[np.maximum(o, 0)], np.float32(0))
    sl = np.where(o >= 0, src_l[np.maximum(o, 0)], np.float32(0))
    if mask is not None:
        sh, sl = sh * mask.numpy(), sl * mask.numpy()
    return _kernel_task_sums(sh, sl, runs)


def test_df_reduce_tasks():
    """C-df's warp tasks: every (chunk, band) once, or once per block of 32
    rows of a chunk wider than 32 rows (one group of up to 128 rows), those
    blocks in consecutive warps of one CTA-set of kReduceWarps; idle warps
    pad the sets."""
    W = _reduce_warps()
    assert W == trc._DF_REDUCE_WARPS
    runs = df_cases.LEVEL0_RUNS["mixed"]
    chunks = trc.reduce_chunks(runs, "cpu")
    tasks = trc.df_reduce_tasks(chunks)
    assert tasks.dtype == torch.int32 and tasks.shape[1] == 4 and tasks.shape[0] % W == 0
    sets = tasks.numpy().reshape(-1, W, 4)
    for tset in sets:
        live = [t for t in tset if t[0] >= 0]
        for t in live:
            if t[3] > 1 and t[2] == 0:  # block 0 sits before the group's other blocks
                k = [tuple(u) for u in tset].index(tuple(t))
                assert [tuple(u[:3]) for u in tset[k : k + t[3]]] == [
                    (t[0], t[1], j) for j in range(t[3])]
    rows = (chunks[:, 1] - chunks[:, 0]).numpy()
    assert sorted(int(t[3]) for t in tasks.numpy() if t[0] >= 0 and t[2] == 0) == sorted(
        [1 if r <= 32 else -(-r // 32) for r in rows for _ in range(4)])
    assert {int(r) for r in rows if r > 32} == {128, 100, 40}


@pytest.mark.parametrize("case", ["w3", "w128", "mixed"])
def test_df_kernel_task_order_is_the_plain_reduce(case):
    """C-df's task order (_kernel_task_sums: wider groups split into blocks
    of 32 rows, each block's sum padded to 32 leaves, then the tree over the
    blocks) on signed zeros and -0 words: bit for bit reduce_runs_df, the
    plain version."""
    runs = df_cases.LEVEL0_RUNS[case]
    rows = max(r0 + ng * w for r0, ng, w, _g0 in runs)
    rng = np.random.default_rng(17)
    sh, sl = _signed_planes(rng, rows)
    sh[:, 7], sl[:, 7] = np.float32(-0.0), np.float32(-0.0)  # a lane of -0 pairs
    want = trc.reduce_runs_df(torch.from_numpy(sh), torch.from_numpy(sl),
                              trc.df_reduce_plan(runs, rows, torch.device("cpu")))
    kh, kl = _kernel_task_sums(sh, sl, runs)
    np.testing.assert_array_equal(_bits(kh), _bits(want[0]))
    np.testing.assert_array_equal(_bits(kl), _bits(want[1]))


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("case", ["w3", "mixed"])
def test_df_closed_level_in_the_last_cta(case, mask):
    """The one-tile level that level 0's last CTA closes, its units taken by
    that CTA's warps in turn, emulated on numpy float32: bit for bit
    reduce_runs_df over level 0's sums read through the level's offsets
    (df_perm_reduce_reference, the level's own launch before), with and
    without a mask."""
    d = df_cases.level0_case(df_cases.LEVEL0_RUNS[case])
    lh, ll = _parent_level0(d)
    off1, mask1 = df_cases.closed_level_case(lh.shape[0], df_cases.CLOSED_RUNS)
    mk = mask1 if mask else None
    want = trc.df_perm_reduce_reference(lh.reshape(-1), ll.reshape(-1), off1, mk,
                                        df_cases.CLOSED_RUNS)
    kh, kl = _kernel_closed_level(lh.reshape(-1).numpy(), ll.reshape(-1).numpy(), off1, mk,
                                  df_cases.CLOSED_RUNS)
    np.testing.assert_array_equal(_bits(kh), _bits(want[0]))
    np.testing.assert_array_equal(_bits(kl), _bits(want[1]))
    rows = off1.shape[0]
    slab = [trc.permute_reference(a.reshape(-1), off1, off1.numel()).reshape(rows, 128)
            for a in (lh, ll)]
    tree = trc.df_reduce_plan(df_cases.CLOSED_RUNS, rows, torch.device("cpu"))
    again = trc.reduce_runs_df(*slab, tree, mk)
    for k in range(2):
        np.testing.assert_array_equal(_bits(again[k]), _bits(want[k]))


@pytest.mark.parametrize("what", ["fits", "rows", "sets"])
def test_df_closed_level_is_bounded(what):
    """The level that level 0's last CTAs close is at most one tile of 128
    slab rows in at most 32 CTA-sets (its closers wait at once, so they
    must be few beside the card's CTA slots): the hand-made one-tile level
    fits; one of 129 rows or of 33 sets is refused by the wrapper before any
    launch; a chain closes only a level that fits."""
    d = df_cases.level0_case(df_cases.LEVEL0_RUNS["w16"])
    vals, cols = trc.gather_reduce_operands(d["vals"], d["vals_lo"], d["pidx"], d["widx"], d["off"])
    runs = d["runs"]
    groups, chunks = trc.groups_table(runs, "cpu"), trc.reduce_chunks(runs, "cpu")
    n0 = groups.shape[0]
    off1, _mask1 = df_cases.closed_level_case(n0, df_cases.CLOSED_RUNS)
    tchunks = trc.reduce_chunks(df_cases.CLOSED_RUNS, "cpu")
    ttasks = trc.df_reduce_tasks(tchunks)
    if what == "rows":
        off1 = torch.cat([off1, off1])[: trc.LANE + 1]
    elif what == "sets":
        ttasks = torch.cat([ttasks, torch.full((4 * 33 - ttasks.shape[0], 4), -1, dtype=torch.int32)])
    imap1 = trc.IndexMap(None, off1, n0 * trc.LANE)
    assert trc._closable(imap1, ttasks) == (what == "fits")
    out = torch.zeros(2 * n0 * trc.LANE)
    tout = torch.zeros(2 * trc.groups_table(df_cases.CLOSED_RUNS, "cpu").shape[0] * trc.LANE)
    tail = (out, imap1, None, trc.groups_table(df_cases.CLOSED_RUNS, "cpu"), tchunks, tout, ttasks)
    with pytest.raises(ValueError, match="CUDA" if what == "fits" else "closed level"):
        trc.routed_df_gather_reduce_cuda(vals, cols, groups, chunks, d["x"], out, tail)
    assert trc.routed_df_gather_reduce_cuda.launches == 0
    if what == "fits":
        for name in ROUTED:
            chain = trc.build_df_chain(_routed_prepared(name)[1])
            assert any(isinstance(s, trc.DFGatherReduceStage) for s in chain.stages)
            for s in chain.stages:
                if isinstance(s, trc.DFGatherReduceStage) and s.tail is not None:
                    assert trc._closable(s.tail.imap, s.tail.tasks)
                    assert s.tail.imap.idx.shape[0] <= trc.LANE
                    assert s.imap.idx.device.type == "cpu"  # level 0's offsets stay on the host
