"""The port's multi-device paths (spmv_openmp_cuda_tpu_torch/parallel/) against
the JAX package's, on the CPU: the JAX side on the 8 virtual CPU devices of
tests/conftest.py (its window kernel in interpret mode), the port's shards
on the CPU, where the window kernel runs its plain version.

Every case of tests/test_sharded.py (its matrices and mesh shapes) is a case
here: the port's prepare array for array against the JAX one, the port's y
against JAX's y on x ~ N(0, 1) within 1e-5*max|y| + 1e-6 (f32 sums of the
same terms in another order; df: 1e-12*max|y|), the port's y against the
oracle with the reference's protocol, and the op built from the JAX op's
arrays (`*_from_jax`) giving the port's y bit for bit. Then the window
kernel's plain version with x_lo (a shard's y equal to the unsharded
layout's rows), the collectives, the contract and the scaling harness.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu as J
from spmv_openmp_cuda_tpu.formats import dia as jdia
from spmv_openmp_cuda_tpu.parallel import mesh as JM
from spmv_openmp_cuda_tpu.parallel import sharded as jsh
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch import contract
from spmv_openmp_cuda_tpu_torch.bench import scaling
from spmv_openmp_cuda_tpu_torch.formats import dia as tdia
from spmv_openmp_cuda_tpu_torch.io.vectors import fill_rnd_vector
from spmv_openmp_cuda_tpu_torch.ops import window_cuda as twc
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu_torch.parallel import collectives as C
from spmv_openmp_cuda_tpu_torch.parallel import mesh as TM
from spmv_openmp_cuda_tpu_torch.parallel import sharded as tsh
from spmv_openmp_cuda_tpu_torch.utils import synth
from spmv_openmp_cuda_tpu_torch.utils.compare import vectors_diff
from torch_numpy_path import numpy_path

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _numpy_prepare():
    """The port's numpy prepare paths (see torch_numpy_path), and the JAX
    side with jax_enable_x64 off, whatever a test file before this one in
    the same process left it at (the JAX package's window all-gather
    branch multiplies an int32 axis index by an int64 under x64)."""
    with numpy_path(), jax.enable_x64(False):
        yield


def _meshes(shape):
    n = shape[0] * shape[1]
    return JM.make_mesh(shape, devices=jax.devices()[:n]), TM.make_mesh(shape, devices=[CPU] * n)


def _csr_pair(coo):
    t = T.coo_to_csr(coo)
    return t, J.CSRMatrix(shape=t.shape, indptr=t.indptr, indices=t.indices, data=t.data)


def _mats():
    """tests/test_sharded.py::_mats."""
    coo = synth.power_law(190, 170, 5.0, seed=21)
    tcsr, jcsr = _csr_pair(coo)
    return coo, tcsr, jcsr


def _xn(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n)


def _np(t) -> np.ndarray:
    return t.cpu().double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)


def _join(parts, dim=0):
    return torch.cat([p.cpu() for p in parts], dim=dim).numpy()


def _close(y_t, y_j, rel=1e-5):
    y_t, y_j = _np(y_t), _np(y_j)
    assert y_t.shape == y_j.shape
    bound = rel * np.abs(y_j).max() + (1e-6 if rel >= 1e-6 else 0.0)
    err = np.abs(y_t - y_j).max()
    assert err <= bound, (err, bound)


def _oracle_ok(y, csr, x):
    rep = vectors_diff(_np(y)[: csr.shape[0]], serial_csr_spmv(csr, x))
    assert rep.ok, rep


def _relative(y, csr, x):
    want = serial_csr_spmv(csr, x)
    err = np.abs(_np(y)[: csr.shape[0]] - want).max()
    assert err <= 1e-5 * np.abs(want).max() + 1e-6, err


# ---------------------------------------------------------------------------
# the paths, case for case with tests/test_sharded.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_ell_rows_sharded(mesh_shape):
    coo, tcsr, jcsr = _mats()
    jm, tm = _meshes(mesh_shape)
    jop = jsh.prepare_row_sharded_ell(J.coo_to_ell(coo), jm)
    top = tsh.prepare_row_sharded_ell(T.coo_to_ell(coo), tm)
    for f in ("data", "cols", "row_lens"):
        np.testing.assert_array_equal(_join(getattr(top, f)), np.asarray(getattr(jop, f)), f)
    assert (top.m, top.nnz) == (jop.m, jop.nnz)
    tf, jf = tsh.make_ell_rows_sharded(tm), jsh.make_ell_rows_sharded(jm)
    xn = _xn(tcsr.shape[1])
    y = tf(top, torch.as_tensor(xn, dtype=torch.float32))
    _close(y, jf(jop, jnp.asarray(xn, jnp.float32)))
    _relative(y, tcsr, xn)
    x = fill_rnd_vector(tcsr.shape[1], seed=2)
    _oracle_ok(tf(top, torch.as_tensor(x, dtype=torch.float32)), tcsr, x)
    conv = tsh.row_sharded_ell_from_jax(jop.data, jop.cols, jop.row_lens, jop.m, jop.nnz, tm)
    assert torch.equal(tf(conv, torch.as_tensor(xn, dtype=torch.float32)), y)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (1, 4)])
def test_csr_cols_psum(mesh_shape):
    _, tcsr, jcsr = _mats()
    jm, tm = _meshes(mesh_shape)
    jop = jsh.prepare_col_sharded_csr(jcsr, jm)
    top = tsh.prepare_col_sharded_csr(tcsr, tm)
    for f in ("data", "local_cols", "row_ids"):
        np.testing.assert_array_equal(np.stack([p.numpy() for p in getattr(top, f)]),
                                      np.asarray(getattr(jop, f)), f)
    assert (top.x_pad, top.stripe_w, top.m, top.nnz) == (jop.x_pad, jop.stripe_w, jop.m, jop.nnz)
    tf, jf = tsh.make_csr_cols_psum(tm, tcsr.shape[0]), jsh.make_csr_cols_psum(jm, jcsr.shape[0])
    xn = _xn(tcsr.shape[1])
    y = tf(top, tsh.pad_x_for_col_sharding(xn, top, tm, torch.float32))
    _close(y, jf(jop, jsh.pad_x_for_col_sharding(xn, jop, jm, jnp.float32)))
    _relative(y, tcsr, xn)
    x = fill_rnd_vector(tcsr.shape[1], seed=2)
    _oracle_ok(tf(top, tsh.pad_x_for_col_sharding(x, top, tm, torch.float32)), tcsr, x)
    conv = tsh.col_sharded_csr_from_jax(jop.data, jop.local_cols, jop.row_ids, jop.x_pad,
                                        jop.stripe_w, jop.m, jop.nnz, tm)
    assert torch.equal(tf(conv, tsh.pad_x_for_col_sharding(xn, top, tm, torch.float32)), y)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_ell_ring(n_dev):
    _, tcsr, jcsr = _mats()
    jm, tm = _meshes((n_dev, 1))
    jop = jsh.prepare_ring_ell(jcsr, jm)
    top = tsh.prepare_ring_ell(tcsr, tm)
    np.testing.assert_array_equal(_join(top.data), np.asarray(jop.data))
    np.testing.assert_array_equal(_join(top.cols), np.asarray(jop.cols))
    meta = ("m", "nnz", "d", "m_loc", "w_s", "chunk_w", "x_pad")
    assert [getattr(top, f) for f in meta] == [getattr(jop, f) for f in meta]
    tf, jf = tsh.make_ell_ring(tm, top), jsh.make_ell_ring(jm, jop)
    xn = _xn(tcsr.shape[1])
    y = tf(top, tsh.pad_x_for_ring(xn, top, tm, torch.float32))
    _close(y, jf(jop, jsh.pad_x_for_ring(xn, jop, jm, jnp.float32)))
    _relative(y, tcsr, xn)
    x = fill_rnd_vector(tcsr.shape[1], seed=2)
    _oracle_ok(tf(top, tsh.pad_x_for_ring(x, top, tm, torch.float32))[: top.m], tcsr, x)
    conv = tsh.ring_ell_from_jax(jop.data, jop.cols, *(getattr(jop, f) for f in meta), tm)
    assert torch.equal(tf(conv, tsh.pad_x_for_ring(xn, top, tm, torch.float32)), y)


def _band():
    """tests/test_sharded.py::test_dia_sharded_halo's matrix (pad_sub = 2)."""
    return _csr_pair(synth.banded(5000, 5000, 140, fill=0.3, seed=7))


@pytest.mark.parametrize("case", ["band_140", "band_20"])
def test_dia_sharded_halo(case):
    """test_sharded.py's case (281 diagonals, pad_sub = 2): the prepare
    array for array against the JAX one, y against the oracle; the JAX
    product (whose XLA:CPU compile of 281 unrolled diagonals takes ~10 s)
    held against the port's y on a 41-diagonal band of the same rows, also
    over 8 shards."""
    if case == "band_140":
        tcsr, jcsr = _band()
    else:
        tcsr, jcsr = _csr_pair(synth.banded(5000, 5000, 20, fill=0.3, seed=7))
    jm, tm = _meshes((8, 1))
    jop = jsh.prepare_dia_sharded(jdia.prepare_dia(jcsr, max_fill_ratio=1e9), jm)
    top = tsh.prepare_dia_sharded(tdia.prepare_dia(tcsr, max_fill_ratio=1e9, device="cpu"), tm)
    np.testing.assert_array_equal(_join(top.data, dim=1), np.asarray(jop.data))
    meta = ("offsets", "shape", "nnz", "pad_sub", "s_local")
    assert [getattr(top, f) for f in meta] == [tuple(jop.offsets), *(getattr(jop, f) for f in meta[1:])]
    tf = tsh.make_dia_sharded(tm, top)
    xn = _xn(5000)
    y = tf(top, tsh.pad_x_for_dia_sharded(xn, top, tm, torch.float32)).reshape(-1)
    if case == "band_20":
        jf = jsh.make_dia_sharded(jm, jop)
        yj = np.asarray(jf(jop, jsh.pad_x_for_dia_sharded(xn, jop, jm, jnp.float32))).reshape(-1)
        _close(y, yj)
    _relative(y, tcsr, xn)
    x = fill_rnd_vector(5000, seed=8)
    _oracle_ok(tf(top, tsh.pad_x_for_dia_sharded(x, top, tm, torch.float32)).reshape(-1), tcsr, x)
    conv = tsh.dia_sharded_from_jax(jop.data, jop.offsets, jop.shape, jop.nnz, jop.pad_sub,
                                    jop.s_local, tm)
    assert torch.equal(tf(conv, tsh.pad_x_for_dia_sharded(xn, top, tm, torch.float32)).reshape(-1), y)


@pytest.mark.parametrize("case", ["band_140", "band_20"])
def test_dia_sharded_halo_df(case):
    """test_sharded.py's case (281 diagonals) against the exact oracle; the
    JAX df halo (whose XLA:CPU compile of 281 unrolled compensated
    diagonals takes ~25 s) on a 41-diagonal band of the same rows, also
    over 8 shards."""
    if case == "band_140":
        tcsr, jcsr = _band()
    else:
        tcsr, jcsr = _csr_pair(synth.banded(5000, 5000, 20, fill=0.3, seed=7))
    jm, tm = _meshes((8, 1))
    jop = jsh.prepare_dia_sharded_df(jdia.prepare_dia_df(jcsr, max_fill_ratio=1e9), jm)
    top = tsh.prepare_dia_sharded_df(tdia.prepare_dia_df(tcsr, max_fill_ratio=1e9, device="cpu"), tm)
    np.testing.assert_array_equal(_join(top.data, dim=1), np.asarray(jop.data))
    np.testing.assert_array_equal(_join(top.data_lo, dim=1), np.asarray(jop.data_lo))
    tf = tsh.make_dia_sharded_df(tm, top)
    for x in (_xn(5000), fill_rnd_vector(5000, seed=8)):
        yh, yl = tf(top, *tsh.pad_x_for_dia_sharded_df(x, top, tm))
        y = (yh.double() + yl.double()).reshape(-1)[:5000]
        want = serial_csr_spmv(tcsr, x)
        assert np.abs(y.numpy() - want).max() <= 1e-11 * np.abs(want).max()
    if case == "band_20":
        jh, jl = jsh.make_dia_sharded_df(jm, jop)(jop, *jsh.pad_x_for_dia_sharded_df(x, jop, jm))
        yj = (np.asarray(jh, np.float64) + np.asarray(jl, np.float64)).reshape(-1)[:5000]
        _close(y, yj, rel=1e-12)
    conv = tsh.dia_sharded_df_from_jax(jop.data, jop.data_lo, jop.offsets, jop.shape, jop.nnz,
                                       jop.pad_sub, jop.s_local, tm)
    xh, xl = tsh.pad_x_for_dia_sharded_df(x, top, tm)
    assert all(torch.equal(a, b) for a, b in zip(tf(conv, xh, xl), tf(top, xh, xl)))


def _window_case(jcsr, tcsr, d, xn, x, with_jax=True):
    """Prepare the port's sharded window op on d shards, hold it to the
    oracle and the unsharded layout, and (with_jax) to the JAX package's op
    and y; returns the port's op and its y on xn."""
    jm, tm = _meshes((d, 1))
    top = tsh.prepare_window_sharded(tcsr, tm)
    tf = tsh.make_window_sharded(tm, top)
    y = tf(top, tsh.pad_x_for_window_sharded(xn, top, tm, torch.float32))
    _relative(y, tcsr, xn)
    _oracle_ok(tf(top, tsh.pad_x_for_window_sharded(x, top, tm, torch.float32)), tcsr, x)
    # the plain kernel with x_lo on each shard's halo'd x: y equal to the
    # unsharded layout's rows on the same x
    assert torch.equal(y, twc.window_spmv(top.layout, torch.as_tensor(xn, dtype=torch.float32)))
    if not with_jax:
        return top, y
    jop = jsh.prepare_window_sharded(jcsr, jm)
    for f in ("vals", "sidx", "gid", "rsrc"):
        np.testing.assert_array_equal(_join([getattr(s, f) for s in top.shards]),
                                      np.asarray(getattr(jop, f)), f)
    meta = ("shape", "nnz", "g", "k_pad", "wr", "nspecs", "nb_local", "nd", "k_c")
    assert [getattr(top, f) for f in meta] == [getattr(jop, f) for f in meta]
    jf = jsh.make_window_sharded(jm, jop)
    _close(y, jf(jop, jsh.pad_x_for_window_sharded(xn, jop, jm, jnp.float32)))
    conv = tsh.window_sharded_from_jax(jop.vals, jop.sidx, jop.gid, jop.rsrc, jop.shape,
                                       jop.nnz, jop.g, jop.k_pad, jop.wr, jop.nspecs,
                                       jop.nb_local, jop.nd, jop.k_c, tm)
    assert conv.plan_blocks == top.plan_blocks == top.layout.nblocks
    assert torch.equal(tf(conv, tsh.pad_x_for_window_sharded(xn, top, tm, torch.float32)), y)
    return top, y


def test_window_sharded_matches_oracle():
    """tests/test_sharded.py's case: d = 2 and 4 on a 12000-row FEM proxy,
    the halo exchange; held to the JAX package's op and y at d = 4 (its
    interpret-mode kernel is the slow part), to the oracle at both."""
    tcsr, jcsr = _csr_pair(synth.fem_like(m=12000, n=12000, nnz=150000, spread=700, lo=5, hi=20,
                                          seed=8))
    for d in (2, 4):
        top, _ = _window_case(jcsr, tcsr, d, _xn(12000), fill_rnd_vector(12000, seed=9),
                              with_jax=d == 4)
        assert top.halo_ok


def test_window_sharded_all_gather():
    """Shards smaller than their window reach (one block of g = 16 each,
    h_right 23 rows): the all-gather branch, held the same way."""
    tcsr, jcsr = _csr_pair(synth.fem_like(m=2048, n=2048, nnz=16384, spread=900, lo=4, hi=12,
                                          seed=9))
    top, y = _window_case(jcsr, tcsr, 8, _xn(2048), fill_rnd_vector(2048, seed=10))
    assert not top.halo_ok
    xn = torch.as_tensor(_xn(2048), dtype=torch.float32)
    # x_lo is where the kernel's staging starts: a whole x at x_lo = 0 gives
    # the unsharded product, and an x_lo the kernel cannot take raises
    assert torch.equal(twc.window_spmv_reference(top.layout, xn, 0), y)
    with pytest.raises(ValueError, match="x_lo"):
        twc._check_window(top.shards[0], xn, x_lo=64)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def test_ppermute_wraps_around_and_copies():
    _, tm = _meshes((4, 1))
    parts = [torch.full((3,), float(i)) for i in range(4)]
    right = C.ppermute(parts, tm, TM.ROWS, [(j, (j + 1) % 4) for j in range(4)])
    assert [int(p[0]) for p in right] == [3, 0, 1, 2]
    part = C.ppermute(parts, tm, TM.ROWS, [(0, 2)])
    assert [int(p[0]) for p in part] == [0, 0, 0, 0] and part[0].data_ptr() != parts[0].data_ptr()
    # on one device a ppermute is a copy, never an alias
    for out in (right, C.ppermute(parts, tm, TM.ROWS, [(j, j) for j in range(4)])):
        assert all(o.data_ptr() != p.data_ptr() for o in out for p in parts)
    right[1].add_(100.0)
    assert torch.equal(parts[0], torch.zeros(3))


def test_psum_adds_in_shard_order_and_gathers():
    _, tm = _meshes((1, 4))
    rng = np.random.default_rng(0)
    parts = [torch.as_tensor(rng.standard_normal(1000) * 10.0 ** k, dtype=torch.float32)
             for k in range(4)]
    out = C.psum(parts, tm, TM.COLS)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert all(torch.equal(o, want) for o in out)
    assert len({o.data_ptr() for o in out} | {p.data_ptr() for p in parts}) == 8
    assert all(torch.equal(a, b) for a, b in zip(out, C.psum(parts, tm, TM.COLS)))
    gathered = C.all_gather(parts, tm, TM.COLS)
    assert all(torch.equal(g, torch.cat(parts)) for g in gathered)
    assert C.axis_index(tm, TM.COLS) == [0, 1, 2, 3]


def test_mesh_shards_and_replicas():
    tm = TM.make_mesh((4, 2), devices=[CPU] * 8)
    assert tm.shape == {TM.ROWS: 4, TM.COLS: 2} and tm.size == 8
    t = torch.arange(8.0)
    rows = TM.row_shards(t, tm)
    assert [p.tolist() for p in rows] == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    reps = TM.replicate(t, tm, TM.COLS)
    assert len(reps) == 2 and all(r.data_ptr() != t.data_ptr() and torch.equal(r, t) for r in reps)
    with pytest.raises(ValueError):
        TM.make_mesh((3, 1), devices=[CPU] * 4)


def test_make_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TM.make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        contract.entry()
    with pytest.raises(RuntimeError, match="is_available"):
        contract.dryrun_multichip(4)
    TM.init_distributed(num_processes=1)  # one process: a no-op
    # under a group of several processes a rank's devices default to its
    # cards too: none raises before any exchange
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    with pytest.raises(RuntimeError, match="is_available"):
        TM.make_mesh((2, 1))


# ---------------------------------------------------------------------------
# the contract and the scaling harness
# ---------------------------------------------------------------------------


def test_dryrun_multichip_on_the_cpu(capsys):
    contract.dryrun_multichip(8, device="cpu")
    assert "all OK" in capsys.readouterr().out


def test_entry_on_the_cpu():
    fn, (mat, x) = contract.entry(device="cpu")
    coo = synth.banded(2048, 2048, 8, fill=0.9, seed=0)
    y = fn(mat, x)[:2048]
    csr = T.coo_to_csr(coo)
    _oracle_ok(y, csr, fill_rnd_vector(2048, seed=1))


def test_scaling_harness_smoke(capsys):
    rc = scaling.run_scaling("cavity10_like", [1, 2], "dia_halo", device="cpu")
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith("preset,path,virtual,devices,time_s,efficiency,ok")
    rows = [r.split(",") for r in out.strip().splitlines()[1:]]
    assert [(r[1], r[2], r[3], r[6]) for r in rows] == [("dia_halo", "1", "1", "1"),
                                                        ("dia_halo", "1", "2", "1")]
    assert scaling.main(["--preset", "cavity10_like", "--devices", "1", "2", "--path",
                         "dia_halo_df", "--virtual", "1"]) == 0
    assert capsys.readouterr().out.count("\n") == 2  # header and d = 1: d = 2 skipped
