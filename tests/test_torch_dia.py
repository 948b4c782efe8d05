"""DIA slice of the PyTorch port against the JAX package: the prepare steps
must be array-equal, and the plain version of the CUDA kernels must agree
with the JAX Pallas kernel (interpret mode on the CPU) on the same prepared
operands.

Tolerance of the kernel comparisons: |y_t - y_j| <= 1e-5*|y_j| +
1e-6*max|y_j| on x ~ N(0, 1). Both sides sum the same f32 (or bf16-exact)
products; only the order of the fringe sum differs. x of order 1 is used
because with the reference's |x| < 3e-5 even an all-zero y passes the
7e-4 oracle check."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import spmv_openmp_cuda_tpu as J
from spmv_openmp_cuda_tpu.formats import dia as jdia
from spmv_openmp_cuda_tpu.ops import spmv_pallas as jsp
from spmv_openmp_cuda_tpu.utils import synth as jsynth
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch.config import DOUBLE_DIFF_THRESH
from spmv_openmp_cuda_tpu_torch.formats import dia as tdia
from spmv_openmp_cuda_tpu_torch.io.vectors import fill_rnd_vector
from spmv_openmp_cuda_tpu_torch.ops import spmv_cuda as tsc
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu_torch.utils import synth as tsynth
from spmv_openmp_cuda_tpu_torch.utils.compare import vectors_diff

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _csrs(coo_args):
    gen, kw = coo_args
    return T.coo_to_csr(getattr(tsynth, gen)(**kw)), J.coo_to_csr(getattr(jsynth, gen)(**kw))


BANDED = ("banded", dict(m=700, n=700, bandwidth=7, fill=0.9, seed=2))
FRINGE = ("banded", dict(m=3000, n=3000, bandwidth=30, fill=1.0, exact_nnz=185000, seed=0))
RAEFSKY = ("preset", dict(name="raefsky1_like"))
CAVITY = ("preset", dict(name="cavity10_like"))
WIDE = ("banded", dict(m=600, n=600, bandwidth=300, fill=0.05, seed=3))


def _far_diagonals(m, n, offsets, seed):
    """The same few far-apart diagonals as COO in both packages (shifts
    reaching several row groups, cheap to trace)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(m)] * len(offsets))
    cols = rows + np.repeat(np.asarray(offsets), m)
    ok = (cols >= 0) & (cols < n)
    rows, cols = rows[ok], cols[ok]
    vals = rng.standard_normal(rows.shape[0])
    return (
        T.coo_to_csr(T.sort_coo(T.COOMatrix((m, n), rows, cols, vals))),
        J.coo_to_csr(J.sort_coo(J.COOMatrix((m, n), rows, cols, vals))),
    )


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_dia_equal(tmat, jmat):
    np.testing.assert_array_equal(_bits(tmat.data), _jbits(jmat.data))
    assert tmat.offsets == jmat.offsets
    assert tmat.offsets_dev.tolist() == list(jmat.offsets)
    assert (tmat.shape, tmat.nnz, tmat.pad_sub) == (jmat.shape, jmat.nnz, jmat.pad_sub)


def _port_operands(jmat, jplan, jdr=None):
    kw = {}
    if jdr is not None:
        kw = dict(
            rvals=np.asarray(jdr.rvals), rsidx=np.asarray(jdr.rsidx),
            rgid=np.asarray(jdr.rgid), rsrc=np.asarray(jdr.rsrc),
            k_pad=jdr.k_pad, nnz_resid=jdr.nnz_resid,
        )
    return tsc.from_jax_operands(
        np.asarray(jmat.data), jmat.offsets, jmat.shape, jmat.nnz, jmat.pad_sub,
        jplan.bs, jplan.nblocks, jplan.s_pad, **kw,
    )


def _close(y_t: torch.Tensor, y_j) -> None:
    y_j = np.asarray(y_j, np.float64)
    y_t = y_t.double().numpy()
    assert y_t.shape == y_j.shape
    bound = 1e-5 * np.abs(y_j) + 1e-6 * np.abs(y_j).max()
    assert np.all(np.abs(y_t - y_j) <= bound), np.abs(y_t - y_j).max()
    assert np.abs(y_j).max() > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [BANDED, CAVITY])
def test_prepare_dia_identical(case, dtype):
    tcsr, jcsr = _csrs(case)
    tdt, jdt = DTYPES[dtype]
    _assert_dia_equal(tdia.prepare_dia(tcsr, dtype=tdt), jdia.prepare_dia(jcsr, dtype=jdt))
    np.testing.assert_array_equal(tdia.split_offsets(tcsr), jdia.split_offsets(jcsr))


@pytest.mark.parametrize(
    "case,vmem_budget,max_bs",
    [
        (BANDED, 8 << 10, None),
        (BANDED, 64 << 10, None),
        (BANDED, 2 << 20, None),
        (BANDED, 2 << 20, 42),
        (WIDE, 2 << 20, None),
    ],
)
def test_plan_dia_identical(case, vmem_budget, max_bs):
    tcsr, jcsr = _csrs(case)
    tmat = tdia.prepare_dia(tcsr, max_fill_ratio=1e9)
    jmat = jdia.prepare_dia(jcsr, max_fill_ratio=1e9)
    tplan = tsc.plan_dia(tmat, vmem_budget=vmem_budget, max_bs=max_bs)
    jplan = jsp.plan_dia(jmat, vmem_budget=vmem_budget, max_bs=max_bs)
    assert (tplan.bs, tplan.nblocks, tplan.s_pad) == (jplan.bs, jplan.nblocks, jplan.s_pad)
    _assert_dia_equal(tsc.pad_dia_for_pallas(tmat, tplan), jsp.pad_dia_for_pallas(jmat, jplan))


def test_plan_dia_rejects_band_too_wide_for_resid():
    # a diagonal 60000 columns out: pad_sub = 469 row groups
    tcsr, jcsr = _far_diagonals(2560, 65536, [60000], seed=44)
    with pytest.raises(tdia.DiaFillError):
        tsc.plan_dia(tdia.prepare_dia(tcsr, max_fill_ratio=1e9), max_bs=42)
    with pytest.raises(jdia.DiaFillError):
        jsp.plan_dia(jdia.prepare_dia(jcsr, max_fill_ratio=1e9), max_bs=42)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [RAEFSKY, FRINGE])
def test_prepare_dia_resid_identical(case, dtype):
    tcsr, jcsr = _csrs(case)
    tdt, jdt = DTYPES[dtype]
    tdr, tplan = tsc.prepare_dia_resid(tcsr, dia_dtype=tdt, vals_dtype=tdt)
    jdr, jplan = jsp.prepare_dia_resid(jcsr, dia_dtype=jdt, vals_dtype=jdt)
    assert (tplan.bs, tplan.nblocks, tplan.s_pad) == (jplan.bs, jplan.nblocks, jplan.s_pad)
    _assert_dia_equal(tdr.mat, jdr.mat)
    for f in ("rvals", "rsidx", "rgid", "rsrc"):
        np.testing.assert_array_equal(_bits(getattr(tdr, f)), _jbits(getattr(jdr, f)), err_msg=f)
    assert (tdr.k_pad, tdr.nnz_resid, tdr.n_ktiles) == (jdr.k_pad, jdr.nnz_resid, jdr.n_ktiles)
    assert tdr.nnz_resid > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [600, 70000])  # square, and wide (x clipped)
def test_pad_x_and_dia_rows_match_jax(dtype, n):
    tcsr, jcsr = _far_diagonals(600, n, [-290, -130, -1, 0, 5, 129, 300], seed=8)
    tdt, jdt = DTYPES[dtype]
    tmat = tdia.prepare_dia(tcsr, dtype=tdt, max_fill_ratio=1e9)
    jmat = jdia.prepare_dia(jcsr, dtype=jdt, max_fill_ratio=1e9)
    assert tmat.pad_sub == 3
    x = np.random.default_rng(8).standard_normal(n).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        _bits(tdia.pad_x_dia(xt, tmat)), _jbits(jdia.pad_x_dia(jnp.asarray(x), jmat))
    )
    if dtype == "float32":  # DIA_ROWS sums in the slab dtype
        _close(tdia.dia_spmv(tmat, xt), jdia.dia_spmv(jmat, jnp.asarray(x)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("resid", [False, True])
def test_plain_version_matches_jax_pallas(resid, dtype):
    tdt, jdt = DTYPES[dtype]
    csr = J.coo_to_csr(jsynth.preset("raefsky1_like" if resid else "cavity10_like"))
    if resid:
        jdr, jplan = jsp.prepare_dia_resid(csr, dia_dtype=jdt, vals_dtype=jdt)
        jmat = jdr.mat
    else:
        jdr = None
        jmat = jdia.prepare_dia(csr, dtype=jdt)
        jplan = jsp.plan_dia(jmat, vmem_budget=64 << 10)  # several blocks
        jmat = jsp.pad_dia_for_pallas(jmat, jplan)
    tmat, tplan, tdr = _port_operands(jmat, jplan, jdr)
    assert tmat.data.dtype == tdt
    assert jplan.nblocks > 1 or resid
    for x in (
        np.random.default_rng(11).standard_normal(csr.shape[1]).astype(np.float32),
        fill_rnd_vector(csr.shape[1], seed=12).astype(np.float32),
    ):
        y_j = jsp.dia_spmv_pallas(jmat, jnp.asarray(x), jplan, resid=jdr)
        y_t = tsc.dia_spmv_reference(tmat, torch.from_numpy(x), tplan, tdr)
        _close(y_t, y_j)
        # the wrapper takes the plain version for CPU tensors
        y_w = tsc.dia_spmv_cuda(tmat, torch.from_numpy(x), tplan, tdr)
        torch.testing.assert_close(y_w, y_t, rtol=0, atol=0)
    rep = vectors_diff(y_t.double().numpy(), serial_csr_spmv(csr, x.astype(np.float64)),
                       threshold=DOUBLE_DIFF_THRESH)
    assert rep.ok, rep


def test_fringe_reference_is_the_residual_part():
    tcsr = T.coo_to_csr(tsynth.banded(3000, 3000, 30, fill=1.0, exact_nnz=185000, seed=0))
    dr, plan = tsc.prepare_dia_resid(tcsr)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(3000).astype(np.float32))
    kept = tsc.dia_spmv_reference(dr.mat, x, plan)
    y = torch.zeros(plan.s_pad * 128)
    tsc.dia_resid_cuda(dr, x, y, plan)  # CPU tensors: plain version, in place
    full = tsc.dia_spmv_reference(dr.mat, x, plan, dr)
    torch.testing.assert_close(kept + y[:3000], full, rtol=1e-6, atol=1e-6)
    # the fringe alone against the oracle of the fringe entries
    keep = tdia.split_offsets(tcsr)
    rows = tcsr.row_ids()[~keep]
    ref = np.zeros(3000)
    np.add.at(ref, rows, tcsr.data[~keep] * x.double().numpy()[tcsr.indices[~keep]])
    np.testing.assert_allclose(y[:3000].double().numpy(), ref, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_bad_input():
    csr = T.coo_to_csr(tsynth.banded(500, 500, 5, seed=1))
    mat = tdia.prepare_dia(csr)
    plan = tsc.plan_dia(mat)
    mat = tsc.pad_dia_for_pallas(mat, plan)
    x = torch.zeros(500)
    with pytest.raises(TypeError):
        tsc.dia_spmv_cuda(mat, x.double(), plan)
    with pytest.raises(ValueError):
        tsc.dia_spmv_cuda(mat, torch.zeros(499), plan)
    with pytest.raises(ValueError):
        tsc.dia_spmv_cuda(mat, torch.zeros(1000)[::2], plan)
    with pytest.raises(ValueError):
        tsc.dia_spmv_cuda(mat, x, tsc.DiaPlan(bs=plan.bs, nblocks=plan.nblocks + 1,
                                              s_pad=plan.s_pad + plan.bs))
    with pytest.raises(ValueError):
        tsc.dia_spmv_cuda(mat, x.to("meta"), plan)


def test_from_jax_operands_rejects_bad_indices():
    csr = J.coo_to_csr(jsynth.banded(3000, 3000, 30, fill=1.0, exact_nnz=185000, seed=0))
    jdr, jplan = jsp.prepare_dia_resid(csr)
    bad = np.asarray(jdr.rgid).copy()
    bad[0, 0] = jplan.bs
    with pytest.raises(ValueError):
        tsc.from_jax_operands(
            np.asarray(jdr.mat.data), jdr.mat.offsets, jdr.mat.shape, jdr.mat.nnz,
            jdr.mat.pad_sub, jplan.bs, jplan.nblocks, jplan.s_pad,
            rvals=np.asarray(jdr.rvals), rsidx=np.asarray(jdr.rsidx), rgid=bad,
            rsrc=np.asarray(jdr.rsrc), k_pad=jdr.k_pad, nnz_resid=jdr.nnz_resid,
        )


def _wide_band_with_far_fringe():
    """A 3000 x 6000 band with two fringe entries whose columns (4300, 5000)
    lie past the JAX window's clip of x at (S + pad_sub) * 128 = 4224."""
    band = tsynth.banded(3000, 3000, 30, fill=1.0, seed=0)
    rows = np.r_[band.rows, [2998, 2999]]
    cols = np.r_[band.cols, [4300, 5000]]
    vals = np.r_[band.vals, [2.0, 1.0]]
    return T.coo_to_csr(T.sort_coo(T.COOMatrix((3000, 6000), rows, cols, vals)))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_resid_reads_x_past_the_clip_on_wide_matrices(dtype):
    # the JAX kernel drops these two products (ROADMAP.md queue 3); the port
    # must not
    csr = _wide_band_with_far_fringe()
    tdt, _ = DTYPES[dtype]
    dr, plan = tsc.prepare_dia_resid(csr, dia_dtype=tdt, vals_dtype=tdt)
    assert dr.nnz_resid == 2 and (plan.s_pad + dr.mat.pad_sub) * 128 < 4300
    x = np.random.default_rng(1).standard_normal(6000).astype(np.float32)
    y = tsc.dia_spmv_cuda(dr.mat, torch.from_numpy(x), plan, dr).double().numpy()
    # A and x as the slab dtype rounds them
    xr = torch.from_numpy(x).to(tdt).double().numpy()
    ar = torch.from_numpy(csr.data).to(tdt).double().numpy()
    o = serial_csr_spmv(T.CSRMatrix(csr.shape, csr.indptr, csr.indices, ar), xr)
    assert np.abs(y - o).max() <= 1e-5 * np.abs(o).max()
