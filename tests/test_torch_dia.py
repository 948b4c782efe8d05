"""DIA slice of the PyTorch port against the JAX package: the prepare steps
must be array-equal, and the plain version of the CUDA kernels must agree
with the JAX Pallas kernel (interpret mode on the CPU) on the same prepared
operands.

Tolerance of the kernel comparisons: |y_t - y_j| <= 1e-5*|y_j| +
1e-6*max|y_j| on x ~ N(0, 1). Both sides sum the same f32 (or bf16-exact)
products; only the order of the fringe sum differs. x of order 1 is used
because with the reference's |x| < 3e-5 even an all-zero y passes the
7e-4 oracle check."""
import ctypes
import dataclasses
import os
import re

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
from spmv_openmp_cuda_tpu_torch.ops import cuda_lib
from spmv_openmp_cuda_tpu_torch.ops import spmv_cuda as tsc
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu_torch.utils import synth as tsynth
from spmv_openmp_cuda_tpu_torch.utils.compare import vectors_diff
from torch_numpy_path import numpy_path


@pytest.fixture(autouse=True, scope="module")
def _numpy_prepare():
    """The port's numpy prepare paths (see torch_numpy_path)."""
    with numpy_path():
        yield


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
        jplan.bs, jplan.nblocks, jplan.s_pad, device="cpu", **kw,
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
    _assert_dia_equal(tdia.prepare_dia(tcsr, dtype=tdt, device="cpu"), jdia.prepare_dia(jcsr, dtype=jdt))
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
    tmat = tdia.prepare_dia(tcsr, max_fill_ratio=1e9, device="cpu")
    jmat = jdia.prepare_dia(jcsr, max_fill_ratio=1e9)
    tplan = tsc.plan_dia(tmat, vmem_budget=vmem_budget, max_bs=max_bs)
    jplan = jsp.plan_dia(jmat, vmem_budget=vmem_budget, max_bs=max_bs)
    assert (tplan.bs, tplan.nblocks, tplan.s_pad) == (jplan.bs, jplan.nblocks, jplan.s_pad)
    _assert_dia_equal(tsc.pad_dia_for_pallas(tmat, tplan), jsp.pad_dia_for_pallas(jmat, jplan))


def test_plan_dia_rejects_band_too_wide_for_resid():
    # a diagonal 60000 columns out: pad_sub = 469 row groups
    tcsr, jcsr = _far_diagonals(2560, 65536, [60000], seed=44)
    with pytest.raises(tdia.DiaFillError):
        tsc.plan_dia(tdia.prepare_dia(tcsr, max_fill_ratio=1e9, device="cpu"), max_bs=42)
    with pytest.raises(jdia.DiaFillError):
        jsp.plan_dia(jdia.prepare_dia(jcsr, max_fill_ratio=1e9), max_bs=42)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [RAEFSKY, FRINGE])
def test_prepare_dia_resid_identical(case, dtype):
    tcsr, jcsr = _csrs(case)
    tdt, jdt = DTYPES[dtype]
    tdr, tplan = tsc.prepare_dia_resid(tcsr, dia_dtype=tdt, vals_dtype=tdt, device="cpu")
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
    tmat = tdia.prepare_dia(tcsr, dtype=tdt, max_fill_ratio=1e9, device="cpu")
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
        xt = torch.from_numpy(x)
        if tdr is None:
            y_w = tsc.dia_spmv_cuda(tmat, xt, tplan)
        else:
            y_w = tsc.dia_resid_spmv_cuda(tdr, xt, tplan)
        torch.testing.assert_close(y_w, y_t, rtol=0, atol=0)
    rep = vectors_diff(y_t.double().numpy(), serial_csr_spmv(csr, x.astype(np.float64)),
                       threshold=DOUBLE_DIFF_THRESH)
    assert rep.ok, rep


def test_fringe_reference_is_the_residual_part():
    tcsr = T.coo_to_csr(tsynth.banded(3000, 3000, 30, fill=1.0, exact_nnz=185000, seed=0))
    dr, plan = tsc.prepare_dia_resid(tcsr, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(3000).astype(np.float32))
    kept = tsc.dia_spmv_reference(dr.mat, x, plan)
    y = tsc.dia_resid_reference(dr, x, plan)  # the fringe alone, all s_pad*128 rows
    assert y.shape == (plan.s_pad * 128,)
    full = tsc.dia_spmv_reference(dr.mat, x, plan, dr)
    torch.testing.assert_close(kept + y[:3000], full, rtol=1e-6, atol=1e-6)
    # the whole-product wrapper takes the plain version for CPU tensors
    torch.testing.assert_close(tsc.dia_resid_spmv_cuda(dr, x, plan), full, rtol=0, atol=0)
    # the fringe alone against the oracle of the fringe entries
    keep = tdia.split_offsets(tcsr)
    rows = tcsr.row_ids()[~keep]
    ref = np.zeros(3000)
    np.add.at(ref, rows, tcsr.data[~keep] * x.double().numpy()[tcsr.indices[~keep]])
    np.testing.assert_allclose(y[:3000].double().numpy(), ref, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_bad_input():
    csr = T.coo_to_csr(tsynth.banded(500, 500, 5, seed=1))
    mat = tdia.prepare_dia(csr, device="cpu")
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
            device="cpu",
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
    dr, plan = tsc.prepare_dia_resid(csr, dia_dtype=tdt, vals_dtype=tdt, device="cpu")
    assert dr.nnz_resid == 2 and (plan.s_pad + dr.mat.pad_sub) * 128 < 4300
    x = np.random.default_rng(1).standard_normal(6000).astype(np.float32)
    y = tsc.dia_resid_spmv_cuda(dr, torch.from_numpy(x), plan).double().numpy()
    # A and x as the slab dtype rounds them
    xr = torch.from_numpy(x).to(tdt).double().numpy()
    ar = torch.from_numpy(csr.data).to(tdt).double().numpy()
    o = serial_csr_spmv(T.CSRMatrix(csr.shape, csr.indptr, csr.indices, ar), xr)
    assert np.abs(y - o).max() <= 1e-5 * np.abs(o).max()


# ---------------------------------------------------------------------------
# the fringe as per-row lists (what the DIA+residual kernels read)
# ---------------------------------------------------------------------------

#: a fully dense band: prepare_dia_resid keeps every diagonal, the fringe is
#: empty; a band of 6000 rows: two TPU blocks (nblocks > 1)
EMPTY = ("banded", dict(m=700, n=700, bandwidth=7, fill=1.0, seed=2))
TWO_BLOCKS = ("banded", dict(m=6000, n=6000, bandwidth=30, fill=1.0, exact_nnz=371000, seed=0))
LIST_CASES = {"raefsky1": RAEFSKY, "empty": EMPTY, "two_blocks": TWO_BLOCKS, "past_clip": None}
_LIST_MEMO = {}


def _list_case(case, dtype):
    """(port csr, port (DiaResid, plan), JAX (DiaResid, plan)) of a case, its
    slab and fringe values in dtype."""
    key = (case, dtype)
    if key not in _LIST_MEMO:
        tdt, jdt = DTYPES[dtype]
        if LIST_CASES[case] is None:
            tcsr = _wide_band_with_far_fringe()
            jcsr = J.CSRMatrix(shape=tcsr.shape, indptr=tcsr.indptr, indices=tcsr.indices,
                               data=tcsr.data)
        else:
            tcsr, jcsr = _csrs(LIST_CASES[case])
        _LIST_MEMO[key] = (
            tcsr,
            tsc.prepare_dia_resid(tcsr, dia_dtype=tdt, vals_dtype=tdt, device="cpu"),
            jsp.prepare_dia_resid(jcsr, dia_dtype=jdt, vals_dtype=jdt),
        )
    return _LIST_MEMO[key]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(LIST_CASES))
def test_fringe_lists_from_jax_equal_the_ports(case, dtype):
    """The lists built from the JAX package's prepared DiaResid (through
    from_jax_operands) and from the port's own prepare are the same arrays,
    one entry per fringe nnz, in ascending row and, within a row, slot row."""
    tcsr, (tdr, tplan), (jdr, jplan) = _list_case(case, dtype)
    _, fplan, fdr = _port_operands(jdr.mat, jplan, jdr)
    assert fplan == tplan
    for f in ("row_ptr", "fr_val", "fr_col"):
        np.testing.assert_array_equal(getattr(fdr, f).numpy(), getattr(tdr, f).numpy(), err_msg=f)
    assert tdr.fr_lo is None and fdr.fr_lo is None
    m = tcsr.shape[0]
    assert tdr.row_ptr.dtype == torch.int32 and tdr.row_ptr.shape == (m + 1,)
    assert tdr.fr_val.dtype == torch.float32 and tdr.fr_col.dtype == torch.int32
    assert tdr.fr_val.shape == (tdr.nnz_resid,) and (tdr.nnz_resid == 0) == (case == "empty")
    # the lists hold the fringe nnz: (row, column, value as the slab dtype stores it)
    keep = tdia.split_offsets(tcsr)
    rows = tcsr.row_ids()[~keep]
    lens = np.diff(tdr.row_ptr.numpy())
    np.testing.assert_array_equal(np.repeat(np.arange(m), lens), rows)
    np.testing.assert_array_equal(tdr.fr_col.numpy(), tcsr.indices[~keep])
    tdt, _ = DTYPES[dtype]
    want = torch.from_numpy(tcsr.data[~keep]).to(tdt).float()
    np.testing.assert_array_equal(tdr.fr_val.numpy(), want.numpy())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(LIST_CASES))
def test_list_sums_match_the_reference_and_jax(case, dtype):
    """A plain sum over the lists, each row's entries added in list order
    (resid_lists_reference, dia_resid_kernel's order), plus the diagonal
    sum, against dia_spmv_reference and the JAX Pallas kernel (interpret
    mode), which sums the same products in another order. The JAX kernel
    drops the past-clip matrix's two far products (ROADMAP.md queue 3):
    that case is held to the oracle of A and x as the slab dtype rounds
    them instead."""
    tcsr, (tdr, tplan), (jdr, jplan) = _list_case(case, dtype)
    m, n = tcsr.shape
    x = np.random.default_rng(21).standard_normal(n).astype(np.float32)
    xt = torch.from_numpy(x)
    fringe = tsc.resid_lists_reference(tdr, xt)
    assert fringe.shape == (m,) and fringe.dtype == torch.float32
    ref_fringe = tsc.dia_resid_reference(tdr, xt, tplan)[:m]
    torch.testing.assert_close(fringe, ref_fringe, rtol=1e-5, atol=1e-6 * max(ref_fringe.abs().max(), 1))
    y = tsc.dia_spmv_reference(tdr.mat, xt, tplan) + fringe
    _close(y, tsc.dia_spmv_reference(tdr.mat, xt, tplan, tdr).numpy())
    if case == "past_clip":
        tdt, _ = DTYPES[dtype]
        xr = xt.to(tdt).double().numpy()
        ar = torch.from_numpy(tcsr.data).to(tdt).double().numpy()
        _close(y, serial_csr_spmv(T.CSRMatrix(tcsr.shape, tcsr.indptr, tcsr.indices, ar), xr))
    else:
        _close(y, jsp.dia_spmv_pallas(jdr.mat, jnp.asarray(x), jplan, resid=jdr))


@pytest.mark.parametrize(
    "m,n_diag,groups",
    [(3242, 91, 16), (200000, 61, 1), (3000, 61, 16), (6000, 61, 8), (16000, 61, 4), (40000, 61, 1),
     (3242, 5, 4), (3242, 1, 1), (1, 91, 16)],
)
def test_launch_groups(m, n_diag, groups):
    """Threads per row double while the grid has fewer CTAs than the H100's
    132 SMs, up to 16 and to the diagonal count."""
    assert tsc.launch_groups(m, n_diag) == groups
    ctas = -(-m * groups // tsc.RESID_THREADS)
    assert ctas >= tsc.SMS or groups == min(tsc.MAX_GROUPS, 1 << (n_diag.bit_length() - 1))
    assert groups == 1 or -(-m * groups // 2 // tsc.RESID_THREADS) < tsc.SMS


def test_resid_layout_check_rejects_broken_lists():
    """The layout check the kernels' wrapper runs once per layout (here on
    CPU tensors, which it takes as they are): it passes the prepared lists
    and refuses missing, misshapen or unordered ones."""
    tcsr, (dr, plan), _ = _list_case("two_blocks", "float32")
    cpu = torch.device("cpu")
    tsc._check_resid_layout(dr, plan, cpu)
    bad_ptr = dr.row_ptr.clone()
    bad_ptr[-1] += 1
    down = dr.row_ptr.clone()
    down[5], down[6] = down[6] + 1, down[5]
    for broken in (
        dataclasses.replace(dr, row_ptr=None),
        dataclasses.replace(dr, fr_val=None),
        dataclasses.replace(dr, row_ptr=bad_ptr),
        dataclasses.replace(dr, row_ptr=down),
        dataclasses.replace(dr, row_ptr=dr.row_ptr[:-1].contiguous()),
        dataclasses.replace(dr, fr_col=dr.fr_col.long()),
        dataclasses.replace(dr, fr_val=dr.fr_val[:-1]),
        dataclasses.replace(dr, fr_lo=dr.fr_val),
    ):
        with pytest.raises((ValueError, TypeError)):
            tsc._check_resid_layout(broken, plan, cpu)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """t's values in a contiguous tensor that starts off a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype)
    k = next(k for k in range(1, 16) if (buf.data_ptr() + k * t.element_size()) % 16)
    out = buf[k : k + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def _rows_layout(dtype=torch.float32):
    csr = T.coo_to_csr(tsynth.banded(500, 500, 5, seed=1))
    mat = tdia.prepare_dia(csr, dtype=dtype, device="cpu")
    plan = tsc.plan_dia(mat)
    return tsc.pad_dia_for_pallas(mat, plan), plan


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rows_layout_check_rejects_broken_layouts(dtype):
    """The check dia_rows_kernel's wrapper runs once per layout (here on CPU
    tensors, which it takes as they are): it passes the prepared layout and
    refuses a wrong dtype, a non-contiguous, misaligned or misshapen slab,
    wrong offsets, an inconsistent plan and a row count the slab does not
    hold."""
    mat, plan = _rows_layout(DTYPES[dtype][0])
    cpu = torch.device("cpu")
    tsc._check_rows_layout(mat, plan, cpu)
    nc = mat.data.transpose(0, 1).contiguous().transpose(0, 1)
    m, n = mat.shape
    for broken, p in (
        (dataclasses.replace(mat, data=mat.data.half()), plan),
        (dataclasses.replace(mat, data=mat.data.double()), plan),
        (dataclasses.replace(mat, data=nc), plan),
        (dataclasses.replace(mat, data=_misaligned(mat.data)), plan),
        (dataclasses.replace(mat, data=mat.data[:, :-1].contiguous()), plan),
        (dataclasses.replace(mat, offsets_dev=mat.offsets_dev.long()), plan),
        (dataclasses.replace(mat, offsets_dev=mat.offsets_dev[:-1]), plan),
        (mat, tsc.DiaPlan(bs=plan.bs, nblocks=plan.nblocks, s_pad=plan.s_pad + 1)),
        (dataclasses.replace(mat, shape=(plan.s_pad * 128 + 1, n)), plan),
        (dataclasses.replace(mat, shape=(0, n)), plan),
    ):
        with pytest.raises((ValueError, TypeError)):
            tsc._check_rows_layout(broken, p, cpu)


def test_rows_plan_is_kept_while_the_tensors_are_the_same(monkeypatch):
    """The rows kernels' plan is made (and the layout checked) at a layout's
    first launch and kept on it while its tensors are the same objects; a
    replaced tensor, or a new layout object, is checked again."""
    mat, plan = _rows_layout()
    cpu = torch.device("cpu")
    checks = []
    check = tsc._check_rows_layout
    monkeypatch.setattr(tsc, "_check_rows_layout", lambda *a: (checks.append(a), check(*a)))
    assert tsc._rows_plan(mat, plan, cpu) == tsc.rows_a_thread(500) == 1
    assert tsc._rows_plan(mat, plan, cpu) == 1 and len(checks) == 1
    mat.data = mat.data.clone()
    tsc._rows_plan(mat, plan, cpu)
    mat.offsets_dev = mat.offsets_dev.clone()
    tsc._rows_plan(mat, plan, cpu)
    assert len(checks) == 3
    tsc._rows_plan(dataclasses.replace(mat), plan, cpu)  # a new object: no plan on it
    tsc._rows_plan(mat, plan, cpu)
    assert len(checks) == 4
    mat.data = mat.data.double()  # a replaced tensor is checked before any launch
    with pytest.raises(TypeError):
        tsc._rows_plan(mat, plan, cpu)


class _Owner:
    """A layout stand-in: cuda_lib.kept_plan keeps its plan in __dict__."""


@pytest.mark.parametrize("change", ["none", "tensor", "geometry", "owner"])
def test_kept_plan(change):
    """cuda_lib.kept_plan, the plan cache of every wrapper: make() runs at
    the first call and again only when a tensor is replaced by another
    object (an equal one too), the geometry differs or the owner is a new
    object."""
    made = []
    owner, a, b = _Owner(), torch.zeros(3), torch.ones(2)

    def make():
        made.append(1)
        return len(made)

    assert cuda_lib.kept_plan(owner, (a, b), ("g", 1), make) == 1
    args = {"none": (owner, (a, b), ("g", 1)),
            "tensor": (owner, (a.clone(), b), ("g", 1)),
            "geometry": (owner, (a, b), ("g", 2)),
            "owner": (_Owner(), (a, b), ("g", 1))}[change]
    assert cuda_lib.kept_plan(*args, make) == (1 if change == "none" else 2)
    assert cuda_lib.kept_plan(*args, make) == len(made)  # the new plan is kept in turn


@pytest.mark.parametrize("g", [1, 2, 5, 131])
def test_laplacian_2d(g):
    """synth.laplacian_2d: 5g^2 - 4g entries sorted by (row, col), symmetric,
    4 on the diagonal and -1 on the grid's edges (diagonals 0, +-1, +-g),
    row sums 0 inside the grid."""
    coo = tsynth.laplacian_2d(g)
    r, c, v = coo.rows.astype(np.int64), coo.cols.astype(np.int64), coo.vals
    assert coo.shape == (g * g, g * g) and len(v) == 5 * g * g - 4 * g
    assert np.all(np.diff(r * g * g + c) > 0)
    dense = np.zeros(coo.shape)
    dense[r, c] = v
    np.testing.assert_array_equal(dense, dense.T)
    assert set(np.unique(c - r)) <= {0, 1, -1, g, -g} and np.all(v[r == c] == 4.0)
    assert np.all(v[r != c] == -1.0)
    assert np.all(np.minimum(r, c)[np.abs(c - r) == 1] % g != g - 1)  # no edge across a grid row
    if g > 2:
        inner = np.arange(g * g).reshape(g, g)[1:-1, 1:-1].ravel()
        np.testing.assert_array_equal(dense[inner].sum(axis=1), 0.0)


@pytest.mark.parametrize(
    "m,rows",
    [(2597, 1), (3242, 1), (1, 1), (134144, 1), (134145, 4), (1_000_000, 4), (2_164_760, 4)],
)
def test_rows_a_thread(m, rows):
    """Four rows a thread while m / 4 threads in CTAs of 256 still give the
    H100's 132 SMs a CTA each, else one (cavity10_like: 2597 rows; the
    1000 x 1000 grid's Laplacian: 10^6)."""
    assert tsc.rows_a_thread(m) == rows
    assert rows == 1 or -(-m // (rows * tsc.RESID_THREADS)) >= tsc.SMS
    assert rows == 4 or -(-m // (4 * tsc.RESID_THREADS)) < tsc.SMS


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_rows_product_on_a_ragged_row_count(dtype):
    """The plain DIA rows product (the CPU path of PL_DIA_ROWS and
    PL_DIA_BF16) against the JAX Pallas kernel on a 5-point pattern of a
    131 x 131 grid: offsets +-131 past one 128-row group, and m = 17161 not
    a multiple of 4 (the kernel's four rows a thread end in a partial
    group). Tolerance: the module's."""
    m = 131 * 131
    tcsr, jcsr = _far_diagonals(m, m, [-131, -1, 0, 1, 131], seed=9)
    tdt, jdt = DTYPES[dtype]
    tmat = tdia.prepare_dia(tcsr, dtype=tdt, device="cpu")
    jmat = jdia.prepare_dia(jcsr, dtype=jdt)
    tplan, jplan = tsc.plan_dia(tmat), jsp.plan_dia(jmat)
    tmat, jmat = tsc.pad_dia_for_pallas(tmat, tplan), jsp.pad_dia_for_pallas(jmat, jplan)
    assert m % 4 == 1 and tmat.offsets == (-131, -1, 0, 1, 131)
    x = np.random.default_rng(13).standard_normal(m).astype(np.float32)
    y_t = tsc.dia_spmv_cuda(tmat, torch.from_numpy(x), tplan)
    assert y_t.shape == (m,)
    _close(y_t, jsp.dia_spmv_pallas(jmat, jnp.asarray(x), jplan))


def test_dia_bindings_match_the_source():
    """csrc/dia_spmv.cu is compiled only on a machine with nvcc: hold each C
    function's parameter list against the ctypes argtypes bound to it."""
    src = open(os.path.join(os.path.dirname(tsc.__file__), "..", "csrc", "dia_spmv.cu")).read()
    body = src[src.index('extern "C" {'):]
    sigs = dict(re.findall(r"^(?:int|const char\*) (\w+)\(([^)]*)\)", body, re.M))

    class Fake:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = Fake()
    tsc._bind(lib)
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    for name, params in sigs.items():
        want = [kinds.get(re.sub(r"\s+\w+$", "", p.strip()), ctypes.c_void_p)
                for p in params.split(",")]
        assert getattr(lib, name).argtypes == want, name
    assert set(sigs) == {"dia_spmv_launch", "dia_resid_launch", "dia_error_string"}
