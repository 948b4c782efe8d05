"""Double-float (float64) slice of the PyTorch port against the JAX package:
the dfloat primitives bit for bit, the df prepares (DIA, DIA+residual,
window) array for array, hi and lo planes both, and the plain versions of
the df CUDA kernels against the JAX df engines (Pallas in interpret mode on
the CPU), then AutoSpMV and the CLI at float64. The routed df engine is in
tests/test_torch_df_routed.py.

Tolerances, on x ~ N(0, 1):
- port against JAX: max |y_t - y_j| <= 1e-12 * max|y_j|. Both carry (hi, lo)
  f32 pairs (48 bits); they differ only in the order of the compensated sums
  and in the rounding of the cross terms (XLA may contract them into FMAs).
- against the exact f64 oracle: 1e-11 * max|y|, 1e-10 for the chunked
  routed path (the JAX package's own bounds, tests/test_dfloat.py and
  tests/test_routed.py). f32 engines sit near 1e-7 there.

The JAX df engines need jax_enable_x64; it is scoped to each call with
`jax.enable_x64(True)`, so that it does not leak into the next test file of
the same worker.
"""
import ctypes
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu as J
from spmv_openmp_cuda_tpu.formats import window as jw
from spmv_openmp_cuda_tpu.models import auto as jauto
from spmv_openmp_cuda_tpu.ops import dfloat as jdf
from spmv_openmp_cuda_tpu.ops import spmv_pallas as jsp
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch import cli
from spmv_openmp_cuda_tpu_torch.config import Config
from spmv_openmp_cuda_tpu_torch.formats import dia as tdia
from spmv_openmp_cuda_tpu_torch.formats import window as tw
from spmv_openmp_cuda_tpu_torch.io.mmio import write_mtx
from spmv_openmp_cuda_tpu_torch.io.vectors import fill_rnd_vector
from spmv_openmp_cuda_tpu_torch.models import auto as tauto
from spmv_openmp_cuda_tpu_torch.ops import dfloat as tdf
from spmv_openmp_cuda_tpu_torch.ops import registry
from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc
from spmv_openmp_cuda_tpu_torch.ops import spmv_cuda as tsc
from spmv_openmp_cuda_tpu_torch.ops import window_cuda as twc
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu_torch.utils import synth as tsynth
from spmv_openmp_cuda_tpu_torch.utils.compare import vectors_diff

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
# primitives
# ---------------------------------------------------------------------------


def _f32(seed, n=4096):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)).astype(np.float32)


PRIMITIVES = {
    "two_sum": (lambda t, a, b: t.two_sum(a, b), lambda a, b: jdf.two_sum(a, b)),
    "two_prod": (lambda t, a, b: t.two_prod(a, b), lambda a, b: jdf.two_prod(a, b)),
    "df_mul_acc": (lambda t, a, b: t.df_mul_acc(a, b * 0.5, a * 0.25, b, b * 3.0, a),
                   lambda a, b: jdf.df_mul_acc(a, b * 0.5, a * 0.25, b, b * 3.0, a)),
    "df_add": (lambda t, a, b: t.df_add(a, b * 1e-7, b, a * 1e-7),
               lambda a, b: jw._df_add(a, b * 1e-7, b, a * 1e-7)),
    "halve_pairs": (
        lambda t, a, b: t.halve_pairs(
            [(a[800 * i : 800 * i + 800], b[800 * i : 800 * i + 800]) for i in range(5)], lambda p, q: t.df_add(*p, *q)),
        lambda a, b: jw._halve_pairs(
            [(a[800 * i : 800 * i + 800], b[800 * i : 800 * i + 800]) for i in range(5)], lambda p, q: jw._df_add(*p, *q)),
    ),
}


@pytest.mark.parametrize("name", list(PRIMITIVES))
def test_dfloat_primitives_bit_for_bit(name):
    """Eager JAX (one op per dispatch, no fusion) against the port's torch
    ops: the same f32 arithmetic, so the same bits."""
    a, b = _f32(1), _f32(2)
    t_fn, j_fn = PRIMITIVES[name]
    got = t_fn(tdf, torch.from_numpy(a), torch.from_numpy(b))
    want = j_fn(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        _equal(g, w, name)


def test_split_and_tree_sum():
    v = np.random.default_rng(3).standard_normal(5000) * 1e3
    hi, lo = tdf.split_f64(v)
    jhi, jlo = jdf.split_f64(v)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(lo, jlo)
    th, tl = tdf.split_f64_t(torch.from_numpy(v))
    _equal(th, hi)
    _equal(tl, lo)
    assert torch.equal(tdf.df_combine64(th, tl), torch.from_numpy(hi.astype(np.float64) + lo))
    with jax.enable_x64(True):
        sh, sl = jdf.split_f64_jnp(jnp.asarray(v))
    _equal(th, sh)
    _equal(tl, sl)
    # df_tree_sum is halve_pairs over an axis, all slices of a round at once
    h2, l2 = th.reshape(5, 1000), tl.reshape(5, 1000)
    want = tdf.halve_pairs([(h2[i], l2[i]) for i in range(5)], lambda p, q: tdf.df_add(*p, *q))
    got = tdf.df_tree_sum(h2, l2, dim=0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# DIA and DIA + residual
# ---------------------------------------------------------------------------


def _dia_prepared(name):
    def make():
        tcsr, jcsr = _pair(tsynth.preset(name))
        if name == "raefsky1_like":
            tr_, tp = tsc.prepare_dia_resid(tcsr, df=True)
            jr_, jp = jsp.prepare_dia_resid(jcsr, df=True)
            return tcsr, (tr_.mat, tp, tr_), (jr_.mat, jp, jr_)
        tm, tp = tsc.prepare_dia_df_pallas(tcsr)
        jm, jp = jsp.prepare_dia_df_pallas(jcsr)
        return tcsr, (tm, tp, None), (jm, jp, None)

    return _memo(("dia", name), make)


@pytest.mark.parametrize("name", ["cavity10_like", "raefsky1_like"])
def test_dia_df_prepare_array_equal(name):
    _, (tm, tp, tres), (jm, jp, jres) = _dia_prepared(name)
    assert isinstance(tm, tdia.DeviceDIADF)
    assert (tp.bs, tp.nblocks, tp.s_pad) == (jp.bs, jp.nblocks, jp.s_pad)
    _equal(tm.data, jm.data, "data")
    _equal(tm.data_lo, jm.data_lo, "data_lo")
    assert tm.offsets == jm.offsets and (tm.shape, tm.nnz, tm.pad_sub) == (jm.shape, jm.nnz, jm.pad_sub)
    if jres is not None:
        assert tres.nnz_resid == jres.nnz_resid > 0 and tres.k_pad == jres.k_pad
        for f in ("rvals", "rvals_lo", "rsidx", "rgid", "rsrc"):
            _equal(getattr(tres, f), getattr(jres, f), f)


@pytest.mark.parametrize("name", ["cavity10_like", "raefsky1_like"])
def test_dia_df_plain_matches_jax_and_oracle(name):
    tcsr, (tm, tp, tres), (jm, jp, jres) = _dia_prepared(name)
    x = _x(tcsr.shape[1])
    y_j = _jax_y(lambda xv: jsp.dia_spmv_pallas_df(jm, xv, jp, resid=jres), x)
    y_t = tsc.dia_spmv_df_cuda(tm, torch.from_numpy(x), tp, tres)
    assert _rel(y_t, y_j) <= 1e-12
    assert _rel(y_t, serial_csr_spmv(tcsr, x)) < 1e-11
    # the kernel pair's function: diagonals, then the fringe df-added
    xh, xl = tdf.split_f64_t(torch.from_numpy(x))
    yh, yl = tsc.dia_spmv_df_pair_reference(tm, xh, xl, tp, tres)
    m = tcsr.shape[0]
    assert torch.equal(tdf.df_combine64(yh[:m], yl[:m]), y_t)
    if tres is not None:
        fh, fl = tsc.dia_resid_df_reference(tres, xh, xl, tp)
        assert fh.shape == (tp.s_pad * 128,) and fh.abs().max() > 0


# ---------------------------------------------------------------------------
# window
# ---------------------------------------------------------------------------

WINDOW = {
    # tests/test_dfloat.py's xdirect matrix; a multi-block one
    "xdirect": (dict(m=3000, n=3000, nnz=27000, spread=900, lo=5, hi=14, seed=6), None),
    "multi_block": (dict(m=6000, n=6000, nnz=60000, spread=700, lo=4, hi=16, seed=7), dict(g=16)),
}


def _window_prepared(name):
    def make():
        gen, kw = WINDOW[name]
        tcsr, jcsr = _pair(tsynth.fem_like(**gen))
        if kw is None:
            return tcsr, tw.prepare_window_auto(tcsr, df=True), jw.prepare_window_auto(jcsr, df=True)
        return tcsr, tw.prepare_window(tcsr, df=True, **kw), jw.prepare_window(jcsr, df=True, **kw)

    return _memo(("window", name), make)


@pytest.mark.parametrize("name", list(WINDOW))
def test_window_df_prepare_and_plain_match_jax(name):
    tcsr, tm, jm = _window_prepared(name)
    assert tm.xdirect == (name == "xdirect") and tm.nblocks == jm.nblocks
    for f in ("vals", "vals_lo", "sidx", "gid", "rsrc"):
        _equal(getattr(tm, f), getattr(jm, f), f)
    for f in ("g", "k_pad", "k_c", "wr", "nspecs", "bps", "xdirect", "shared_w"):
        assert getattr(tm, f) == getattr(jm, f), f
    x = _x(tcsr.shape[1], seed=8)
    y_j = _jax_y(lambda xv: jw.window_spmv(jm, xv), x)
    y_t = twc.window_spmv(tm, torch.from_numpy(x))
    assert _rel(y_t, y_j) <= 1e-12
    assert _rel(y_t, serial_csr_spmv(tcsr, x)) < 1e-11


def test_window_f32_layout_is_the_df_hi_plane():
    """prepare_window's dtype enters only the final cast, and the split's hi
    word is f32(v): the f32 operands are the df layout without vals_lo."""
    tcsr, tm, _ = _window_prepared("multi_block")
    f32 = tw.prepare_window(tcsr, g=16)
    assert f32.vals_lo is None and torch.equal(f32.vals, tm.vals)
    for f in ("sidx", "gid", "rsrc"):
        assert torch.equal(getattr(f32, f), getattr(tm, f))
    x = torch.from_numpy(_x(tcsr.shape[1]))
    y32 = twc.window_spmv(dataclasses.replace(tm, vals_lo=None), x.float())
    assert torch.equal(y32, twc.window_spmv(f32, x.float()))


# ---------------------------------------------------------------------------
# the JAX package's prepared operands carried across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["dia", "dia_resid", "window"])
def test_df_from_jax_round_trips(engine):
    """The port's df engines on the JAX package's prepared arrays give the
    same y as on the port's own prepare (the same arrays)."""
    if engine in ("dia", "dia_resid"):
        tcsr, (tm, tp, tres), (jm, jp, jres) = _dia_prepared(
            "cavity10_like" if engine == "dia" else "raefsky1_like")
        kw = {}
        if jres is not None:
            kw = dict(rvals=np.asarray(jres.rvals), rsidx=np.asarray(jres.rsidx),
                      rgid=np.asarray(jres.rgid), rsrc=np.asarray(jres.rsrc), k_pad=jres.k_pad,
                      nnz_resid=jres.nnz_resid, rvals_lo=np.asarray(jres.rvals_lo))
        fm, fp, fres = tsc.from_jax_operands(
            np.asarray(jm.data), jm.offsets, jm.shape, jm.nnz, jm.pad_sub, jp.bs, jp.nblocks,
            jp.s_pad, data_lo=np.asarray(jm.data_lo), **kw)
        assert isinstance(fm, tdia.DeviceDIADF) and (fres is None) == (jres is None)
        x = torch.from_numpy(_x(tcsr.shape[1]))
        assert torch.equal(tsc.dia_spmv_df_cuda(fm, x, fp, fres), tsc.dia_spmv_df_cuda(tm, x, tp, tres))
        if jres is not None:
            with pytest.raises(ValueError, match="rvals_lo"):
                tsc.from_jax_operands(
                    np.asarray(jm.data), jm.offsets, jm.shape, jm.nnz, jm.pad_sub, jp.bs,
                    jp.nblocks, jp.s_pad, data_lo=np.asarray(jm.data_lo),
                    **dict(kw, rvals_lo=None))
    else:
        tcsr, tm, jm = _window_prepared("multi_block")
        fm = twc.window_from_jax(
            np.asarray(jm.vals), np.asarray(jm.sidx), np.asarray(jm.gid), np.asarray(jm.rsrc),
            jm.shape, jm.nnz, jm.g, jm.k_pad, jm.wr, jm.nspecs, jm.nblocks, jm.k_c, jm.bps,
            jm.xdirect, jm.shared_w, vals_lo=np.asarray(jm.vals_lo))
        x = torch.from_numpy(_x(tcsr.shape[1]))
        assert torch.equal(twc.window_spmv(fm, x), twc.window_spmv(tm, x))
# ---------------------------------------------------------------------------
# wrappers, registry, AutoSpMV, CLI
# ---------------------------------------------------------------------------


def test_df_bindings_match_the_source():
    """csrc/df_spmv.cu is compiled only on a machine with nvcc: hold each C
    function's parameter list against the ctypes argtypes bound to it."""
    src = open(os.path.join(os.path.dirname(tdf.__file__), "..", "csrc", "df_spmv.cu")).read()
    body = src[src.index('extern "C" {'):]
    sigs = dict(re.findall(r"^(?:int|long long|const char\*) (\w+)\(([^)]*)\)", body, re.M))

    class Fake:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = Fake()
    tdf._bind(lib)
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    for name, params in sigs.items():
        want = [kinds.get(re.sub(r"\s+\w+$", "", p.strip()), ctypes.c_void_p)
                for p in params.split(",")]
        assert getattr(lib, name).argtypes == want, name
    assert set(sigs) >= {"dia_df_launch", "dia_resid_df_launch", "window_df_launch",
                         "window_df_scratch_elems", "routed_df_gather_launch"}


def test_df_wrappers_check_on_the_cpu():
    tcsr, (tm, tp, tres), _ = _dia_prepared("raefsky1_like")
    x = torch.from_numpy(_x(tcsr.shape[1]))
    with pytest.raises(TypeError):
        tsc.dia_spmv_df_cuda(tm, x.float(), tp, tres)
    with pytest.raises(TypeError, match="dia_spmv_df_cuda"):
        tsc.dia_spmv_cuda(tm, x.float(), tp)  # the f32 kernel refuses a df slab
    with pytest.raises(ValueError):
        tsc.dia_spmv_df_cuda(tm, x.to("meta"), tp, tres)
    xh, xl = tdf.split_f64_t(x)
    with pytest.raises(ValueError, match="CUDA"):
        tsc.dia_resid_df_cuda(tres, xh, xl, xh, xl, tp)
    wcsr, wm, _ = _window_prepared("xdirect")
    with pytest.raises(TypeError):
        twc.window_spmv(wm, torch.zeros(wcsr.shape[1]))
    with pytest.raises(TypeError):
        twc.window_single_cuda(wm, torch.zeros(wcsr.shape[1]), torch.zeros(wcsr.shape[0]))
    with pytest.raises(ValueError, match="CUDA"):
        z = torch.zeros(wcsr.shape[1])
        twc.window_df_cuda(wm, z, z, z, z)
    for fn in (tsc.dia_spmv_df_cuda, tsc.dia_resid_df_cuda, twc.window_df_cuda):
        assert fn.launches == 0


@pytest.mark.parametrize("mode", ["PL_DIA_F64", "PL_DIA_RESID_F64", "PL_CSR_WINDOW_F64",
                                  "PL_CSR_ROUTED_F64"])
def test_registered_f64_modes_on_the_cpu(mode):
    spec = registry.get(mode)
    assert spec.f64 and spec.impl == "cuda"
    coo = {
        "PL_DIA_F64": lambda: tsynth.banded(1500, 1500, 6, fill=0.9, seed=3),
        "PL_DIA_RESID_F64": lambda: tsynth.banded(2500, 2500, 12, fill=1.0, exact_nnz=66000, seed=2),
        "PL_CSR_WINDOW_F64": lambda: tsynth.fem_like(3000, 3000, 27000, spread=900, lo=5, hi=14, seed=6),
        "PL_CSR_ROUTED_F64": lambda: tsynth.power_law(2000, 2000, avg_nnz_per_row=4.0, seed=11),
    }[mode]()
    csr = T.coo_to_csr(coo)
    ops = spec.prepare(csr, None, Config(dtype="float64"), torch.device("cpu"))
    x = fill_rnd_vector(csr.shape[1], seed=2)
    y = spec.jitted(ops)(torch.as_tensor(x, dtype=torch.float64))
    assert y.dtype == torch.float64
    assert vectors_diff(y.numpy(), serial_csr_spmv(csr, x)).ok
    xn = _x(csr.shape[1])
    assert _rel(spec.jitted(ops)(torch.from_numpy(xn)), serial_csr_spmv(csr, xn)) < 1e-11


AUTO = {
    "dia": lambda: tsynth.preset("cavity10_like"),
    "dia_resid": lambda: tsynth.banded(2500, 2500, 12, fill=1.0, exact_nnz=66000, seed=2),
    "window": lambda: tsynth.fem_like(3000, 3000, 27000, spread=900, lo=5, hi=14, seed=6),
    "routed": lambda: tsynth.power_law(2000, 2000, avg_nnz_per_row=4.0, seed=11),
}


@pytest.mark.parametrize("fmt", list(AUTO))
def test_auto_spmv_f64_on_the_cpu(fmt):
    tcsr, jcsr = _pair(AUTO[fmt]())
    assert jauto.select_format(jcsr) == fmt
    model = tauto.AutoSpMV.from_csr(tcsr, cfg=Config(dtype="float64"), device="cpu")
    assert model.format == fmt and model.dtype == "float64"
    x = _x(tcsr.shape[1], seed=9)
    y = model(x)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float64 and y.shape == (tcsr.shape[0],)
    assert _rel(y, serial_csr_spmv(tcsr, x)) < 1e-11


def test_auto_spmv_f64_falls_back_to_the_df_routed_engine():
    rnd = T.coo_to_csr(tsynth.random_uniform(400, 400, 0.02, seed=3))
    model = tauto.AutoSpMV.from_csr(rnd, cfg=Config(dtype="float64"), format="dia", device="cpu")
    assert model.format == "routed" and isinstance(model._operands, trc.RoutedDFChain)
    x = _x(400)
    assert _rel(model(x), serial_csr_spmv(rnd, x)) < 1e-11
    # the explicit formats run native f64 torch engines; lanes (an f32
    # kernel) maps to binned, as in the JAX package
    for fmt, want in (("lanes", "binned"), ("ell_t", "ell_t"), ("binned", "binned")):
        model = tauto.AutoSpMV.from_csr(rnd, cfg=Config(dtype="float64"), format=fmt, device="cpu")
        assert model.format == want
        y = model(x)
        assert y.dtype == torch.float64 and _rel(y, serial_csr_spmv(rnd, x)) < 1e-11


@pytest.fixture
def raefsky_mtx(tmp_path):
    path = str(tmp_path / "raefsky1_like.mtx")
    write_mtx(path, tsynth.preset("raefsky1_like"))
    return path


@pytest.mark.parametrize("how", ["flag", "env"])
def test_cli_f64_auto(raefsky_mtx, how, capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    extra = ["--dtype", "float64"] if how == "flag" else []
    if how == "env":
        monkeypatch.setenv("SPMV_DTYPE", "float64")
    rc = cli.main([raefsky_mtx, "RNDVECT", "AUTO", "--device", "cpu", "--check", *extra])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "#auto: format=dia_resid -> PL_DIA_RESID_F64" in out and "#check: OK" in out
    assert "computeMode:PL_DIA_RESID_F64 elapsed:" in out
    # y is dumped in f64
    y = np.fromfile(os.path.join(str(tmp_path), "outVectorDumpRaw"), dtype=np.float64)
    assert y.shape == (3242,)


def test_cli_f64_remaps_and_refusals(raefsky_mtx, capsys):
    rc = cli.main([raefsky_mtx, "RNDVECT", "PL_DIA_ROWS", "--dtype", "float64", "--device", "cpu",
                   "--check", "--no-dump"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "#dtype: float64 unsupported by CUDA mode PL_DIA_ROWS; remapping to PL_DIA_F64" in out
    assert "#check: OK" in out and "computeMode:PL_DIA_F64 " in out
    # the JAX package sends every other f32 CUDA mode to CSR_ROWS_BINNED,
    # native f64
    rc = cli.main([raefsky_mtx, "RNDVECT", "PL_CSR_WINDOW", "--dtype", "float64", "--device", "cpu",
                   "--check", "--no-dump"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "#dtype: float64 unsupported by CUDA mode PL_CSR_WINDOW; remapping to CSR_ROWS_BINNED" in out
    assert "#check: OK" in out and "computeMode:CSR_ROWS_BINNED " in out
    # DIA_ROWS is plain torch: it runs in f64 as the JAX package's XLA mode does
    rc = cli.main([raefsky_mtx, "RNDVECT", "DIA_ROWS", "--dtype", "float64", "--device", "cpu",
                   "--check", "--no-dump"])
    assert rc == 0 and "computeMode:DIA_ROWS " in capsys.readouterr().out
