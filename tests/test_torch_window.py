"""Window slice of the PyTorch port against the JAX package: the host prepare
must be array-equal (same layout choice, same slabs, bf16 bit for bit), and
the plain version of the CUDA window kernels must agree with the JAX Pallas
kernel (interpret mode on the CPU) on the same prepared operands.

Tolerance of the kernel comparisons: |y_t - y_j| <= 1e-5*|y_j| +
1e-6*max|y_j| on x ~ N(0, 1). Both sides sum the same f32 products (bf16
values are exact in f32); only the order of the row sums differs. Against
the f64 oracle: 1e-5*max|y| + 1e-6 (f32 sums of <= ~30 terms)."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import spmv_openmp_cuda_tpu as J
from spmv_openmp_cuda_tpu.formats import window as jw
from spmv_openmp_cuda_tpu.io import native as jnative
from spmv_openmp_cuda_tpu.models import auto as jauto
from spmv_openmp_cuda_tpu.ops import route as jroute
from spmv_openmp_cuda_tpu.utils import synth as jsynth
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch import cli
from spmv_openmp_cuda_tpu_torch.formats import window as tw
from spmv_openmp_cuda_tpu_torch.io.mmio import write_mtx
from spmv_openmp_cuda_tpu_torch.io.vectors import fill_rnd_vector
from spmv_openmp_cuda_tpu_torch.models import auto as tauto
from spmv_openmp_cuda_tpu_torch.ops import registry
from spmv_openmp_cuda_tpu_torch.ops import route as troute
from spmv_openmp_cuda_tpu_torch.ops import window_cuda as twc
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu_torch.utils import synth as tsynth
from spmv_openmp_cuda_tpu_torch.utils.compare import vectors_diff
from torch_numpy_path import numpy_path


@pytest.fixture(autouse=True, scope="module")
def _numpy_prepare():
    """The port's numpy prepare paths (see torch_numpy_path)."""
    with numpy_path():
        yield


FEM = ("fem_like", dict(m=4000, n=4000, nnz=50000, spread=600, lo=5, hi=20, seed=2))
FEM_BIG = ("fem_like", dict(m=6000, n=6000, nnz=60000, spread=700, lo=4, hi=16, seed=7))
FEM_SINGLE = ("fem_like", dict(m=3000, n=3000, nnz=20000, spread=900, lo=4, hi=10, seed=9))
FEM_BANDS = ("fem_like", dict(m=12000, n=12000, nnz=120000, spread=1500, lo=4, hi=14, seed=5))
WIDE = ("banded", dict(m=900, n=1400, bandwidth=25, fill=0.9, seed=5))
TALL = ("banded", dict(m=1400, n=900, bandwidth=25, fill=0.9, seed=6))
BAND = ("banded", dict(m=2000, n=2000, bandwidth=35, fill=0.8, seed=1))
DELAUNAY = ("preset", dict(name="delaunay_n12_like"))
#: columns spread over ~160 chunks: no group size keeps the window under 128
SCATTERED = ("random_uniform", dict(m=20000, n=20000, density=1e-4, seed=3))
POWER_LAW = ("power_law", dict(m=900, n=900, avg_nnz_per_row=4.0, seed=11))

_MEMO = {}


def _csrs(case):
    """(port CSR, JAX CSR) of a generator case, built once per module."""
    key = repr(case)
    if key not in _MEMO:
        gen, kw = case
        _MEMO[key] = (
            T.coo_to_csr(getattr(tsynth, gen)(**kw)),
            J.coo_to_csr(getattr(jsynth, gen)(**kw)),
        )
    return _MEMO[key]


def _x(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return _bits(a)
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


STATIC = ("shape", "nnz", "g", "k_pad", "wr", "nspecs", "nblocks", "k_c", "bps",
          "xdirect", "shared_w")


def _assert_window_equal(tmat, jmat):
    for f in ("vals", "sidx", "gid", "rsrc"):
        t, j = _bits(getattr(tmat, f)), _jbits(getattr(jmat, f))
        assert t.dtype == j.dtype and t.shape == j.shape, f
        np.testing.assert_array_equal(t, j, err_msg=f)
    for f in STATIC:
        assert getattr(tmat, f) == getattr(jmat, f), f
    assert tmat.n_ktiles == jmat.n_ktiles


def _close(y_t, y_j):
    y_t, y_j = y_t.double().numpy(), np.asarray(y_j, np.float64)
    assert y_t.shape == y_j.shape
    bound = 1e-5 * np.abs(y_j) + 1e-6 * np.abs(y_j).max()
    assert np.all(np.abs(y_t - y_j) <= bound), np.abs(y_t - y_j).max()


def _oracle_close(y_t, csr, x):
    o = serial_csr_spmv(csr, x)
    assert np.abs(y_t.double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6


def _from_jax(jmat, device="cpu"):
    return twc.window_from_jax(
        np.asarray(jmat.vals), np.asarray(jmat.sidx), np.asarray(jmat.gid),
        np.asarray(jmat.rsrc), jmat.shape, jmat.nnz, jmat.g, jmat.k_pad, jmat.wr,
        jmat.nspecs, jmat.nblocks, jmat.k_c, jmat.bps, jmat.xdirect, jmat.shared_w,
        device=device,
    )


def test_numpy_prepare_path():
    # the array equality below compares the port's numpy fill with the JAX
    # package's numpy fill; with its native library built, the JAX package
    # fills by another path and only y is comparable
    assert not jnative.available()


def test_coloring_matches_jax():
    rng = np.random.default_rng(0)
    # a 16-regular bipartite multigraph on 64 + 64 nodes
    left = np.repeat(np.arange(64), 16)
    right = np.concatenate([rng.permutation(np.repeat(np.arange(64), 16))])
    ct = troute.color_bipartite_pow2(left, right, 16)
    np.testing.assert_array_equal(ct, jroute.color_bipartite_pow2(left, right, 16))
    for side in (left, right):
        assert np.unique(side * 16 + ct).shape[0] == left.shape[0]  # proper


PREPARE_CASES = {
    "global_cap_none": (FEM, dict(g=8, cap=None)),
    "forced_cap_overflow": (FEM, dict(g=16, cap=8, max_pad=20.0)),
    "cap_12_overflow": (FEM, dict(g=12, cap=16, max_pad=20.0)),
    "auto_cap": (FEM, dict(g=10)),
    "multiband_tuple": (FEM_BANDS, dict(g=24, cap=(16, 8), max_pad=8.0)),
    "bps2": (FEM_BIG, dict(g=8, bps=2)),
    "bps4_per_sub": (FEM_BIG, dict(g=16, bps=4, shared_w=False)),
    "bps3_padded": (FEM_BIG, dict(g=16, bps=3)),
    "shared_w": (FEM_BIG, dict(g=8, bps=4, shared_w=True)),
    "xdirect": (FEM_SINGLE, dict(g=24, xdirect=True)),
    "wide": (WIDE, dict(g=8)),
    "tall": (TALL, dict(g=8)),
    "bf16": (FEM, dict(g=16, vals_dtype="bf16")),
}


@pytest.mark.parametrize("name", list(PREPARE_CASES))
def test_prepare_window_array_equal(name):
    case, kw = PREPARE_CASES[name]
    tcsr, jcsr = _csrs(case)
    tkw, jkw = dict(kw), dict(kw)
    if kw.get("vals_dtype") == "bf16":
        tkw["vals_dtype"], jkw["vals_dtype"] = torch.bfloat16, jnp.bfloat16
    tmat = tw.prepare_window(tcsr, device="cpu", **tkw)
    jmat = jw.prepare_window(jcsr, **jkw)
    _assert_window_equal(tmat, jmat)
    if name == "multiband_tuple":
        assert tmat.k_c == 8 * 24
    if name == "shared_w":
        assert tmat.shared_w


def test_prepare_window_refusals_agree():
    tcsr, jcsr = _csrs(FEM_BIG)
    for kw in (dict(g=12, bps=2), dict(g=8, cap=(12, 4)), dict(g=8, cap=0),
               dict(g=8, xdirect=True), dict(g=8, cap=8, bps=32, max_pad=20.0)):
        with pytest.raises(jw.WindowError):
            jw.prepare_window(jcsr, **kw)
        with pytest.raises(tw.WindowError):
            tw.prepare_window(tcsr, device="cpu", **kw)
    assert tw._cap_bands(28) == jw._cap_bands(28) == (16, 8, 4)


@pytest.mark.parametrize("name", ["fem", "fem_big", "band", "wide", "delaunay"])
def test_prepare_window_auto_agrees(name):
    case = {"fem": FEM, "fem_big": FEM_BIG, "band": BAND, "wide": WIDE,
            "delaunay": DELAUNAY}[name]
    tcsr, jcsr = _csrs(case)
    assert tw.window_cost_scan(tcsr) == jw.window_cost_scan(jcsr)
    for g in (8, 16):
        assert tw.window_cost(tcsr, g) == jw.window_cost(jcsr, g)
    tmat = tw.prepare_window_auto(tcsr, device="cpu")
    _assert_window_equal(tmat, jw.prepare_window_auto(jcsr))
    if name == "delaunay":
        assert tmat.xdirect and tmat.nblocks == 1


def test_prepare_window_auto_pins_agree(monkeypatch):
    tcsr, jcsr = _csrs(FEM_BIG)
    _assert_window_equal(tw.prepare_window_auto(tcsr, bps=2, device="cpu"),
                         jw.prepare_window_auto(jcsr, bps=2))
    monkeypatch.setenv("SPMV_WINDOW_BPS", "1")
    _assert_window_equal(tw.prepare_window_auto(tcsr, device="cpu"), jw.prepare_window_auto(jcsr))


@pytest.mark.parametrize("name", ["scattered", "xdirect_multiblock"])
def test_window_error_on_the_same_inputs(name):
    if name == "scattered":
        tcsr, jcsr = _csrs(SCATTERED)
        calls = [lambda w, c, **d: w.prepare_window_auto(c, **d),
                 lambda w, c, **d: w.window_cost_scan(c)]
    else:
        tcsr, jcsr = _csrs(FEM_BANDS)  # 12000 rows: more than one block at any g
        calls = [lambda w, c, **d: w.prepare_window_auto(c, xdirect=True, **d)]
    for call in calls:
        with pytest.raises(jw.WindowError):
            call(jw, jcsr)
        with pytest.raises(tw.WindowError):
            call(tw, tcsr, device="cpu")


def test_bf16_operands_by_cast_equal_a_bf16_prepare():
    tcsr, jcsr = _csrs(FEM)
    f32 = tw.prepare_window_auto(tcsr, device="cpu")
    b16 = tw.prepare_window_auto(tcsr, vals_dtype=torch.bfloat16, device="cpu")
    cast = dataclasses.replace(f32, vals=f32.vals.to(torch.bfloat16))
    _assert_window_equal(cast, b16)
    _assert_window_equal(cast, jw.prepare_window_auto(jcsr, vals_dtype=jnp.bfloat16))


KERNEL_CASES = {
    "standard_overflow": (FEM, dict(g=12, cap=16, max_pad=20.0)),
    "standard_bps2": (FEM_BIG, dict(g=16, bps=2, shared_w=False)),
    "shared_w": (FEM_BIG, dict(g=8, bps=4, shared_w=True)),
    "xdirect": (FEM_SINGLE, dict(g=24, xdirect=True)),
    "bf16": (FEM, dict(g=16, vals_dtype="bf16")),
    "wide": (WIDE, dict(g=8)),
}


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_reference_matches_jax_kernel(name):
    case, kw = KERNEL_CASES[name]
    tcsr, jcsr = _csrs(case)
    jkw = dict(kw)
    if kw.get("vals_dtype") == "bf16":
        jkw["vals_dtype"] = jnp.bfloat16
    jmat = jw.prepare_window(jcsr, **jkw)
    x = _x(tcsr.shape[1])
    y_j = jw.window_spmv(jmat, jnp.asarray(x, jnp.float32))
    tmat = _from_jax(jmat)
    y_t = twc.window_spmv(tmat, torch.as_tensor(x, dtype=torch.float32))
    assert y_t.dtype == torch.float32 and y_t.shape == (tcsr.shape[0],)
    _close(y_t, y_j)
    if kw.get("vals_dtype") != "bf16":
        _oracle_close(y_t, tcsr, x)
    # the port's own prepare gives the same operands, so the same y
    if kw.get("vals_dtype") == "bf16":
        kw = dict(kw, vals_dtype=torch.bfloat16)
    y_p = twc.window_spmv(tw.prepare_window(tcsr, device="cpu", **kw), torch.as_tensor(x, dtype=torch.float32))
    assert torch.equal(y_p, y_t)


def test_window_from_jax_checks_ranges():
    _tcsr, jcsr = _csrs(FEM)
    jmat = jw.prepare_window(jcsr, g=16, cap=8, max_pad=20.0)
    ok = dict(vals=np.asarray(jmat.vals), sidx=np.asarray(jmat.sidx),
              gid=np.asarray(jmat.gid), rsrc=np.asarray(jmat.rsrc))
    static = {f: getattr(jmat, f) for f in STATIC}
    mat = twc.window_from_jax(**ok, device="cpu", **static)
    assert mat.g == 16 and mat.vals.dtype == torch.float32
    for field, bad in (("sidx", -1), ("rsrc", -3), ("gid", 16)):
        arr = ok[field].copy()
        arr[-1, 0] = bad
        with pytest.raises(ValueError):
            twc.window_from_jax(**dict(ok, **{field: arr}), device="cpu", **static)
    gid = ok["gid"].copy()
    gid[0, 0] = 2  # a fold row holds gid // 8 < ceil(16/8)
    with pytest.raises(ValueError):
        twc.window_from_jax(**dict(ok, gid=gid), device="cpu", **static)
    with pytest.raises(ValueError):
        twc.window_from_jax(**ok, **dict(static, nblocks=static["nblocks"] + 1), device="cpu")


def test_wrapper_checks_on_the_cpu():
    tcsr, _ = _csrs(FEM)
    mat = tw.prepare_window(tcsr, g=8, device="cpu")
    x = torch.as_tensor(_x(4000), dtype=torch.float32)
    with pytest.raises(TypeError):
        twc.window_spmv(mat, x.double())
    with pytest.raises(ValueError):
        twc.window_spmv(mat, x[:-1])
    with pytest.raises(ValueError):
        twc.window_spmv(mat, torch.zeros(8000)[::2])
    with pytest.raises(TypeError):
        twc.window_spmv(dataclasses.replace(mat, sidx=mat.sidx.int()), x)
    with pytest.raises(ValueError):
        twc.window_spmv(dataclasses.replace(mat, k_pad=mat.k_pad + 8), x)
    with pytest.raises(ValueError):
        twc.window_spmv(dataclasses.replace(mat, xdirect=True), x)  # 4 blocks
    with pytest.raises(ValueError):
        twc.window_spmv(mat, x.to("meta"))
    # the kernel launchers take CUDA tensors only: no plain fallback
    y = torch.zeros(4000)
    with pytest.raises(ValueError, match="CUDA"):
        twc.window_blocks_cuda(mat, x, y)
    assert twc.window_blocks_cuda.launches == twc.window_single_cuda.launches == 0


@pytest.mark.parametrize("mode", ["PL_CSR_WINDOW", "PL_CSR_WINDOW_BF16"])
def test_registered_modes_on_the_cpu(mode):
    tcsr, jcsr = _csrs(FEM)
    spec = registry.get(mode)
    assert spec.impl == "cuda"
    ops = spec.prepare(tcsr, None, T.Config(), torch.device("cpu"))
    jdt = jnp.bfloat16 if mode.endswith("BF16") else None
    _assert_window_equal(ops, jw.prepare_window_auto(jcsr, dtype=jnp.float32, vals_dtype=jdt))
    x = fill_rnd_vector(tcsr.shape[1], seed=4)
    y = spec.jitted(ops)(torch.as_tensor(x, dtype=torch.float32))
    rep = vectors_diff(y.double().numpy(), serial_csr_spmv(tcsr, x))
    assert rep.ok, rep


SELECT_CASES = {
    "fem_locality": ("fem_like", dict(m=6000, n=6000, nnz=120000, spread=500, lo=10, hi=28, seed=9)),
    "fem_small": FEM,
    "delaunay": DELAUNAY,
    "random_uniform": ("random_uniform", dict(m=3000, n=3000, density=0.003, seed=4)),
    "random_scattered": SCATTERED,
    "power_law": POWER_LAW,
}


@pytest.mark.parametrize("name", list(SELECT_CASES))
def test_select_format_agrees_past_dia(name):
    tcsr, jcsr = _csrs(SELECT_CASES[name])
    fmt = jauto.select_format(jcsr)
    assert tauto.select_format(tcsr) == fmt
    if name.startswith("fem") or name == "delaunay":
        assert fmt == "window"
    if name in ("random_scattered", "power_law"):
        assert fmt == "routed"


def test_auto_spmv_window_matches_jax():
    tcsr, jcsr = _csrs(SELECT_CASES["fem_locality"])
    tm = tauto.AutoSpMV.from_csr(tcsr, device="cpu")
    jm = jauto.AutoSpMV.from_csr(jcsr)
    assert tm.format == jm.format == "window"
    _assert_window_equal(tm._operands, jm._operands)
    x = _x(tcsr.shape[1], seed=2)
    y = tm(x)
    assert y.shape == (tcsr.shape[0],) and y.dtype == torch.float32
    _close(y, jm(x))
    _oracle_close(y, tcsr, x)
    xr = fill_rnd_vector(tcsr.shape[1], seed=2)
    assert vectors_diff(tm(xr).double().numpy(), serial_csr_spmv(tcsr, xr)).ok


def test_auto_spmv_window_refusal_names_routed():
    tcsr, jcsr = _csrs(SCATTERED)
    with pytest.raises(jw.WindowError):
        jw.prepare_window_auto(jcsr)  # the JAX package falls back to routed
    with pytest.raises(tw.WindowError):
        tw.prepare_window_auto(tcsr, device="cpu")
    # and so does the port, with the routed engine
    tm = tauto.AutoSpMV.from_csr(tcsr, format="window", device="cpu")
    jm = jauto.AutoSpMV.from_csr(jcsr, format="window")
    assert tm.format == jm.format == "routed"
    x = _x(tcsr.shape[1], seed=3)
    _close(tm(x), jm(x))
    _oracle_close(tm(x), tcsr, x)


@pytest.fixture
def fem_mtx(tmp_path):
    path = str(tmp_path / "fem_like.mtx")
    gen, kw = SELECT_CASES["fem_locality"]
    write_mtx(path, getattr(tsynth, gen)(**kw))
    return path


@pytest.mark.parametrize("mode", ["AUTO", "PL_CSR_WINDOW_BF16"])
def test_cli_cpu_check_window(fem_mtx, mode, capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    rc = cli.main([fem_mtx, "RNDVECT", mode, "--device", "cpu", "--check", "--no-dump"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "#check: OK" in out
    want = "PL_CSR_WINDOW" if mode == "AUTO" else mode
    line = [ln for ln in out.splitlines() if ln.startswith("computeMode:")][-1]
    assert line.startswith(f"computeMode:{want} elapsed:")
    if mode == "AUTO":
        assert "#auto: format=window -> PL_CSR_WINDOW" in out


def test_cli_window_mode_refuses_unwindowable(tmp_path, capsys):
    path = str(tmp_path / "scattered.mtx")
    gen, kw = SCATTERED
    write_mtx(path, getattr(tsynth, gen)(**kw))
    assert cli.main([path, "RNDVECT", "PL_CSR_WINDOW", "--device", "cpu", "--no-dump"]) == 1
    assert "window" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The CUDA kernels' launch plan (ops/window_cuda.py::launch_plan), held on
# the CPU: csrc/window_spmv.cu and df_spmv.cu take it as they are given it
# ---------------------------------------------------------------------------

#: the three window proxies' shapes at a small size: thermal2_like's and
#: fem_3d_thermal2_like's generators with fewer rows, delaunay_n12_like whole
PROXY_SMALL = {
    "thermal2_like": ("fem_like", dict(m=20000, n=20000, nnz=140000, spread=2048, lo=1, hi=11,
                                       seed=0)),
    "fem_3d_thermal2_like": ("fem_like", dict(m=8000, n=8000, nnz=190000, spread=1024, lo=13,
                                              hi=27, seed=0)),
    "delaunay_n12_like": DELAUNAY,
}


def _kernel_rows(plan, k_pad, k_c):
    """(rank, warp, slot row, mod-8) of every slot row the kernels load, in
    their loops' order: CTA `rank` of a block takes its rank_ranges range;
    warp w loads the rows k < k_c with k % 8 == w (and adds them), then one
    in eight of the rows k >= k_c, (k - ov0) % 8 == w, which the whole CTA
    reads (warp w adding lanes 4t + w % 4 whose row % 2 == w // 4)."""
    out = []
    for rank, (k0, k1) in enumerate(twc.rank_ranges(plan, k_pad, k_c)):
        assert k0 % 8 == 0
        ov0 = max(k0, k_c)
        for w in range(plan.threads // 32):
            out += [(rank, w, k, True) for k in range(k0 + w, min(k1, k_c), 8)]
            out += [(rank, w, k, False) for k in range(ov0 + w, k1, 8)]
    return out


@pytest.mark.parametrize("kind", ["f32", "bf16", "df"])
def test_launch_plan_fits_shared_memory(kind):
    """Every group size of the auto ladder and every window of <= 16 staged
    8-row blocks (nspecs; the 128-row cap) fits a CTA's 232,448 bytes, at any
    block count."""
    for g in tw._G_LADDER:
        for nspecs in range(1, 17):
            for nblocks, k_pad in ((1, 288), (29, 1088), (400, 256), (5000, 2048)):
                plan = twc.launch_plan(nblocks, k_pad, k_pad - 64, g, 8 * nspecs, kind)
                assert plan.smem == twc.smem_bytes(g, 8 * nspecs, kind, plan.depth) <= 232_448
                assert plan.depth in ((8,) if kind != "df" else (4, 2, 1))
                assert plan.cluster in (1, 2, 4, 8) and plan.threads == 256
                cost = k_pad - 64 + twc.OVERFLOW_COST * 64
                assert plan.cluster * plan.step >= cost
    # the largest: g = 64, a 128-row window of f64 x, a pair tile, a ring of
    # two stages of 40 bytes per thread (four would not fit)
    assert twc.smem_bytes(64, 128, "df", 2) == 225_808 < 232_448 < twc.smem_bytes(64, 128, "df", 4)
    assert twc.launch_plan(1, 544, 512, 64, 128, "df").depth == 2
    # thermal2_like in df: a ring of 1 fits two CTAs per SM (2 waves of 400
    # blocks), a ring of 4 one (4 waves)
    assert twc.launch_plan(400, 256, 224, 24, 64, "df").depth == 1


@pytest.mark.parametrize("kind", ["f32", "bf16", "df"])
@pytest.mark.parametrize("proxy", list(PROXY_SMALL))
def test_launch_plan_covers_every_slot_row_once(proxy, kind):
    tcsr, _ = _csrs(PROXY_SMALL[proxy])
    mat = tw.prepare_window_auto(tcsr, device="cpu")
    # the plan at this layout's shape, and at the full-size proxies' (the
    # shapes of the main path: thermal2 400 blocks of k_pad 256, fem 29 of
    # 1088, delaunay one of 288)
    full = {"thermal2_like": (400, 256, 24), "fem_3d_thermal2_like": (29, 1088, 40),
            "delaunay_n12_like": (1, 288, 32)}[proxy]
    for nblocks, k_pad, g, k_c in ((mat.nblocks, mat.k_pad, mat.g, mat.k_c),
                                   (*full, full[1] - 64)):
        plan = twc.launch_plan(nblocks, k_pad, k_c, g, twc.window_rows(mat), kind)
        rows = _kernel_rows(plan, k_pad, k_c)
        assert sorted(k for _r, _w, k, _m8 in rows) == list(range(k_pad))
        assert all(k % 8 == w for _r, w, k, m8 in rows if m8)
        # a warp's loads of one CTA never outrun the others' by more than
        # one mod-8 row and one overflow row
        for rank in range(plan.cluster):
            per_warp = [sum(1 for r, v, _k, _m in rows if r == rank and v == w) for w in range(8)]
            assert max(per_warp) - min(per_warp) <= 2
        assert all((k < k_c) == m8 for _r, _w, k, m8 in rows)
    # a CTA per block where the blocks fill the card, a cluster of 8 where
    # they are few
    nblocks, k_pad, g = full
    plan = twc.launch_plan(nblocks, k_pad, k_pad - 64, g, 64, "f32")
    assert plan.cluster == (1 if proxy == "thermal2_like" else 8)
    # the ranges cost a warp about the same: mod-8 rows 1/8 each, overflow
    # rows OVERFLOW_COST/8 each (within one 8-row step of either kind)
    costs = [min(k1, k_pad - 64) - min(k0, k_pad - 64)
             + twc.OVERFLOW_COST * (max(k1, k_pad - 64) - max(k0, k_pad - 64))
             for k0, k1 in twc.rank_ranges(plan, k_pad, k_pad - 64)]
    assert max(costs) - min(costs) <= 2 * 8 * twc.OVERFLOW_COST


@pytest.mark.parametrize("proxy", list(PROXY_SMALL))
def test_mod8_groups_write_disjoint_rows(proxy):
    """Warp j of a CTA adds the slot rows k < k_c with k % 8 == j into rows r
    = 8*gid + j, and the overflow slots whose row r = gid has r % 8 == j: so
    the eight warps' target rows are disjoint, and every tile cell has one
    writer."""
    tcsr, _ = _csrs(PROXY_SMALL[proxy])
    mat = tw.prepare_window_auto(tcsr, device="cpu")
    nb, kp, kc = mat.nblocks, mat.k_pad, mat.k_c
    g_pad = -(-mat.g // 8) * 8
    gid = mat.gid.reshape(nb, kp, 128).long()
    vals = mat.vals.reshape(nb, kp, 128)
    k = torch.arange(kp).reshape(1, kp, 1).expand(nb, kp, 128)
    r = torch.where(k < kc, 8 * gid + k % 8, gid)
    warp = torch.where(k < kc, k % 8, r % 8)
    live = vals != 0
    assert kc > 0 and (r[live] < g_pad).all()
    targets = [set(r[live & (warp == j)].tolist()) for j in range(8)]
    for j in range(8):
        assert all(t % 8 == j for t in targets[j])
        for i in range(j):
            assert not targets[i] & targets[j]
