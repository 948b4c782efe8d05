"""The port's CUDA kernels against their plain PyTorch versions, on the card.
No kernel closes a sum with atomics: a rerun on the same x is bitwise equal
(test_reruns_are_bitwise_equal).

Run on a machine with a GPU: python -m pytest -m gpu tests/test_torch_gpu.py
Elsewhere every test skips (inside the `cuda` fixture, so that all workers
collect the same tests).

Tolerance: max |y_kernel - y_plain| <= 1e-5 * max|y_plain| + 1e-6 on
x ~ N(0, 1): both versions read identical (f32 or bf16) values and sum in
f32; the kernel fuses multiply-adds and orders the fringe sum its own way.
The double-float kernels (end of the file) are held to 1e-12 * max|y|.
"""
import dataclasses

import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch.config import LANE
from spmv_openmp_cuda_tpu_torch.formats import dia as tdia
from spmv_openmp_cuda_tpu_torch.formats import window as twin
from spmv_openmp_cuda_tpu_torch.ops import registry
from spmv_openmp_cuda_tpu_torch.ops import spmv_cuda as tsc
from spmv_openmp_cuda_tpu_torch.ops import window_cuda as twc
from spmv_openmp_cuda_tpu_torch.utils import synth

pytestmark = pytest.mark.gpu

MODES = ["PL_DIA_ROWS", "PL_DIA_BF16", "PL_DIA_RESID", "PL_DIA_RESID_BF16"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _within(yk, yp):
    bound = 1e-5 * yp.abs().max().item() + 1e-6
    err = (yk - yp).abs().max().item()
    assert err <= bound, (err, bound)
    assert yk.abs().max().item() > 0


def _x(n, device, seed=1):
    return torch.as_tensor(
        np.random.default_rng(seed).standard_normal(n), dtype=torch.float32, device=device
    )


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "coo",
    [
        lambda: synth.preset("raefsky1_like"),
        lambda: synth.preset("cavity10_like"),
        lambda: synth.banded(3000, 3000, 30, fill=1.0, exact_nnz=185000, seed=0),
    ],
)
def test_kernel_matches_plain(cuda, mode, coo):
    csr = T.coo_to_csr(coo())
    ops = registry.get(mode).prepare(csr, None, T.Config(), cuda)
    x = _x(csr.shape[1], cuda)
    counter = tsc.dia_resid_spmv_cuda if mode.startswith("PL_DIA_RESID") else tsc.dia_spmv_cuda
    before = counter.launches
    yk = registry.get(mode).jitted(ops)(x)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    if mode.startswith("PL_DIA_RESID"):
        dr, plan = ops
        yp = tsc.dia_spmv_reference(dr.mat, x, plan, dr)
    else:
        yp = tsc.dia_spmv_reference(ops[0], x, ops[1])
    assert yk.shape == (csr.shape[0],) and yk.dtype == torch.float32
    _within(yk, yp)


def _wide_band_with_far_fringe():
    """A 3000 x 6000 band with two fringe entries past the JAX window's clip
    of x at 4224 (columns 4300, 5000)."""
    band = synth.banded(3000, 3000, 30, fill=1.0, seed=0)
    rows = np.r_[band.rows, [2998, 2999]]
    cols = np.r_[band.cols, [4300, 5000]]
    vals = np.r_[band.vals, [2.0, 1.0]]
    return T.sort_coo(T.COOMatrix((3000, 6000), rows, cols, vals))


#: the DIA+residual products: each mode on raefsky1_like, the banded
#: 3000-row matrix and the past-clip band
RESID_MATRICES = {
    "raefsky1": lambda: synth.preset("raefsky1_like"),
    "banded3000": lambda: synth.banded(3000, 3000, 30, fill=1.0, exact_nnz=185000, seed=0),
    "past_clip": _wide_band_with_far_fringe,
}


@pytest.mark.parametrize("mode", ["PL_DIA_RESID", "PL_DIA_RESID_BF16", "PL_DIA_RESID_F64"])
@pytest.mark.parametrize("matrix", list(RESID_MATRICES))
def test_resid_product_is_one_launch(cuda, mode, matrix, monkeypatch):
    """A DIA+residual product is one launch of dia_resid_kernel (or
    dia_resid_df_kernel, f64 in and out) that allocates y and nothing else,
    checks its layout at the first launch only, reruns bitwise equal and
    agrees with its plain version."""
    csr = T.coo_to_csr(RESID_MATRICES[matrix]())
    f64 = mode.endswith("F64")
    spec = registry.get(mode)
    dr, plan = ops = spec.prepare(csr, None, T.Config(dtype="float64" if f64 else "float32"), cuda)
    assert dr.nnz_resid > 0
    fn = spec.jitted(ops)
    counter = tsc.dia_resid_spmv_df_cuda if f64 else tsc.dia_resid_spmv_cuda
    xn = np.random.default_rng(5).standard_normal(csr.shape[1])
    x = torch.as_tensor(xn, dtype=torch.float64 if f64 else torch.float32, device=cuda)
    fn(x)  # the first launch checks the layout and keeps its plan
    torch.cuda.synchronize()
    checks = []
    monkeypatch.setattr(tsc, "_check_resid_layout", lambda *a: checks.append(a))
    rows_before = (tsc.dia_spmv_cuda.launches, tsc.dia_spmv_df_cuda.launches)
    before = counter.launches
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    yk, yk2 = fn(x), fn(x)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - allocs == 2  # y of each product
    assert counter.launches == before + 2 and not checks
    assert (tsc.dia_spmv_cuda.launches, tsc.dia_spmv_df_cuda.launches) == rows_before
    assert yk.shape == (csr.shape[0],) and torch.equal(yk, yk2)
    if f64:
        _df_within(yk, tsc.dia_spmv_df_reference(dr.mat, x, plan, dr), csr, xn)
    else:
        assert yk.dtype == torch.float32
        _within(yk, tsc.dia_spmv_reference(dr.mat, x, plan, dr))


#: the DIA rows products: cavity10_like (one row a thread) and the 5-point
#: Laplacian of a 367 x 367 grid (134,689 rows: four rows a thread, and
#: m % 4 == 1, so the last thread's group is ragged) -> rows a thread
ROWS_MATRICES = {
    "cavity10": (lambda: synth.preset("cavity10_like"), 1),
    "laplacian367": (lambda: synth.laplacian_2d(367), 4),
}


@pytest.mark.parametrize("mode", ["PL_DIA_ROWS", "PL_DIA_BF16", "PL_DIA_F64"])
@pytest.mark.parametrize("matrix", list(ROWS_MATRICES))
def test_dia_rows_product_is_one_launch(cuda, mode, matrix, monkeypatch):
    """A DIA rows product is one launch of dia_rows_kernel (dia_df_kernel
    in f64, x split and y combined in it) that allocates y and nothing
    else, checks its layout at the first launch only, reruns bitwise equal
    and agrees with its plain version (f64: torch.equal)."""
    gen, per_thread = ROWS_MATRICES[matrix]
    csr = T.coo_to_csr(gen())
    f64 = mode == "PL_DIA_F64"
    spec = registry.get(mode)
    mat, plan = ops = spec.prepare(csr, None, T.Config(dtype="float64" if f64 else "float32"), cuda)
    fn = spec.jitted(ops)
    counter = tsc.dia_spmv_df_cuda if f64 else tsc.dia_spmv_cuda
    other = tsc.dia_spmv_cuda if f64 else tsc.dia_spmv_df_cuda
    xn = np.random.default_rng(5).standard_normal(csr.shape[1])
    x = torch.as_tensor(xn, dtype=torch.float64 if f64 else torch.float32, device=cuda)
    fn(x)  # the first launch checks the layout and keeps its plan
    torch.cuda.synchronize()
    assert tsc._rows_plan(mat, plan, x.device) == tsc.rows_a_thread(csr.shape[0]) == per_thread
    checks = []
    monkeypatch.setattr(tsc, "_check_rows_layout", lambda *a: checks.append(a))
    before = (counter.launches, other.launches)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    yk, yk2 = fn(x), fn(x)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - allocs == 2  # y of each product
    assert (counter.launches, other.launches) == (before[0] + 2, before[1]) and not checks
    assert yk.shape == (csr.shape[0],) and torch.equal(yk, yk2)
    if f64:
        yp = tsc.dia_spmv_df_reference(mat, x, plan)
        assert torch.equal(yk, yp)
        _df_within(yk, yp, csr, xn)
    else:
        assert yk.dtype == torch.float32
        _within(yk, tsc.dia_spmv_reference(mat, x, plan))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_graphed_cg_on_a_dia_laplacian(cuda, dtype):
    """CG over AutoSpMV on the 367 x 367 grid's Laplacian (DIA, four rows a
    thread): the graphed solve's x torch.equal the eager one's, with the
    same iteration count."""
    from spmv_openmp_cuda_tpu_torch.models import solvers
    from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV

    csr = T.coo_to_csr(synth.laplacian_2d(367))
    model = AutoSpMV.from_csr(csr, cfg=T.Config(dtype=dtype), device=cuda)
    assert model.format == "dia" and tsc.rows_a_thread(csr.shape[0]) == 4
    b = np.random.default_rng(2).standard_normal(csr.shape[0])
    tol = 1e-10 if dtype == "float64" else 1e-5
    eager = solvers.conjugate_gradient(model, b, tol=tol, maxiter=5000, graph=False)
    graphed = solvers.conjugate_gradient(model, b, tol=tol, maxiter=5000, graph=True)
    assert torch.equal(graphed.x, eager.x) and int(graphed.iters) == int(eager.iters) < 5000


def test_resid_wrapper_raises_on_what_it_does_not_take(cuda):
    csr = T.coo_to_csr(synth.preset("raefsky1_like"))
    dr, plan = tsc.prepare_dia_resid(csr, device=cuda)
    x = _x(csr.shape[1], cuda)
    with pytest.raises(TypeError):
        tsc.dia_resid_spmv_cuda(dr, x.double(), plan)
    with pytest.raises(ValueError):
        tsc.dia_resid_spmv_cuda(dr, x[:-1], plan)
    with pytest.raises(ValueError):
        tsc.dia_resid_spmv_cuda(dr, torch.zeros(2 * x.shape[0], device=cuda)[::2], plan)
    with pytest.raises(ValueError):  # lists of another precision
        tsc.dia_resid_spmv_cuda(dataclasses.replace(dr, fr_lo=dr.fr_val), x, plan)
    with pytest.raises(TypeError):  # an f32 layout in the df wrapper
        tsc.dia_resid_spmv_df_cuda(dr, x.double(), plan)


def test_wide_matrix_clips_x(cuda):
    # far diagonal on a wide matrix: the kernel's bounds test stands in for
    # the JAX window's clipped x
    m, n = 2560, 65536
    rows = np.arange(m)
    cols = rows + 60000
    vals = np.random.default_rng(4).standard_normal(m)
    csr = T.coo_to_csr(T.sort_coo(T.COOMatrix((m, n), rows, cols, vals)))
    mat = tdia.prepare_dia(csr, max_fill_ratio=1e9, device=cuda)
    plan = tsc.plan_dia(mat)
    mat = tsc.pad_dia_for_pallas(mat, plan)
    x = _x(n, cuda)
    _within(tsc.dia_spmv_cuda(mat, x, plan), tsc.dia_spmv_reference(mat, x, plan))


def test_wrapper_raises_on_what_it_does_not_take(cuda):
    csr = T.coo_to_csr(synth.banded(3000, 3000, 8, seed=1))
    mat = tdia.prepare_dia(csr, device=cuda)
    plan = tsc.plan_dia(mat)
    mat = tsc.pad_dia_for_pallas(mat, plan)
    x = _x(3000, cuda)
    with pytest.raises(TypeError):
        tsc.dia_spmv_cuda(mat, x.double(), plan)
    with pytest.raises(TypeError):
        tsc.dia_spmv_cuda(
            tdia.make_device_dia(mat.data.half(), mat.offsets, mat.shape, mat.nnz, mat.pad_sub),
            x, plan,
        )
    with pytest.raises(ValueError):
        tsc.dia_spmv_cuda(mat, x.cpu(), plan)  # slab on the GPU, x on the CPU
    with pytest.raises(ValueError):
        tsc.dia_spmv_cuda(mat, torch.zeros(6000, device=cuda)[::2], plan)
    with pytest.raises(ValueError):
        tsc.dia_spmv_cuda(mat, x[:-1], plan)
    nc = tdia.make_device_dia(
        mat.data.transpose(0, 1).contiguous().transpose(0, 1), mat.offsets, mat.shape,
        mat.nnz, mat.pad_sub,
    )
    with pytest.raises(ValueError):
        tsc.dia_spmv_cuda(nc, x, plan)


def test_fringe_kernel_reads_x_past_the_clip(cuda):
    csr = T.coo_to_csr(_wide_band_with_far_fringe())
    dr, plan = tsc.prepare_dia_resid(csr, device=cuda)
    x = _x(6000, cuda)
    yk = tsc.dia_resid_spmv_cuda(dr, x, plan)
    _within(yk, tsc.dia_spmv_reference(dr.mat, x, plan, dr))
    o = torch.as_tensor(
        T.csr_to_dense(csr) @ x.double().cpu().numpy(), dtype=torch.float32, device=cuda
    )
    _within(yk, o)


#: window layouts: the three x forms (standard, shared_w, xdirect), the
#: mod-8 fold with an overflow region (k_c < k_pad) and without one (k_c ==
#: k_pad), a per-sub-block bps layout, g = 8, 24, 40 and 64, and the largest
#: shared memory a CTA takes (g = 64 and a 128-row x window: 205 KB in df)
WINDOW_LAYOUTS = {
    "g8": (dict(m=6000, n=6000, nnz=60000, spread=700, lo=4, hi=16, seed=7), dict(g=8)),
    "g24": (dict(m=9000, n=9000, nnz=90000, spread=900, lo=4, hi=16, seed=5), dict(g=24)),
    "g40": (dict(m=12000, n=12000, nnz=100000, spread=1200, lo=4, hi=14, seed=4), dict(g=40)),
    "g64_x128": (dict(m=8192, n=16384, nnz=60000, spread=3000, lo=4, hi=12, seed=6),
                 dict(g=64, xdirect=True)),
    "full_k_c": (dict(m=6000, n=6000, nnz=30000, spread=300, lo=3, hi=7, seed=3),
                 dict(g=8, cap=16, max_pad=20.0)),
    "standard": (dict(m=6000, n=6000, nnz=60000, spread=700, lo=4, hi=16, seed=7), dict(g=16)),
    "overflow": (dict(m=4000, n=4000, nnz=50000, spread=600, lo=5, hi=20, seed=2),
                 dict(g=12, cap=16, max_pad=20.0)),
    "per_sub_bps": (dict(m=6000, n=6000, nnz=60000, spread=700, lo=4, hi=16, seed=7),
                    dict(g=16, bps=4, shared_w=False)),
    "shared_w": (dict(m=6000, n=6000, nnz=60000, spread=700, lo=4, hi=16, seed=7),
                 dict(g=8, bps=4, shared_w=True)),
    "xdirect": (dict(m=3000, n=3000, nnz=20000, spread=900, lo=4, hi=10, seed=9),
                dict(g=24, xdirect=True)),
}


@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", list(WINDOW_LAYOUTS))
def test_window_kernel_matches_plain(cuda, layout, vals_dtype):
    gen_kw, kw = WINDOW_LAYOUTS[layout]
    csr = T.coo_to_csr(synth.fem_like(**gen_kw))
    mat = twin.prepare_window(csr, vals_dtype=vals_dtype, device=cuda, **kw)
    assert mat.xdirect == (layout in ("xdirect", "g64_x128"))
    assert mat.shared_w == (layout == "shared_w")
    assert (mat.k_c == mat.k_pad) == (layout == "full_k_c")
    x = _x(csr.shape[1], cuda)
    counter = twc.window_single_cuda if mat.xdirect else twc.window_blocks_cuda
    before = counter.launches
    yk = twc.window_spmv(mat, x)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert yk.shape == (csr.shape[0],) and yk.dtype == torch.float32
    _within(yk, twc.window_spmv_reference(mat, x))


@pytest.mark.parametrize("mode", ["PL_CSR_WINDOW", "PL_CSR_WINDOW_BF16"])
def test_window_modes_on_delaunay(cuda, mode):
    csr = T.coo_to_csr(synth.preset("delaunay_n12_like"))
    ops = registry.get(mode).prepare(csr, None, T.Config(), cuda)
    assert ops.xdirect
    x = _x(csr.shape[1], cuda)
    _within(registry.get(mode).jitted(ops)(x), twc.window_spmv_reference(ops, x))


def test_window_wrapper_raises_on_what_it_does_not_take(cuda):
    csr = T.coo_to_csr(synth.fem_like(m=3000, n=3000, nnz=30000, spread=500, lo=4, hi=16, seed=3))
    mat = twin.prepare_window(csr, g=8, device=cuda)
    x = _x(3000, cuda)
    with pytest.raises(TypeError):
        twc.window_spmv(mat, x.double())
    with pytest.raises(TypeError):
        twc.window_spmv(dataclasses.replace(mat, vals=mat.vals.half()), x)
    with pytest.raises(TypeError):
        twc.window_spmv(dataclasses.replace(mat, gid=mat.gid.int()), x)
    with pytest.raises(ValueError):
        twc.window_spmv(mat, x.cpu())  # slabs on the GPU, x on the CPU
    with pytest.raises(ValueError):
        twc.window_spmv(mat, torch.zeros(6000, device=cuda)[::2])
    with pytest.raises(ValueError):
        twc.window_spmv(mat, x[:-1])
    nc = mat.vals.t().contiguous().t()
    with pytest.raises(ValueError):
        twc.window_spmv(dataclasses.replace(mat, vals=nc), x)
    y = torch.zeros(3000, device=cuda)
    with pytest.raises(ValueError):
        twc.window_single_cuda(mat, x, y)  # a multi-block layout
    with pytest.raises(ValueError):
        twc.window_blocks_cuda(mat, x, y[:-1])


def test_window_launchers_overwrite_y(cuda):
    csr = T.coo_to_csr(synth.fem_like(m=3000, n=3000, nnz=30000, spread=500, lo=4, hi=16, seed=3))
    x = _x(3000, cuda)
    for mat, launch in (
        (twin.prepare_window(csr, g=8, device=cuda), twc.window_blocks_cuda),
        (twin.prepare_window(csr, g=24, xdirect=True, device=cuda), twc.window_single_cuda),
    ):
        y = torch.full((3000,), 7.0, device=cuda)
        launch(mat, x, y)
        _within(y, twc.window_spmv_reference(mat, x))


#: routed layouts: a t = 1 level, a dense heavy row, a > 64-row heavy block
#: (matmul), a small domain (t <= 4), and a chunked matrix
def _routed_heavy_many():
    rng = np.random.default_rng(51)
    rows = np.concatenate([np.full(600, r) for r in range(70)] + [rng.integers(70, 200, 1500)])
    cols = np.concatenate([rng.choice(8000, 600, replace=False) for _ in range(70)]
                          + [rng.integers(0, 8000, 1500)])
    rows, cols = np.unique(np.stack([rows, cols]), axis=1)
    return T.COOMatrix((200, 8000), rows, cols, rng.standard_normal(rows.shape[0])), 512


def _routed_spiked():
    rng = np.random.default_rng(31)
    rows = np.r_[np.zeros(20000, np.int64), rng.integers(0, 3000, 5000)]
    cols = np.r_[rng.choice(30000, 20000, replace=False), rng.integers(0, 30000, 5000)]
    return T.sort_coo(T.COOMatrix((3000, 30000), rows, cols, rng.standard_normal(rows.shape[0]))), None


def _routed_pooled():
    # 40 heavy rows of 200,000 columns: a dense block would pass 12 MB, so
    # they go into pooled tiles (kernel E)
    rng = np.random.default_rng(1)
    rows = np.concatenate([np.full(17000, r) for r in range(40)] + [rng.integers(40, 3000, 12000)])
    cols = np.concatenate([rng.choice(200000, 17000, replace=False) for _ in range(40)]
                          + [rng.integers(0, 200000, 12000)])
    rows, cols = np.unique(np.stack([rows, cols]), axis=1)
    return T.COOMatrix((3000, 200000), rows, cols, rng.standard_normal(rows.shape[0])), None


ROUTED_LAYOUTS = {
    "level": lambda: (synth.power_law(4000, 4000, avg_nnz_per_row=5.0, alpha=1.6, seed=17), None),
    "spiked": _routed_spiked,
    "heavy_many": _routed_heavy_many,
    "pooled": _routed_pooled,
    # t <= 4: the small kernel, one launch per product
    "small": lambda: (synth.random_uniform(9000, 9000, density=5e-4, seed=7), None),
    "small_t2": lambda: (synth.preset("delaunay_n12_like"), None),
}


@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", list(ROUTED_LAYOUTS))
def test_routed_kernels_match_plain(cuda, layout, vals_dtype):
    from spmv_openmp_cuda_tpu_torch.formats import routed as trt
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    coo, thr = ROUTED_LAYOUTS[layout]()
    csr = T.coo_to_csr(coo)
    mat = trt.prepare_routed(csr, heavy_threshold=thr, vals_dtype=vals_dtype, device=cuda)
    chain = trc.build_chain(mat)
    x = _x(csr.shape[1], cuda)
    seen = set()
    for stage, yk, yp, ys in trc.compare_stages(chain, x):
        torch.cuda.synchronize()
        seen.add(stage.kernel)
        if stage.kernel in ("gather", "permute"):
            assert torch.equal(yk, yp), stage  # data movement and products
        else:
            _within(yk, yp)
        if stage.kernel == "permute":  # the composed gather: the staged W stages
            assert torch.equal(yk, ys), stage
        elif ys is not None:
            _within(yk, ys)
    if layout.startswith("small"):
        assert seen == {"small"} and chain.counts["small"] == 1
    else:
        assert {"gather", "permute", "perm_reduce"} <= seen
        assert chain.counts["permute"] == 1
    assert ("hdense" in seen) == (layout == "spiked")
    assert ("heavy" in seen) == (layout == "pooled")
    before = {k: fn.launches for k, fn in trc._COUNTERS.items()}
    y = trc.routed_chain_spmv(chain, x)
    torch.cuda.synchronize()
    # the counters gain what csrc/routed_spmv.cu launched: the plan's stages
    assert {k: fn.launches - before[k] for k, fn in trc._COUNTERS.items()} == chain.counts
    assert y.shape == (csr.shape[0],) and y.dtype == torch.float32
    _within(y, trc.routed_spmv_reference(chain, x))


def test_routed_chunked_chain(cuda):
    from spmv_openmp_cuda_tpu_torch.formats import routed as trt
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    csr = T.coo_to_csr(synth.power_law(6000, 6000, avg_nnz_per_row=6.0, alpha=1.5, seed=9))
    mat = trt.prepare_routed_chunked(csr, chunk_nnz=3000, fit_domains=False, device=cuda)
    assert len(mat.chunks) >= 3
    # a chunk's output gather writes y from a row bound that is not a
    # multiple of 4 (an output 4-byte aligned only)
    assert any(b % 4 for b in mat.bounds)
    chain = trc.build_chain(mat)
    x = _x(6000, cuda)
    for stage, yk, yp, _ys in trc.compare_stages(chain, x):
        torch.cuda.synchronize()
        if stage.kernel in ("gather", "permute"):
            assert torch.equal(yk, yp), stage
        else:
            _within(yk, yp)
    _within(trc.routed_chain_spmv(chain, x), trc.routed_spmv_reference(chain, x))


def test_routed_auto_spmv_on_caida(cuda):
    from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc
    from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv

    csr = T.coo_to_csr(synth.preset("caida_like"))
    model = AutoSpMV.from_csr(csr, device="cuda")
    assert model.format == "routed"
    x = np.random.default_rng(3).standard_normal(csr.shape[1])
    y = model(x).double().cpu().numpy()
    o = serial_csr_spmv(trc.stored_csr(csr, model._operands), x)
    assert np.abs(y - o).max() <= 1e-5 * np.abs(o).max() + 1e-6


def test_routed_wrappers_raise_on_what_they_do_not_take(cuda):
    from spmv_openmp_cuda_tpu_torch.formats import routed as trt
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    csr = T.coo_to_csr(synth.power_law(4000, 4000, avg_nnz_per_row=5.0, alpha=1.6, seed=17))
    chain = trc.build_chain(trt.prepare_routed(csr, device=cuda))
    x = _x(4000, cuda)
    with pytest.raises(TypeError):
        trc.routed_chain_spmv(chain, x.double())
    with pytest.raises(ValueError):
        trc.routed_chain_spmv(chain, x.cpu())  # operands on the GPU, x on the CPU
    with pytest.raises(ValueError):
        trc.routed_chain_spmv(chain, x[:-1])
    mat = chain.mat
    out = torch.empty(mat.perm_products.h * LANE, device=cuda)
    with pytest.raises(ValueError):
        trc.routed_gather_cuda(mat.vals, mat.pidx, mat.widx, mat.perm_products.w1,
                               mat.perm_products.t, x, out[:-1])
    imap = trc.plan_map(mat.perm_out)
    with pytest.raises(ValueError):  # a source shorter than the map's offsets reach
        trc.routed_permute_cuda(out[: imap.span - 1], imap, imap.idx.numel(), out)


def test_permute_kernel_is_the_staged_w_stages(cuda):
    """Kernel B through a plan's composed map, and through a single W
    stage's, against the W stages applied one by one: bit for bit, one
    launch per application."""
    from spmv_openmp_cuda_tpu_torch.ops import route as troute
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    t = 8
    perm = np.random.default_rng(2).permutation(t * LANE * LANE)
    plan = troute.plan_permutation(perm, t, device=cuda)
    x = _x(t * LANE * LANE, cuda).reshape(t * LANE, LANE)
    before = trc.routed_permute_cuda.launches
    for skip in (False, True):
        y = trc.apply_permutation(plan, x, skip)
        assert torch.equal(y, trc.staged_reference(trc.plan_steps(plan, skip_r3=skip), x))
    assert trc.routed_permute_cuda.launches == before + 2
    want = torch.empty_like(x).reshape(-1)
    want[torch.as_tensor(perm, device=cuda)] = x.reshape(-1)
    assert torch.equal(trc.apply_permutation(plan, x).reshape(-1), want)
    for kw in (dict(w=plan.w1, r=plan.r1), dict(w=plan.w2, sw=True, t=t),
               dict(w=plan.w3, ra=plan.r3, src_rows=3 * LANE + 1)):
        got = trc.w_stage(x, **kw)
        assert torch.equal(got, trc.w_stage_reference(
            x, kw.get("src_rows", t * LANE), kw.get("r"), kw["w"], kw.get("ra"), kw.get("t", 1),
            kw.get("sw", False), t))


def test_reruns_are_bitwise_equal(cuda):
    """Two products on the same x give the same bits: the window kernels
    with a block's slot rows split over CTAs (closed in chunk order), D with
    a heavy row split over CTAs, E and the small kernel."""
    from spmv_openmp_cuda_tpu_torch.formats import routed as trt
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    runs = []
    for mode in ("PL_CSR_WINDOW", "PL_CSR_WINDOW_BF16"):
        for coo in (synth.preset("delaunay_n12_like"),
                    synth.fem_like(m=6000, n=6000, nnz=60000, spread=700, lo=4, hi=16, seed=7)):
            csr = T.coo_to_csr(coo)
            ops = registry.get(mode).prepare(csr, None, T.Config(), cuda)
            runs.append((f"{mode} {csr.shape}", registry.get(mode).jitted(ops), csr.shape[1]))
    for layout in ("spiked", "pooled", "small"):
        coo, thr = ROUTED_LAYOUTS[layout]()
        csr = T.coo_to_csr(coo)
        chain = trc.build_chain(trt.prepare_routed(csr, heavy_threshold=thr, device=cuda))
        runs.append((layout, lambda v, c=chain: trc.routed_chain_spmv(c, v), csr.shape[1]))
    for label, fn, n in runs:
        x = _x(n, cuda)
        a, b = fn(x), fn(x)
        torch.cuda.synchronize()
        assert torch.equal(a, b), label


def test_split_window_blocks_close_in_chunk_order(cuda):
    # delaunay's single block is split over a thread-block cluster: the CTAs
    # add their tiles in rank order through distributed shared memory, in
    # one launch; y is overwritten
    csr = T.coo_to_csr(synth.preset("delaunay_n12_like"))
    mat = twin.prepare_window_auto(csr, device=cuda)
    assert mat.xdirect and twc._plan(mat, mat.vals.device).cluster == twc.MAX_CLUSTER
    x = _x(csr.shape[1], cuda)
    y = torch.full((csr.shape[0],), float("nan"), device=cuda)
    before = twc.window_single_cuda.launches
    twc.window_single_cuda(mat, x, y)
    assert twc.window_single_cuda.launches == before + 1
    _within(y, twc.window_spmv_reference(mat, x))


@pytest.mark.parametrize("df", [False, True])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_window_cluster_sizes(cuda, monkeypatch, cluster, df):
    """Every CTAs-per-block count gives the plain version's y in one launch,
    and a rerun the same bits: 1 (a CTA per block) and clusters of 2, 4
    and 8 CTAs on one layout with an overflow region."""
    gen_kw, kw = WINDOW_LAYOUTS["overflow"]
    csr = T.coo_to_csr(synth.fem_like(**gen_kw))
    mat = twin.prepare_window(csr, df=df, device=cuda, **kw)
    auto = twc.launch_plan

    def forced(nblocks, k_pad, k_c, *args):
        step = -(-(k_c + twc.OVERFLOW_COST * (k_pad - k_c)) // cluster)
        return dataclasses.replace(auto(nblocks, k_pad, k_c, *args), cluster=cluster, step=step)

    monkeypatch.setattr(twc, "launch_plan", forced)
    assert twc._plan(mat, mat.vals.device).cluster == cluster
    xn = np.random.default_rng(5).standard_normal(csr.shape[1])
    x = torch.as_tensor(xn, dtype=torch.float64 if df else torch.float32, device=cuda)
    counter = twc.window_df_cuda if df else twc.window_blocks_cuda
    before = counter.launches
    a, b = twc.window_spmv(mat, x), twc.window_spmv(mat, x)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert torch.equal(a, b)
    if df:
        _df_within(a, twc.window_spmv_df_reference(mat, x), csr, xn)
    else:
        _within(a, twc.window_spmv_reference(mat, x))


def test_heavy_and_small_wrappers_on_the_card(cuda):
    from spmv_openmp_cuda_tpu_torch.formats import routed as trt
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    coo, _ = _routed_pooled()
    csr = T.coo_to_csr(coo)
    mat = trt.prepare_routed(csr, device=cuda)
    st = trc.build_chain(mat).stages[-1]
    assert isinstance(st, trc.HeavyStage)
    x = _x(csr.shape[1], cuda)
    args = (st.hvals, st.hpidx, st.hwidx, st.hlo, st.hhi, st.slot_ptr, st.slot_idx)
    y = torch.zeros(csr.shape[0], device=cuda)
    before = trc.routed_heavy_cuda.launches
    trc.routed_heavy_cuda(*args, st.rows, x, y)
    torch.cuda.synchronize()
    assert trc.routed_heavy_cuda.launches == before + 1
    want = torch.zeros_like(y)
    want[st.rows.long()] = trc.heavy_sums_reference(*args, x)
    _within(y, want)
    with pytest.raises(TypeError):
        trc.routed_heavy_cuda(st.hvals.half(), *args[1:], st.rows, x, y)
    with pytest.raises(ValueError):
        trc.routed_heavy_cuda(*args, st.rows, x, y, part=torch.empty(10, device=cuda))


def _pooled_200000():
    # chip_smoke.py's pooled_200000: 40 heavy rows of 17,000 columns in a
    # 200,000-square matrix, 400,000 scattered entries besides
    rng = np.random.default_rng(1)
    rows = np.concatenate([np.full(17000, r) for r in range(40)]
                          + [rng.integers(40, 200000, 400000)])
    cols = np.concatenate([rng.choice(200000, 17000, replace=False) for _ in range(40)]
                          + [rng.integers(0, 200000, 400000)])
    rows, cols = np.unique(np.stack([rows, cols]), axis=1)
    return T.COOMatrix((200000, 200000), rows, cols, rng.standard_normal(rows.shape[0]))


#: A and E at the main path's shapes: proxy, values' type
GATHER_HEAVY_CASES = {
    "caida_like": (lambda: synth.preset("caida_like"), None),
    "webbase_like": (lambda: synth.preset("webbase_like"), None),
    "pooled_200000_bf16": (_pooled_200000, torch.bfloat16),
}


@pytest.mark.parametrize("case", list(GATHER_HEAVY_CASES))
def test_gather_and_heavy_kernels_bit_for_bit(cuda, case):
    """A (the window staged in shared memory, a cluster per tile) equals
    gather_reference bit for bit; E (a CTA per residue quarter) and its
    close equal heavy_sums_in_order (the kernels' adds in their order) bit
    for bit and heavy_sums_reference within the tolerance; a rerun of each
    gives the same bits."""
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    make, vals_dtype = GATHER_HEAVY_CASES[case]
    csr = T.coo_to_csr(make())
    chain = trc.prepare_routed_chain(csr, vals_dtype=vals_dtype, device=cuda)
    x = _x(csr.shape[1], cuda, seed=6)
    bufs = trc._buffers(chain, x)
    bufs["s"].fill_(float("nan"))
    seen = []
    for stage in chain.stages:
        if stage.kernel in ("gather", "heavy"):
            outs = []
            for _ in range(2):
                copy = {k: v.clone() for k, v in bufs.items()}
                trc.run_stage(stage, copy, plain=False)
                outs.append(trc._view(copy, stage.out, stage.out_elems()))
            torch.cuda.synchronize()
            assert torch.equal(outs[0], outs[1]), (case, stage.kernel)
            if stage.kernel == "heavy":
                args = (stage.hvals, stage.hpidx, stage.hwidx, stage.hlo, stage.hhi,
                        stage.slot_ptr, stage.slot_idx, x)
                want = trc._view(bufs, stage.out, stage.out_elems()).clone()
                want[stage.rows.long()] += trc.heavy_sums_in_order(*args)
                assert torch.equal(outs[0], want), case
                ref = trc._view(bufs, stage.out, stage.out_elems()).clone()
                ref[stage.rows.long()] += trc.heavy_sums_reference(*args)
                _within(outs[0], ref)
            seen.append((stage.kernel, outs[0]))
        trc.run_stage(stage, bufs, plain=True)
        if seen and seen[-1][0] == "gather" and stage.kernel == "gather":
            assert torch.equal(seen[-1][1], trc._view(bufs, stage.out, stage.out_elems())), case
    kinds = [k for k, _ in seen]
    assert "gather" in kinds and (case == "caida_like") != ("heavy" in kinds), kinds


#: small routed domains (the small kernel): proxy, mode
SMALL_CASES = {
    "delaunay_n12_like": (lambda: synth.preset("delaunay_n12_like"), "PL_CSR_ROUTED"),
    "delaunay_n12_like_bf16": (lambda: synth.preset("delaunay_n12_like"), "PL_CSR_ROUTED_BF16"),
    "west2021_like": (lambda: synth.preset("west2021_like"), "PL_CSR_ROUTED"),
    "random_uniform_9000": (lambda: synth.random_uniform(9000, 9000, density=5e-4, seed=7),
                            "PL_CSR_ROUTED"),
}


@pytest.mark.parametrize("case", list(SMALL_CASES))
def test_small_kernel_equals_the_staged_chain(cuda, case):
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    coo, mode = SMALL_CASES[case]
    csr = T.coo_to_csr(coo())
    chain = registry.get(mode).prepare(csr, None, T.Config(), cuda)
    staged = trc.build_chain(chain.mat, fuse_small=False)
    assert chain.counts == {**{k: 0 for k in trc._COUNTERS}, "small": 1}
    assert chain.scratch_elems == 0 and staged.scratch_elems > 0
    x = _x(csr.shape[1], cuda)
    before = trc.routed_small_cuda.launches
    # one launch that allocates nothing but y
    y, held = _allocated_by(lambda: trc.routed_chain_spmv(chain, x), cuda)
    assert trc.routed_small_cuda.launches == before + 1
    assert held == _block(4 * csr.shape[0])
    # the same products added in the same order as the staged CUDA chain
    assert torch.equal(y, trc.routed_chain_spmv(staged, x))
    assert torch.equal(y, trc.routed_chain_spmv(chain, x))
    _within(y, trc.routed_spmv_reference(chain, x))


# ---------------------------------------------------------------------------
# double-float (float64) kernels of csrc/df_spmv.cu against their plain
# versions: max |y_kernel - y_plain| <= 1e-12 * max|y_plain| (both (hi, lo)
# f32 pairs; they differ in summation order and the cross terms' rounding),
# and within 1e-11 * max|y| of the exact f64 oracle (1e-10 chunked), which a
# contracted TwoProduct or TwoSum (~1e-7) would fail.
# ---------------------------------------------------------------------------


def _df_within(yk, yp, csr, x, oracle_bound=1e-11):
    from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv

    assert yk.dtype == torch.float64 and yk.device.type == "cuda"
    scale = yp.abs().max().item()
    assert (yk - yp).abs().max().item() <= 1e-12 * scale
    o = serial_csr_spmv(csr, x)
    assert np.abs(yk.cpu().numpy() - o).max() <= oracle_bound * np.abs(o).max()


@pytest.mark.parametrize(
    "mode,coo",
    [
        ("PL_DIA_F64", lambda: synth.preset("cavity10_like")),
        ("PL_DIA_RESID_F64", lambda: synth.preset("raefsky1_like")),
        ("PL_DIA_F64", lambda: synth.banded(3000, 3000, 30, fill=1.0, exact_nnz=185000, seed=0)),
        ("PL_DIA_RESID_F64", lambda: synth.banded(3000, 3000, 30, fill=1.0, exact_nnz=185000, seed=0)),
    ],
)
def test_dia_df_kernel_matches_plain(cuda, mode, coo):
    csr = T.coo_to_csr(coo())
    spec = registry.get(mode)
    ops = spec.prepare(csr, None, T.Config(dtype="float64"), cuda)
    x = np.random.default_rng(5).standard_normal(csr.shape[1])
    xd = torch.as_tensor(x, device=cuda)
    counter = tsc.dia_resid_spmv_df_cuda if mode == "PL_DIA_RESID_F64" else tsc.dia_spmv_df_cuda
    before = counter.launches
    yk = spec.jitted(ops)(xd)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    if mode == "PL_DIA_RESID_F64":
        dr, plan = ops
        yp = tsc.dia_spmv_df_reference(dr.mat, xd, plan, dr)
    else:
        yp = tsc.dia_spmv_df_reference(ops[0], xd, ops[1])
    _df_within(yk, yp, csr, x)


@pytest.mark.parametrize("layout", list(WINDOW_LAYOUTS))
def test_window_df_kernel_matches_plain(cuda, layout):
    gen_kw, kw = WINDOW_LAYOUTS[layout]
    csr = T.coo_to_csr(synth.fem_like(**gen_kw))
    mat = twin.prepare_window(csr, df=True, device=cuda, **kw)
    x = np.random.default_rng(8).standard_normal(csr.shape[1])
    xd = torch.as_tensor(x, device=cuda)
    before = twc.window_df_cuda.launches
    yk = twc.window_spmv(mat, xd)
    torch.cuda.synchronize()
    assert twc.window_df_cuda.launches == before + 1
    _df_within(yk, twc.window_spmv_df_reference(mat, xd), csr, x)


@pytest.mark.parametrize("layout", ["level", "spiked", "heavy_many", "small"])
def test_routed_df_kernel_matches_plain(cuda, layout):
    """The routed df program (C-df per level, level 0 forming K3's products
    and closing a one-tile level after it, the output gather, D-df) stage by
    stage bit for bit against the plain versions, each launch rerun bit for
    bit; the whole product one program (its planned launches), bit for bit
    its plain chain and the staged chain, and in CUDA graph replays, within
    1e-11 of the exact oracle."""
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    coo, _thr = ROUTED_LAYOUTS[layout]()
    csr = T.coo_to_csr(coo)
    chain = trc.prepare_routed_df_chain(csr, device=cuda)
    x = np.random.default_rng(3).standard_normal(csr.shape[1])
    xd = torch.as_tensor(x, device=cuda)
    kernels = set()
    for stage, yk, yk2, yp in trc.compare_df_stages(chain, xd):
        torch.cuda.synchronize()
        assert trc.bits_equal(yk, yp) and trc.bits_equal(yk, yk2), stage.kernel
        kernels.add(stage.kernel)
    assert kernels == {k for k, v in chain.counts.items() if v}
    before = {k: fn.launches for k, fn in trc._DF_COUNTERS.items()}
    yk = trc.routed_df_spmv(chain, xd)
    torch.cuda.synchronize()
    assert {k: fn.launches - before[k] for k, fn in trc._DF_COUNTERS.items()} == chain.counts
    assert trc.bits_equal(yk, trc.routed_df_spmv(chain, xd, plain=True))
    assert trc.bits_equal(yk, trc.routed_df_staged_reference(chain, xd))
    _df_within(yk, trc.routed_df_spmv(chain, xd, plain=True), csr, x)
    yg = torch.empty_like(yk)
    _replays_equal(lambda: yg.copy_(trc.routed_df_spmv(chain, xd)), yg, yk)


def _replays_equal(fn, out, want):
    """fn (which writes out) captured in a CUDA graph: three replays, out
    refilled with NaN before each, give want's bits."""
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    for _ in range(3):
        out.fill_(float("nan"))
        g.replay()
        torch.cuda.synchronize()
        assert trc.bits_equal(out, want)


def test_routed_df_output_gather_is_one_launch(cuda):
    """The output gather of a df product over three domains (a chunked
    matrix) is one launch: bit for bit its plain version over the composed
    map, eager (with y 16-byte aligned, y not aligned, and a ragged tail of
    rows) and in CUDA graph replays; the product bit for bit its plain
    chain, eager and in CUDA graph replays."""
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    rng = np.random.default_rng(21)
    rows = np.repeat(np.arange(8000), 3)
    cols = rng.integers(0, 128, rows.size) * 128
    rows, cols = np.unique(np.stack([rows, cols]), axis=1)
    csr = T.coo_to_csr(T.sort_coo(T.COOMatrix((8000, 16384), rows, cols,
                                              rng.standard_normal(rows.size))))
    chain = trc.prepare_routed_df_chain(csr, device=cuda)
    assert len(chain.domains) == 3 and chain.counts["df_permute"] == 1
    x = torch.as_tensor(rng.standard_normal(16384), device=cuda)
    bufs = trc._df_buffers(chain, x)
    for st in chain.stages:  # the sums the gather reads
        trc.run_df_stage(st, bufs, plain=True)
    (gather,) = [s for s in chain.stages if isinstance(s, trc.DFPermuteStage)]
    src = trc._pairs(bufs, gather.src)
    want = trc.df_permute_reference(src[:, 0], src[:, 1], gather.imap.idx, gather.n)
    before = trc.routed_df_permute_cuda.launches
    for n, lead in ((gather.n, 0), (gather.n, 1), (gather.n - 3, 0)):
        y = torch.full((n + lead,), float("nan"), dtype=torch.float64, device=cuda)
        trc.routed_df_permute_cuda(src.view(-1), gather.imap, n, y[lead:])
        torch.cuda.synchronize()
        assert trc.bits_equal(y[lead:], want[:n]), (n, lead)
    assert trc.routed_df_permute_cuda.launches == before + 3
    y = torch.empty(gather.n, dtype=torch.float64, device=cuda)
    _replays_equal(lambda: trc.routed_df_permute_cuda(src.view(-1), gather.imap, gather.n, y), y,
                   want)
    yk = trc.routed_df_spmv(chain, x)
    assert trc.bits_equal(yk, trc.routed_df_spmv(chain, x, plain=True))
    yg = torch.empty_like(yk)
    _replays_equal(lambda: yg.copy_(trc.routed_df_spmv(chain, x)), yg, yk)


@pytest.mark.parametrize("n_pad,n_h", [
    (128, 5), (256, 5), (1024, 5), (2560, 5), (5120, 5), (5120, 20), (40_960, 5), (40_960, 1),
    (192_256, 8), (192_256, 4), (192_256, 1), (192_256, 13), (1_000_064, 7), (1_000_064, 3),
    (1_000_064, 17)])
def test_routed_df_rowdot_kernel_matches_plain(cuda, n_pad, n_h):
    """D-df, one launch, on sparse (hi, lo) blocks (stored zeros: -0
    products) of every launch shape rowdot_plan makes (CTAs of 32 to 256
    threads, 1 to 256 CTAs per tile of 1 to 4 rows, a last tile short, one
    or two closing steps, 1 to 4 columns per residue; caida_like's 8 rows,
    webbase_like's 7 and 3), x in f64 shorter than the block: bit for bit
    its plain version, which is df_dense_rowdot's bits; a rerun and CUDA
    graph replays bit for bit, its tickets back to zero; no other row of y
    written."""
    from spmv_openmp_cuda_tpu_torch.ops import dfloat as tdf
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    rng = np.random.default_rng(n_pad + n_h)
    hh = rng.standard_normal((n_h, n_pad)).astype(np.float32)
    hh[rng.random((n_h, n_pad)) < 0.9] = 0.0
    hl = (hh * 1e-8 * rng.standard_normal((n_h, n_pad))).astype(np.float32)
    hh, hl = (torch.as_tensor(a, device=cuda) for a in (hh, hl))
    x = torch.as_tensor(rng.standard_normal(n_pad - 77), device=cuda)
    n_y = n_h + 5
    rows = torch.as_tensor(rng.permutation(n_y)[:n_h], dtype=torch.int32, device=cuda)
    plan = trc.rowdot_plan(n_pad, n_h)
    part = torch.empty(trc._rowdot_part_elems(plan, n_h), device=cuda)
    tickets = trc._rowdot_tickets(n_h, plan, cuda)
    before = trc.routed_df_rowdot_cuda.launches
    ys = []
    for _ in range(2):
        y = torch.full((n_y,), float("nan"), dtype=torch.float64, device=cuda)
        ys.append(trc.routed_df_rowdot_cuda(hh, hl, rows, plan, x, y, part, tickets))
    torch.cuda.synchronize()
    assert trc.routed_df_rowdot_cuda.launches == before + 2
    assert not tickets.any()  # set back to zero by each tile's closing CTA
    xh, xl = tdf.split_f64_t(x)
    want = tdf.df_combine64(*trc.df_rowdot_reference(hh, hl, xh, xl, plan.threads))
    assert trc.bits_equal(ys[0][rows.long()], want) and trc.bits_equal(ys[0], ys[1])
    assert trc.bits_equal(want, tdf.df_combine64(*trc.df_dense_rowdot(hh, hl, xh, xl)))
    others = [r for r in range(n_y) if r not in rows.tolist()]
    assert torch.isnan(ys[0][others]).all()  # no other row written
    y = torch.full((n_y,), float("nan"), dtype=torch.float64, device=cuda)
    _replays_equal(lambda: trc.routed_df_rowdot_cuda(hh, hl, rows, plan, x, y, part, tickets), y,
                   ys[0])


@pytest.mark.parametrize("closed", [None, "mask", "no mask"])
@pytest.mark.parametrize("case", ["w3", "w16", "w128", "mixed"])
def test_routed_df_gather_reduce_kernel_matches_plain(cuda, case, closed):
    """C-df level 0 forming K3's products from hand-made gather tiles (zero
    values of both signs times x of both signed zeros, columns past x's end,
    offsets -1 and into pad tiles), and the one-tile level its last CTA
    closes, with and without a mask: bit for bit its plain version (which is
    plain K3 followed by plain C-df), a rerun and CUDA graph replays bit for
    bit, one launch each."""
    import torch_df_cases as cases
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    runs = cases.LEVEL0_RUNS[case]
    d = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in cases.level0_case(runs).items()}
    vals, cols = trc.gather_reduce_operands(d["vals"], d["vals_lo"], d["pidx"], d["widx"], d["off"])
    groups, chunks = trc.groups_table(runs, cuda), trc.reduce_chunks(runs, cuda)
    tasks = trc.df_reduce_tasks(chunks)  # made once: no host copy inside a graph capture
    n0, n1 = groups.shape[0], trc.groups_table(cases.CLOSED_RUNS, "cpu").shape[0]
    out = torch.full((2 * (n0 + n1) * LANE,), float("nan"), device=cuda)
    level0 = out[: 2 * n0 * LANE]
    tail, ticket = None, torch.zeros(2, dtype=torch.int32, device=cuda)
    if closed is not None:
        off1, mask1 = (t.to(cuda) for t in cases.closed_level_case(n0, cases.CLOSED_RUNS))
        imap1 = trc.IndexMap(None, off1, int(off1.max()) + 1)
        chunks1 = trc.reduce_chunks(cases.CLOSED_RUNS, cuda)
        tail = (level0, imap1, mask1 if closed == "mask" else None,
                trc.groups_table(cases.CLOSED_RUNS, cuda), chunks1, out[2 * n0 * LANE :],
                trc.df_reduce_tasks(chunks1))
    before = trc.routed_df_gather_reduce_cuda.launches
    outs = []
    for _ in range(2):
        out.fill_(float("nan"))
        trc.routed_df_gather_reduce_cuda(vals, cols, groups, chunks, d["x"], level0, tail, ticket,
                                         tasks)
        torch.cuda.synchronize()
        outs.append(out.clone())
    assert trc.routed_df_gather_reduce_cuda.launches == before + 2
    assert not ticket.any()
    ph, pl = trc.df_gather_reduce_reference(vals, cols, d["x"], runs)
    want = [torch.stack([ph.reshape(-1), pl.reshape(-1)], -1).reshape(-1)]
    assert trc.bits_equal(outs[0][: 2 * n0 * LANE], want[0]) and trc.bits_equal(outs[0], outs[1])
    if tail is not None:
        src = want[0]
        th, tl = trc.df_perm_reduce_reference(src[0::2], src[1::2], tail[1].idx, tail[2],
                                              cases.CLOSED_RUNS)
        want.append(torch.stack([th.reshape(-1), tl.reshape(-1)], -1).reshape(-1))
        assert trc.bits_equal(outs[0][2 * n0 * LANE :], want[1])
    else:
        assert torch.isnan(outs[0][2 * n0 * LANE :]).all()
    _replays_equal(lambda: trc.routed_df_gather_reduce_cuda(vals, cols, groups, chunks, d["x"],
                                                            level0, tail, ticket, tasks),
                   out, outs[0])


@pytest.mark.parametrize("what", ["rows", "sets"])
def test_routed_df_closed_level_refused(cuda, what):
    """A level for level 0's last CTAs to close that is larger than one
    tile of 128 slab rows in 32 CTA-sets (its closers would wait at once on
    more CTA slots than the bound keeps free) is refused: by the wrapper,
    and by the kernel's launcher when a program names it (nothing
    launched, the error raised)."""
    import torch_df_cases as cases
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    runs = cases.LEVEL0_RUNS["w16"]
    d = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in cases.level0_case(runs).items()}
    vals, cols = trc.gather_reduce_operands(d["vals"], d["vals_lo"], d["pidx"], d["widx"], d["off"])
    groups, chunks = trc.groups_table(runs, cuda), trc.reduce_chunks(runs, cuda)
    tasks = trc.df_reduce_tasks(chunks)
    n0 = groups.shape[0]
    off1, _mask1 = (t.to(cuda) for t in cases.closed_level_case(n0, cases.CLOSED_RUNS))
    tgroups, tchunks = trc.groups_table(cases.CLOSED_RUNS, cuda), trc.reduce_chunks(cases.CLOSED_RUNS, cuda)
    ttasks = trc.df_reduce_tasks(tchunks)
    if what == "rows":
        off1 = torch.cat([off1, off1])[: LANE + 1]
    else:
        ttasks = torch.cat([ttasks, torch.full((4 * 33 - ttasks.shape[0], 4), -1, dtype=torch.int32,
                                               device=cuda)])
    imap1 = trc.IndexMap(None, off1, n0 * LANE)
    out = torch.zeros(2 * (n0 + tgroups.shape[0]) * LANE, device=cuda)
    tail = (out[: 2 * n0 * LANE], imap1, None, tgroups, tchunks, out[2 * n0 * LANE :], ttasks)
    ticket = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = trc.routed_df_gather_reduce_cuda.launches
    with pytest.raises(ValueError, match="closed level"):
        trc.routed_df_gather_reduce_cuda(vals, cols, groups, chunks, d["x"], out[: 2 * n0 * LANE],
                                         tail, ticket, tasks)
    if what == "sets":  # the launcher's own bound on the sets (rows it cannot see)
        prog = trc.DFProgram(trc._df_gather_reduce_op(vals, cols, groups, chunks, tasks,
                                                      out[: 2 * n0 * LANE], tail[:5] + (ttasks, tail[5]),
                                                      ticket))
        with pytest.raises(RuntimeError):
            prog.run(d["x"], 0, 0, cuda)
        torch.cuda.synchronize()
    assert trc.routed_df_gather_reduce_cuda.launches == before
    assert not ticket.any()


@pytest.mark.parametrize("width", [1, 2, 3, 5, 7, 70, 128])
def test_routed_df_reduce_kernel_matches_plain(cuda, width):
    """C-df on runs of one width (a group wider than 32 rows is a chunk of
    its own, its blocks of 32 rows warps of one CTA; narrow groups pack into
    chunks) through scattered offsets with -1 among them into (hi, lo) pairs
    side by side, signed zeros among the values, with and without a mask:
    bit for bit its plain version, a rerun and CUDA graph replays bit for
    bit."""
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    rng = np.random.default_rng(width)
    ng = 40
    rows = ng * width + 3
    runs = ((3, ng, width, 0),)
    src_rows = rows + 17
    sh = rng.standard_normal((src_rows, LANE)).astype(np.float32)
    sh[rng.random(sh.shape) < 0.1] = -0.0
    sl = (sh * 1e-8 * rng.standard_normal(sh.shape)).astype(np.float32)
    sh[:, 5], sl[:, 5] = -0.0, -0.0
    off = rng.permutation(src_rows * LANE)[: rows * LANE]
    off[rng.random(off.shape) < 0.1] = -1
    idx = torch.as_tensor(off.astype(np.int32).reshape(rows, LANE), device=cuda)
    imap = trc.IndexMap(None, idx, int(off.max()) + 1)
    src = torch.as_tensor(np.stack([sh.reshape(-1), sl.reshape(-1)], -1).reshape(-1), device=cuda)
    groups, chunks = trc.groups_table(runs, cuda), trc.reduce_chunks(runs, cuda)
    tasks = trc.df_reduce_tasks(chunks)
    mask = torch.as_tensor((rng.random((rows, LANE)) < 0.8).astype(np.float32), device=cuda)
    for mk in (None, mask):
        outs = []
        for _ in range(2):
            out = torch.full((2 * ng * LANE,), float("nan"), device=cuda)
            outs.append(trc.routed_df_reduce_cuda(src, imap, mk, groups, chunks, out, tasks))
        torch.cuda.synchronize()
        ph, pl = trc.df_perm_reduce_reference(src[0::2], src[1::2], idx, mk, runs)
        assert trc.bits_equal(outs[0], torch.stack([ph.reshape(-1), pl.reshape(-1)], -1).reshape(-1))
        assert trc.bits_equal(outs[0], outs[1])
        out = torch.full((2 * ng * LANE,), float("nan"), device=cuda)
        _replays_equal(lambda: trc.routed_df_reduce_cuda(src, imap, mk, groups, chunks, out, tasks),
                       out, outs[0])


# ---------------------------------------------------------------------------
# PL_ELL_ROWS_T and PL_CSR_LANES (csrc/ell_spmv.cu, csrc/lanes_spmv.cu); no
# atomics in either, so a rerun gives the same bits
# ---------------------------------------------------------------------------

ELL_T_CASES = {
    "sg_like_rows": lambda: synth.fem_like(m=20000, n=20000, nnz=300000, spread=2048, lo=6, hi=26, seed=2),
    "power_law": lambda: synth.power_law(5000, 7000, 6.0, seed=4),
    # every row but the band's edges 17 wide: each warp walks the full width
    "uniform": lambda: synth.banded(20000, 20000, 8, fill=1.0, seed=3),
}
LANES_CASES = {
    "delaunay_n12_like": lambda: synth.preset("delaunay_n12_like"),
    "west2021_like": lambda: synth.preset("west2021_like"),
    "raefsky1_like": lambda: synth.preset("raefsky1_like"),
    "cavity10_like": lambda: synth.preset("cavity10_like"),
    # four x windows, n not a multiple of 16384: the last window's empty
    # slots point past n
    "wide": lambda: synth.random_uniform(4096, 50000, density=3e-4, seed=1),
    # G = 64 row groups: 64 KB of warp tiles per CTA
    "g64": lambda: synth.random_uniform(8192, 8192, density=5e-4, seed=2),
}


def _allocated_by(fn, dev):
    """(fn's result, the bytes it left allocated on dev)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_allocated(dev) - before


def _block(nbytes):
    """The caching allocator's size for nbytes: a multiple of 512."""
    return -(-nbytes // 512) * 512


def _oracle_within(yk, csr, x):
    from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv

    o = serial_csr_spmv(csr, x.double().cpu().numpy())
    assert np.abs(yk.double().cpu().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6


@pytest.mark.parametrize("case", list(ELL_T_CASES))
def test_ell_t_kernel_matches_plain(cuda, case):
    from spmv_openmp_cuda_tpu_torch.formats.matrix import device_ell
    from spmv_openmp_cuda_tpu_torch.ops import ell_cuda as tec

    coo = ELL_T_CASES[case]()
    csr = T.coo_to_csr(coo)
    mat = device_ell(T.coo_to_ell(coo), transposed=True, device=cuda)
    x = _x(csr.shape[1], cuda)
    before = tec.ell_t_cuda.launches
    yk = tec.ell_t_cuda(mat, x)
    torch.cuda.synchronize()
    assert tec.ell_t_cuda.launches == before + 1
    assert yk.shape == (csr.shape[0],) and yk.dtype == torch.float32
    _within(yk, tec.ell_t_reference(mat, x))
    _oracle_within(yk, csr, x)
    # each thread stops at its rows' longest: the full-width walk's y (its
    # extra terms are +0 * x[0]), and the kernel's order bit for bit
    plan = mat.__dict__["_cuda_plan"]
    assert torch.equal(yk, tec.ell_t_in_order(mat, x))
    assert torch.equal(yk, tec.ell_t_in_order(mat, x, plan[2]))
    # the layout is checked once: a second call makes no plan
    assert torch.equal(yk, tec.ell_t_cuda(mat, x))
    assert mat.__dict__["_cuda_plan"] is plan


@pytest.mark.parametrize("case", list(LANES_CASES))
def test_lanes_kernel_matches_plain(cuda, case):
    from spmv_openmp_cuda_tpu_torch.formats.lanes import prepare_lanes_small
    from spmv_openmp_cuda_tpu_torch.ops import lanes_cuda as tlc

    csr = T.coo_to_csr(LANES_CASES[case]())
    mat = prepare_lanes_small(csr, device=cuda)
    if case == "wide":
        assert len(mat.window_tiles) == 4 and csr.shape[1] % (128 * 128)
    if case == "g64":
        assert mat.n_groups == 64
    x = _x(csr.shape[1], cuda)
    before = tlc.lanes_cuda.launches
    # one launch, and no buffer but y: no partial tiles in global memory
    yk, held = _allocated_by(lambda: tlc.lanes_cuda(mat, x), cuda)
    assert tlc.lanes_cuda.launches == before + 1
    assert held == _block(4 * csr.shape[0])
    plan = tlc._plan(mat, x.device)
    assert plan.cluster * tlc.WARPS * plan.step * tlc.BATCH >= mat.vals.shape[0]
    _within(yk, tlc.lanes_reference(mat, x))
    _oracle_within(yk, csr, x)
    assert torch.equal(yk, tlc.lanes_cuda(mat, x))


def test_ell_t_refuses_a_value_past_its_row_on_the_card(cuda):
    from spmv_openmp_cuda_tpu_torch.formats.matrix import device_ell
    from spmv_openmp_cuda_tpu_torch.ops import ell_cuda as tec

    coo = synth.power_law(5000, 7000, 6.0, seed=4)
    ell = T.coo_to_ell(coo)
    mat = device_ell(ell, transposed=True, device=cuda)
    r = int(np.argmin(ell.row_lens))
    mat.data[int(ell.row_lens[r]), r] = 1.0
    before = tec.ell_t_cuda.launches
    with pytest.raises(ValueError, match="past its row's length"):
        tec.ell_t_cuda(mat, _x(7000, cuda))
    assert tec.ell_t_cuda.launches == before and "_cuda_plan" not in mat.__dict__


def _device_kernels(fn):
    """Names of the kernels one call of fn launches, from a torch.profiler
    trace (three tries: a trace can come back without device events)."""
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    pytest.fail("no device events in three torch.profiler traces")


@pytest.mark.parametrize("case", ["caida_like", "spiked"])
def test_hdense_kernel_is_one_launch_in_order(cuda, case):
    # kernel D: one launch per product, its last CTA closing it; y bit for
    # bit hdense_in_order (the adds of the two launches it was before), and
    # its ticket back at zero after every launch, so reruns and a CUDA
    # graph's replays give the same bits
    from spmv_openmp_cuda_tpu_torch.formats import routed as trt
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    coo = synth.preset("caida_like") if case == "caida_like" else _routed_spiked()[0]
    csr = T.coo_to_csr(coo)
    chain = trc.build_chain(trt.prepare_routed(csr, device=cuda))
    assert chain.counts["hdense"] == 1
    x = _x(csr.shape[1], cuda)
    bufs = trc._buffers(chain, x)
    bufs["s"].fill_(float("nan"))
    for stage in chain.stages:
        if isinstance(stage, trc.HDenseStage):
            out = trc._view(bufs, stage.out, stage.out_elems())
            part = trc._view(bufs, stage.part, trc._hdense_part_elems(stage.hdense))
            assert int(part[:1].view(torch.int32)) == 0  # the memset zeroed the ticket
            want = out.clone()
            want[stage.target.long()] += trc.hdense_in_order(stage.hdense, x)
            y0 = out.clone()
            trc.run_stage(stage, bufs, plain=False)
            torch.cuda.synchronize()
            assert torch.equal(out, want)
            assert int(part[:1].view(torch.int32)) == 0
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out.copy_(y0)
                trc.run_stage(stage, bufs, plain=False)
            for _ in range(3):
                g.replay()
                torch.cuda.synchronize()
                assert torch.equal(out, want)
            names = _device_kernels(lambda s=stage: trc.run_stage(s, bufs, plain=False))
            routed = [n for n in names if "routed_" in n]
            assert len(routed) == 1 and "routed_hdense_kernel" in routed[0], names
        trc.run_stage(stage, bufs, plain=True)
    kernels = [n for n in _device_kernels(lambda: trc.routed_chain_spmv(chain, x)) if "routed_" in n]
    assert sum("routed_hdense_kernel" in n for n in kernels) == 1
    assert not any("routed_row_sums_kernel" in n for n in kernels)
    assert len(kernels) == sum(chain.counts.values()), kernels


def test_ell_t_and_lanes_wrappers_raise_on_the_card(cuda):
    from spmv_openmp_cuda_tpu_torch.formats.lanes import prepare_lanes_small
    from spmv_openmp_cuda_tpu_torch.formats.matrix import device_ell
    from spmv_openmp_cuda_tpu_torch.ops import ell_cuda as tec
    from spmv_openmp_cuda_tpu_torch.ops import lanes_cuda as tlc

    coo = synth.random_uniform(1000, 1000, density=5e-3, seed=3)
    csr = T.coo_to_csr(coo)
    x = _x(1000, cuda)
    ell = device_ell(T.coo_to_ell(coo), transposed=True, device=cuda)
    with pytest.raises(TypeError):
        tec.ell_t_cuda(ell, x.double())
    with pytest.raises(ValueError):
        tec.ell_t_cuda(ell, x.cpu())  # operands on the card, x on the CPU
    lanes = prepare_lanes_small(csr, device=cuda)
    with pytest.raises(TypeError):
        tlc.lanes_cuda(lanes, x.half())
    with pytest.raises(ValueError):
        tlc.lanes_cuda(dataclasses.replace(lanes, n_groups=65), x)


def test_new_modes_through_the_harness(cuda):
    from spmv_openmp_cuda_tpu_torch.bench.harness import run_all

    names = ["CSR_ROWS", "CSR_ROWS_GROUPS", "CSR_TILES", "CSR_TILES_ALLOCD", "ELL_ROWS",
             "ELL_ROWS_GROUPS", "ELL_TILES", "ELL_ROWS_T", "ELL_ROWS_NOSIMD", "ELL_ROWS_NORL",
             "CSR_ROWS_BINNED", "PL_ELL_ROWS_T", "PL_CSR_LANES"]
    coo = synth.preset("delaunay_n12_like")
    csr, ell = T.coo_to_csr(coo), T.coo_to_ell(coo)
    xn = np.random.default_rng(5).standard_normal(csr.shape[1])
    for dtype in ("float32", "float64"):
        cfg = T.Config(avg_times_iteration=2, dtype=dtype)
        rep = run_all(csr, ell, xn, cfg, kernels=names, device="cuda", x_check=xn)
        for r in rep.results:
            if dtype == "float64" and r.kernel.startswith("PL_"):
                assert r.error is not None  # f32 kernels: the CLI remaps them
                continue
            assert r.error is None and r.ok and r.deterministic, (r.kernel, r.error)
            assert r.check_ratio <= 1.0, (r.kernel, r.check_ratio)


# ---------------------------------------------------------------------------
# solvers (models/solvers.py) and prepared-format files on the card
# ---------------------------------------------------------------------------


def _spd(m, half_bw, seed):
    """tests/test_solvers.py's SPD band (diagonally dominant)."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, m))
    for off in range(1, half_bw + 1):
        v = rng.standard_normal(m - off) * 0.3
        idx = np.arange(m - off)
        d[idx, idx + off] = v
        d[idx + off, idx] = v
    d[np.arange(m), np.arange(m)] = np.abs(d).sum(axis=1) + 1.0
    r, c = np.nonzero(d)
    return T.coo_to_csr(T.COOMatrix((m, m), r, c, d[r, c])), d


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fmt", ["dia", "dia_resid", "window", "lanes", "routed", "ell_t", "binned"])
def test_graphed_cg_equals_eager_cg(cuda, fmt, dtype, monkeypatch):
    """Every format AutoSpMV can choose is captured in the CG graph: no
    wrapper syncs the host inside capture. The graphed solve (chunks of
    masked iterations), from the first iteration and from the middle of
    the solve on, is bit for bit the eager loop, with the same iteration
    count; so is power iteration's (replayed chunks and an eager rest)."""
    from spmv_openmp_cuda_tpu_torch.models import solvers
    from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV

    csr, dense = _spd(1500, 6, seed=3)
    model = AutoSpMV.from_csr(csr, cfg=T.Config(dtype=dtype), format=fmt, device=cuda)
    xstar = np.random.default_rng(1).standard_normal(1500)
    b = dense @ xstar
    tol = 1e-10 if dtype == "float64" else 1e-5
    eager = solvers.conjugate_gradient(model, b, tol=tol, maxiter=500, graph=False)
    graphed = solvers.conjugate_gradient(model, b, tol=tol, maxiter=500, graph=True)
    monkeypatch.setattr(solvers, "GRAPH_AFTER", 5)
    switched = solvers.conjugate_gradient(model, b, tol=tol, maxiter=500)
    for res in (graphed, switched):
        assert torch.equal(res.x, eager.x) and int(res.iters) == int(eager.iters) < 500
    assert graphed.x.device.type == "cuda"
    err = np.abs(graphed.x.double().cpu().numpy() - xstar).max()
    assert err < (1e-6 if dtype == "float64" else 5e-2), err
    pe = solvers.power_iteration(model, 1500, iters=20, seed=2, graph=False)
    for pg in (solvers.power_iteration(model, 1500, iters=20, seed=2, graph=True),
               solvers.power_iteration(model, 1500, iters=20, seed=2)):
        assert torch.equal(pe.eigenvector, pg.eigenvector)
        assert torch.equal(pe.eigenvalue, pg.eigenvalue)


@pytest.mark.parametrize("mode,dtype", [
    ("PL_DIA_ROWS", "float32"), ("PL_DIA_F64", "float64"), ("PL_CSR_WINDOW_BF16", "float32"),
    ("PL_CSR_WINDOW_F64", "float64"), ("PL_CSR_ROUTED", "float32"), ("PL_CSR_ROUTED_F64", "float64"),
    ("PL_CSR_LANES", "float32"), ("PL_ELL_ROWS_T", "float32"), ("CSR_ROWS_BINNED", "float32"),
])
def test_load_prepared_on_the_card(cuda, tmp_path, mode, dtype):
    """A file saved from the card's operands loads onto the card (the chain
    or plan rebuilt there), and its y is torch.equal to the prepared y."""
    from spmv_openmp_cuda_tpu_torch.formats.serialize import load_prepared, save_prepared

    if mode.startswith("PL_DIA"):
        coo = synth.banded(3000, 3000, 8, fill=0.9, seed=1)
    else:
        coo = synth.preset("delaunay_n12_like")
    csr, ell = T.coo_to_csr(coo), T.coo_to_ell(coo)
    spec = registry.get(mode)
    ops = spec.prepare(csr, ell, T.Config(dtype=dtype), cuda)
    path = str(tmp_path / "p.npz")
    save_prepared(path, ops)
    loaded = load_prepared(path)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(csr.shape[1]),
                        dtype=torch.float64 if spec.f64 else torch.float32, device=cuda)
    assert torch.equal(spec.jitted(loaded)(x), spec.jitted(ops)(x))


# ---------------------------------------------------------------------------
# the multi-device paths (spmv_openmp_cuda_tpu_torch/parallel/) on 4 shards
# of the card, against the same paths' plain versions on the CPU
# ---------------------------------------------------------------------------

#: path -> its matrix (tests/test_sharded.py's cases)
SHARDED_CASES = {
    "ell_rows": lambda: synth.power_law(190, 170, 5.0, seed=21),
    "csr_psum": lambda: synth.power_law(190, 170, 5.0, seed=21),
    "ell_ring": lambda: synth.power_law(190, 170, 5.0, seed=21),
    "dia_halo": lambda: synth.banded(5000, 5000, 140, fill=0.3, seed=7),
    "dia_halo_df": lambda: synth.banded(5000, 5000, 140, fill=0.3, seed=7),
    "window_halo": lambda: synth.fem_like(m=12000, n=12000, nnz=150000, spread=700, lo=5, hi=20,
                                          seed=8),
    "routed_spmd": lambda: synth.power_law(6000, 6000, avg_nnz_per_row=7.0, alpha=1.5, seed=11),
    "routed_md": lambda: synth.power_law(20000, 20000, 6.0, alpha=1.6, seed=7),
}


@pytest.mark.parametrize("path", list(SHARDED_CASES))
def test_sharded_path_on_four_shards_of_the_card(cuda, path):
    from spmv_openmp_cuda_tpu_torch.bench import scaling

    coo = SHARDED_CASES[path]()
    csr = T.coo_to_csr(coo)
    on_card = scaling.build(path, coo, csr, [cuda] * 4)
    plain = scaling.build(path, coo, csr, [torch.device("cpu")] * 4)
    xn = np.random.default_rng(1).standard_normal(csr.shape[1])
    yk, yp = on_card.y(xn), plain.y(xn)
    rel = 1e-12 if path == "dia_halo_df" else 1e-5
    err = np.abs(yk - yp).max()
    assert err <= rel * np.abs(yp).max() + (0 if path == "dia_halo_df" else 1e-6), err
    xs = on_card.place(xn)
    first, again = on_card.product(xs), on_card.product(xs)
    if isinstance(first, tuple):
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    else:
        assert torch.equal(first, again)


@pytest.mark.parametrize("case", ["halo", "all_gather"])
def test_sharded_window_kernel_with_x_lo(cuda, case):
    """window_blocks_kernel with x_lo on each shard's halo'd x: one launch
    per shard, against its plain version, and y torch.equal to the kernel
    on the unsharded layout and to the op built by the converter from the
    same padded block arrays (both cases pad blocks: 3 -> 4 and 1 -> 8)."""
    from spmv_openmp_cuda_tpu_torch.parallel import mesh as tmesh
    from spmv_openmp_cuda_tpu_torch.parallel import sharded as tsh

    coo, d = ((synth.fem_like(m=12000, n=12000, nnz=150000, spread=700, lo=5, hi=20, seed=8), 4)
              if case == "halo" else
              (synth.fem_like(m=2048, n=2048, nnz=16384, spread=900, lo=4, hi=12, seed=9), 8))
    csr = T.coo_to_csr(coo)
    xn = np.random.default_rng(2).standard_normal(csr.shape[1])
    ys = {}
    cuda_mesh = tmesh.make_mesh((d, 1), devices=[cuda] * d)
    for dev in (cuda, torch.device("cpu")):
        mesh = tmesh.make_mesh((d, 1), devices=[dev] * d)
        op = tsh.prepare_window_sharded(csr, mesh)
        assert op.halo_ok is (case == "halo")
        xs = tsh.pad_x_for_window_sharded(xn, op, mesh, torch.float32)
        before = twc.window_blocks_cuda.launches
        ys[dev.type] = tsh.make_window_sharded(mesh, op)(op, xs)
        assert twc.window_blocks_cuda.launches - before == (d if dev.type == "cuda" else 0)
        assert op.nd * op.nb_local > op.layout.nblocks == op.plan_blocks
    arrays = [torch.cat([getattr(s, f).cpu() for s in op.shards]).numpy()
              for f in ("vals", "sidx", "gid", "rsrc")]
    conv = tsh.window_sharded_from_jax(*arrays, op.shape, op.nnz, op.g, op.k_pad, op.wr,
                                       op.nspecs, op.nb_local, op.nd, op.k_c, cuda_mesh)
    xs = tsh.pad_x_for_window_sharded(xn, conv, cuda_mesh, torch.float32)
    assert torch.equal(tsh.make_window_sharded(cuda_mesh, conv)(conv, xs), ys["cuda"])
    _within(ys["cuda"], ys["cpu"].to(cuda))
    whole = twin.prepare_window_auto(csr, xdirect=False, bps=1, device=cuda)
    assert torch.equal(ys["cuda"], twc.window_spmv(whole, torch.as_tensor(xn, dtype=torch.float32,
                                                                          device=cuda)))


def test_two_ranks_share_the_card(cuda, tmp_path):
    """Two spawned gloo ranks, two shards of the card each: every shard_map
    path's joined y and the collectives torch.equal the one-process ones on
    four shards of the card (tests/torch_multiprocess_ranks.py, whose CPU
    twin is tests/test_torch_multiprocess.py)."""
    import torch_multiprocess_ranks as R
    from spmv_openmp_cuda_tpu_torch.parallel.launch import run_ranks

    run_ranks(R.rank_main, 2, "gloo", args=(str(tmp_path), 2, "cuda:0"), timeout=300)
    one = R.outputs([cuda] * 4, 4)
    coll = R.collectives([cuda] * 4, 4)
    for r in range(2):
        rec = torch.load(tmp_path / f"rank{r}.pt")
        assert rec["process"] == (r, 2)
        for name, want in one["y"].items():
            assert all(torch.equal(a, b) for a, b in zip(rec["y"][name], want)), (r, name)
        assert all(torch.equal(rec["collectives"][k], v) for k, v in coll.items())


def test_dryrun_multichip_on_the_card(cuda, capsys):
    from spmv_openmp_cuda_tpu_torch import contract

    contract.dryrun_multichip(4)
    assert "all OK" in capsys.readouterr().out
    fn, (mat, x) = contract.entry()
    assert fn(mat, x).device.type == "cuda"
