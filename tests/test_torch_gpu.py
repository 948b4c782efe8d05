"""The port's CUDA kernels against their plain PyTorch versions, on the card.
The window kernels sum a block's rows in a per-CTA tile and add the tiles
into y with atomics, so their order of additions changes from run to run.

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
    before = tsc.dia_spmv_cuda.launches
    yk = registry.get(mode).jitted(ops)(x)
    torch.cuda.synchronize()
    assert tsc.dia_spmv_cuda.launches == before + 1
    if mode.startswith("PL_DIA_RESID"):
        dr, plan = ops
        yp = tsc.dia_spmv_reference(dr.mat, x, plan, dr)
    else:
        yp = tsc.dia_spmv_reference(ops[0], x, ops[1])
    assert yk.shape == (csr.shape[0],) and yk.dtype == torch.float32
    _within(yk, yp)


def test_fringe_kernel_alone(cuda):
    csr = T.coo_to_csr(synth.preset("raefsky1_like"))
    dr, plan = tsc.prepare_dia_resid(csr, device=cuda)
    x = _x(csr.shape[1], cuda)
    y = torch.zeros(plan.s_pad * LANE, device=cuda)
    before = tsc.dia_resid_cuda.launches
    tsc.dia_resid_cuda(dr, x, y, plan)
    torch.cuda.synchronize()
    assert tsc.dia_resid_cuda.launches == before + 1
    _within(y, tsc.dia_resid_reference(dr, x, plan))


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
    band = synth.banded(3000, 3000, 30, fill=1.0, seed=0)
    rows = np.r_[band.rows, [2998, 2999]]
    cols = np.r_[band.cols, [4300, 5000]]
    vals = np.r_[band.vals, [2.0, 1.0]]
    csr = T.coo_to_csr(T.sort_coo(T.COOMatrix((3000, 6000), rows, cols, vals)))
    dr, plan = tsc.prepare_dia_resid(csr, device=cuda)
    x = _x(6000, cuda)
    yk = tsc.dia_spmv_cuda(dr.mat, x, plan, dr)
    _within(yk, tsc.dia_spmv_reference(dr.mat, x, plan, dr))
    o = torch.as_tensor(
        T.csr_to_dense(csr) @ x.double().cpu().numpy(), dtype=torch.float32, device=cuda
    )
    _within(yk, o)


#: window layouts: the three x forms (standard, shared_w, xdirect), the
#: mod-8 fold with an overflow region, and a per-sub-block bps layout
WINDOW_LAYOUTS = {
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
    assert mat.xdirect == (layout == "xdirect") and mat.shared_w == (layout == "shared_w")
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


ROUTED_LAYOUTS = {
    "level": lambda: (synth.power_law(4000, 4000, avg_nnz_per_row=5.0, alpha=1.6, seed=17), None),
    "spiked": _routed_spiked,
    "heavy_many": _routed_heavy_many,
    "small": lambda: (synth.random_uniform(9000, 9000, density=5e-4, seed=7), None),
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
    for stage, yk, yp in trc.compare_stages(chain, x):
        torch.cuda.synchronize()
        seen.add(stage.kernel)
        if stage.kernel in ("gather", "w_stage"):
            assert torch.equal(yk, yp), stage  # data movement and products
        else:
            _within(yk, yp)
    assert {"gather", "w_stage", "perm_reduce"} <= seen
    assert ("hdense" in seen) == (layout == "spiked")
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
    # a chunk's last W stage writes y from a row bound that is not a
    # multiple of 4 (an output 4-byte aligned only)
    assert any(b % 4 for b in mat.bounds)
    chain = trc.build_chain(mat)
    x = _x(6000, cuda)
    for stage, yk, yp in trc.compare_stages(chain, x):
        torch.cuda.synchronize()
        if stage.kernel in ("gather", "w_stage"):
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
    with pytest.raises(ValueError):
        trc.routed_w_stage_cuda(out.reshape(-1, LANE), 10**6, None, mat.perm_products.w2, None,
                                mat.perm_products.t, True, mat.perm_products.t, out, out.numel())


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
    before = tsc.dia_spmv_df_cuda.launches
    yk = spec.jitted(ops)(xd)
    torch.cuda.synchronize()
    assert tsc.dia_spmv_df_cuda.launches == before + 1
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


@pytest.mark.parametrize("layout", ["level", "spiked", "small"])
def test_routed_df_kernel_matches_plain(cuda, layout):
    from spmv_openmp_cuda_tpu_torch.ops import dfloat as tdf
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc

    coo, _thr = ROUTED_LAYOUTS[layout]()
    csr = T.coo_to_csr(coo)
    chain = trc.prepare_routed_df_chain(csr, device=cuda)
    x = np.random.default_rng(3).standard_normal(csr.shape[1])
    xd = torch.as_tensor(x, device=cuda)
    xh, xl = tdf.split_f64_t(xd)
    mdf = chain.domains[0].mdf
    gk, gp = trc.routed_df_gather(mdf, xh, xl), trc.routed_df_gather(mdf, xh, xl, plain=True)
    torch.cuda.synchronize()
    # products: the kernel's exact FMA error equals the plain Veltkamp error
    assert torch.equal(gk[0], gp[0]) and torch.equal(gk[1], gp[1])
    before = trc.routed_df_gather_cuda.launches
    yk = trc.routed_df_spmv(chain, xd)
    torch.cuda.synchronize()
    assert trc.routed_df_gather_cuda.launches == before + len(chain.domains)
    _df_within(yk, trc.routed_df_spmv(chain, xd, plain=True), csr, x)


# ---------------------------------------------------------------------------
# PL_ELL_ROWS_T and PL_CSR_LANES (csrc/ell_spmv.cu, csrc/lanes_spmv.cu); no
# atomics in either, so a rerun gives the same bits
# ---------------------------------------------------------------------------

ELL_T_CASES = {
    "sg_like_rows": lambda: synth.fem_like(m=20000, n=20000, nnz=300000, spread=2048, lo=6, hi=26, seed=2),
    "power_law": lambda: synth.power_law(5000, 7000, 6.0, seed=4),
}
LANES_CASES = {
    "delaunay_n12_like": lambda: synth.preset("delaunay_n12_like"),
    "west2021_like": lambda: synth.preset("west2021_like"),
    "raefsky1_like": lambda: synth.preset("raefsky1_like"),
    # four x windows, n not a multiple of 16384: the last window's empty
    # slots point past n
    "wide": lambda: synth.random_uniform(4096, 50000, density=3e-4, seed=1),
}


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
    assert torch.equal(yk, tec.ell_t_cuda(mat, x))


@pytest.mark.parametrize("case", list(LANES_CASES))
def test_lanes_kernel_matches_plain(cuda, case):
    from spmv_openmp_cuda_tpu_torch.formats.lanes import prepare_lanes_small
    from spmv_openmp_cuda_tpu_torch.ops import lanes_cuda as tlc

    csr = T.coo_to_csr(LANES_CASES[case]())
    mat = prepare_lanes_small(csr, device=cuda)
    if case == "wide":
        assert len(mat.window_tiles) == 4 and csr.shape[1] % (128 * 128)
    x = _x(csr.shape[1], cuda)
    before = tlc.lanes_cuda.launches
    yk = tlc.lanes_cuda(mat, x)
    torch.cuda.synchronize()
    assert tlc.lanes_cuda.launches == before + 1
    _within(yk, tlc.lanes_reference(mat, x))
    _oracle_within(yk, csr, x)
    assert torch.equal(yk, tlc.lanes_cuda(mat, x))


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
