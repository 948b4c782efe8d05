"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with a GPU: python -m pytest -m gpu tests/test_torch_gpu.py
Elsewhere every test skips (inside the `cuda` fixture, so that all workers
collect the same tests).

Tolerance: max |y_kernel - y_plain| <= 1e-5 * max|y_plain| + 1e-6 on
x ~ N(0, 1): both versions read identical (f32 or bf16) values and sum in
f32; the kernel fuses multiply-adds and orders the fringe sum its own way.
"""
import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch.config import LANE
from spmv_openmp_cuda_tpu_torch.formats import dia as tdia
from spmv_openmp_cuda_tpu_torch.ops import registry
from spmv_openmp_cuda_tpu_torch.ops import spmv_cuda as tsc
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
