"""The port's solvers (models/solvers.py) against the JAX package's, on the
CPU, from the same seeded inputs (tests/test_solvers.py's SPD band).

Tolerances: f32 CG x within 1e-3 * max|x| of the JAX CG's (both f32 matvecs
and f32 vector ops, summed in other orders over ~10 iterations), |Δiters|
<= 2, and the JAX test's 5e-2 against x*; f64 CG (the double-float engine)
1e-6 against x* and 1e-9 * max|x| of the JAX CG's; power iteration's
eigenvalue 1e-4 relative of the JAX one and its eigenvector 1e-3 up to sign
(the two start vectors differ: the JAX PRNG stream is not reproduced). The
masked, chunked body the CUDA graph captures is held bit for bit to the
plain loop.
"""
import jax
import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu as J
from spmv_openmp_cuda_tpu.config import Config as JConfig
from spmv_openmp_cuda_tpu.models import solvers as jsol
from spmv_openmp_cuda_tpu.models.auto import AutoSpMV as JAuto
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch.config import Config
from spmv_openmp_cuda_tpu_torch.formats.convert import sort_coo
from spmv_openmp_cuda_tpu_torch.formats.matrix import COOMatrix
from spmv_openmp_cuda_tpu_torch.models import solvers as tsol
from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV as TAuto


def _spd_coo(m, half_bw, seed):
    """Symmetric positive-definite banded matrix (diagonally dominant):
    tests/test_solvers.py's construction."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, m))
    for off in range(1, half_bw + 1):
        v = rng.standard_normal(m - off) * 0.3
        idx = np.arange(m - off)
        d[idx, idx + off] = v
        d[idx + off, idx] = v
    d[np.arange(m), np.arange(m)] = np.abs(d).sum(axis=1) + 1.0
    r, c = np.nonzero(d)
    return sort_coo(COOMatrix((m, m), r, c, d[r, c])), d


def _both(m, half_bw, seed):
    coo, dense = _spd_coo(m, half_bw, seed)
    tcsr = T.coo_to_csr(coo)
    jcsr = J.CSRMatrix(shape=tcsr.shape, indptr=tcsr.indptr, indices=tcsr.indices, data=tcsr.data)
    return tcsr, jcsr, dense


@pytest.mark.parametrize("fmt", ["dia", "window", "routed"])
def test_cg_matches_jax(fmt):
    tcsr, jcsr, dense = _both(600, 6, seed=3)
    xstar = np.random.default_rng(1).standard_normal(600)
    b = (dense @ xstar).astype(np.float32)
    res_t = tsol.conjugate_gradient(TAuto.from_csr(tcsr, format=fmt, device="cpu"), b,
                                    tol=1e-5, maxiter=400)
    res_j = jsol.conjugate_gradient(JAuto.from_csr(jcsr, format=fmt), b, tol=1e-5, maxiter=400)
    x_t, x_j = res_t.x.double().numpy(), np.asarray(res_j.x, np.float64)
    assert res_t.x.dtype == torch.float32
    assert abs(int(res_t.iters) - int(res_j.iters)) <= 2
    assert np.abs(x_t - x_j).max() <= 1e-3 * np.abs(x_j).max()
    assert float(res_t.relres) < 1e-4
    assert np.abs(x_t - xstar).max() < 5e-2


def test_cg_double_float_engine_matches_jax():
    tcsr, jcsr, dense = _both(500, 5, seed=7)
    xstar = np.random.default_rng(2).standard_normal(500)
    b = dense @ xstar
    model = TAuto.from_csr(tcsr, cfg=Config(dtype="float64"), device="cpu")
    res_t = tsol.conjugate_gradient(model, b, tol=1e-10, maxiter=600)
    with jax.enable_x64(True):
        jmodel = JAuto.from_csr(jcsr, cfg=JConfig(dtype="float64"))
        res_j = jsol.conjugate_gradient(jmodel, b, tol=1e-10, maxiter=600)
        x_j = np.asarray(res_j.x, np.float64)
    assert model.format == "dia" and res_t.x.dtype == torch.float64
    x_t = res_t.x.numpy()
    assert np.abs(x_t - xstar).max() < 1e-6
    assert np.abs(x_t - x_j).max() <= 1e-9 * np.abs(x_j).max()


def test_power_iteration_matches_jax():
    # lambda_2 / lambda_1 = 0.9855: after 1000 iterations both start
    # vectors have converged to the dominant pair (0.9855^1000 = 5e-7)
    tcsr, jcsr, dense = _both(300, 3, seed=9)
    res_t = tsol.power_iteration(TAuto.from_csr(tcsr, device="cpu"), 300, iters=1000, seed=1)
    res_j = jsol.power_iteration(JAuto.from_csr(jcsr), 300, iters=1000, seed=1)
    lam_j = float(res_j.eigenvalue)
    assert abs(float(res_t.eigenvalue) - lam_j) <= 1e-4 * abs(lam_j)
    v_t, v_j = res_t.eigenvector.double().numpy(), np.asarray(res_j.eigenvector, np.float64)
    v_t *= np.sign(v_t @ v_j)
    assert np.abs(v_t - v_j).max() <= 1e-3
    assert abs(float(res_t.eigenvalue) - np.linalg.eigvalsh(dense)[-1]) <= 1e-4 * lam_j


@pytest.mark.parametrize("fmt,chunk", [("dia", 1), ("dia", 7), ("window", 32), ("routed", 5)])
def test_masked_chunks_equal_the_plain_loop(fmt, chunk):
    """The body the CUDA graph captures (chunk masked iterations, the
    condition on the device), run eagerly: x and k bit for bit the plain
    loop's, past convergence too (the masked iterations change nothing)."""
    tcsr, _, dense = _both(600, 6, seed=3)
    model = TAuto.from_csr(tcsr, format=fmt, device="cpu")
    b = torch.as_tensor(dense @ np.random.default_rng(4).standard_normal(600), dtype=torch.float32)
    plain = tsol.conjugate_gradient(model, b, tol=1e-5, maxiter=400)
    state, thr, _ = tsol.cg_initial(model, b, torch.zeros_like(b), 1e-5)
    active, replays = True, 0
    while active:
        state, flag = tsol.cg_chunk(model, state, thr, 400, chunk)
        active, replays = bool(flag), replays + 1
    assert torch.equal(state[0], plain.x) and int(state[4]) == int(plain.iters)
    assert replays == -(-int(plain.iters) // chunk)
    # one more chunk past convergence leaves the state untouched
    again, _ = tsol.cg_chunk(model, state, thr, 400, chunk)
    assert all(torch.equal(a, b) for a, b in zip(again, state))


def test_cg_respects_maxiter():
    tcsr, jcsr, _ = _both(300, 3, seed=9)
    b = np.ones(300, np.float32)
    res_t = tsol.conjugate_gradient(TAuto.from_csr(tcsr, device="cpu"), b, tol=0.0, maxiter=7)
    res_j = jsol.conjugate_gradient(JAuto.from_csr(jcsr), b, tol=0.0, maxiter=7)
    assert int(res_t.iters) == int(res_j.iters) == 7
    np.testing.assert_allclose(float(res_t.relres), float(res_j.relres), rtol=1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        tsol.conjugate_gradient(TAuto.from_csr(tcsr, device="cpu"), b, graph=True)


def test_solvers_default_to_the_card():
    """A matvec that carries no device (a plain callable) gets its vectors
    on the card unless the caller asks for the CPU: without a card, that
    default raises (as AutoSpMV.from_csr does)."""
    tcsr, _, dense = _both(200, 3, seed=5)
    model = TAuto.from_csr(tcsr, device="cpu")
    b = torch.as_tensor(dense @ np.ones(200), dtype=torch.float32)
    res = tsol.conjugate_gradient(model.__call__, b, tol=1e-5, maxiter=100, device="cpu")
    ref = tsol.conjugate_gradient(model, b, tol=1e-5, maxiter=100)
    assert torch.equal(res.x, ref.x) and res.x.device.type == "cpu"
    pw = tsol.power_iteration(model.__call__, 200, iters=5, device="cpu")
    assert torch.equal(pw.eigenvector, tsol.power_iteration(model, 200, iters=5).eigenvector)
    if torch.cuda.is_available():
        assert tsol.conjugate_gradient(lambda v: v, b, maxiter=1).x.device.type == "cuda"
        assert tsol.power_iteration(lambda v: v, 8, iters=1).eigenvector.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tsol.conjugate_gradient(lambda v: v, b)
        with pytest.raises(RuntimeError, match="cuda"):
            tsol.power_iteration(lambda v: v, 8)
