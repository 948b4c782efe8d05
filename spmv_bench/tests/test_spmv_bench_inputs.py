"""The benchmark's inputs, reference and roofline arithmetic, on the CPU."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from spmv_bench import generators, inputs, roofline
from spmv_bench.reference import abs_product, csr_indptr, product, product_error, relres
from spmv_bench.spec import BASE

CONFIGS = {
    "graph500-s17-f32": ((131072, 131072), 3728216),
    "poisson2d-1000-f64": ((1000000, 1000000), 4996000),
}


def _config(name):
    return json.loads((BASE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configurations_have_their_published_dims_and_nnz(name):
    cfg = _config(name)
    shape, rows, cols, vals = generators.load(cfg["generator"]).pattern(cfg["structure_seed"], **cfg["params"])
    assert tuple(shape) == CONFIGS[name][0]
    assert rows.shape[0] == cols.shape[0] == CONFIGS[name][1]
    keys = rows.astype(np.int64) * shape[1] + cols
    assert np.all(np.diff(keys) > 0), "sorted by (row, col), no duplicates"
    if vals is not None and not callable(vals):  # the Laplacian's stencil
        assert set(np.unique(vals)) == {-1.0, 4.0}


@pytest.mark.parametrize("grid", [1, 2, 30])
def test_frozen_laplacian_draws_the_ports_pattern(grid):
    """The frozen copy gives the port's utils/synth.py::laplacian_2d."""
    from spmv_openmp_cuda_tpu_torch.utils import synth

    shape, rows, cols, vals = generators.load("laplacian_2d").pattern(7, grid=grid)
    coo = synth.laplacian_2d(grid)
    assert tuple(coo.shape) == tuple(shape)
    np.testing.assert_array_equal(coo.rows, rows)
    np.testing.assert_array_equal(coo.cols, cols)
    np.testing.assert_array_equal(coo.vals, vals)


def test_kronecker_edges_follow_the_initiator():
    """The specification's generator: edgefactor x 2^scale edges, labels in
    range, and (before the labels are permuted) the top bit of each end
    set with the initiator's odds: P(row bit) = C + D, P(col bit) = B + D."""
    from spmv_bench.generators import kronecker

    scale, ef, a, b, c = 12, 16, 0.57, 0.19, 0.19
    i, j = kronecker.edges(np.random.default_rng(3), scale, ef, a, b, c)
    assert i.shape == j.shape == (ef << scale,)
    assert 0 <= min(i.min(), j.min()) and max(i.max(), j.max()) < 1 << scale

    class Same(np.random.Generator):
        def permutation(self, n):
            return np.arange(n)

    i, j = kronecker.edges(Same(np.random.PCG64(3)), scale, ef, a, b, c)
    top = 1 << (scale - 1)
    assert np.mean(i >= top) == pytest.approx(1 - a - b, abs=0.01)
    assert np.mean(j >= top) == pytest.approx(1 - a - c, abs=0.01)


def test_kronecker_matrix_is_the_undirected_graph():
    """(i, j) and (j, i) for every edge, no self-loop, one weight in [0, 1)
    per edge on both of its entries."""
    from spmv_bench.generators import kronecker

    shape, rows, cols, vals = kronecker.pattern(4, scale=9, edgefactor=16, a=0.57, b=0.19, c=0.19)
    i, j = kronecker.edges(np.random.default_rng(4), 9, 16, 0.57, 0.19, 0.19)
    keys = rows * shape[1] + cols
    assert np.all(np.diff(keys) > 0) and not np.any(rows == cols)
    want = {(p, q) for p, q in zip(i.tolist(), j.tolist()) if p != q}
    want |= {(q, p) for p, q in want}
    assert set(zip(rows.tolist(), cols.tolist())) == want
    w = vals(torch.Generator().manual_seed(1), torch.float64, "cpu").numpy()
    assert w.shape == rows.shape and np.all((0 <= w) & (w < 1))
    dense = np.zeros(shape)
    dense[rows, cols] = w
    np.testing.assert_array_equal(dense, dense.T)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pattern_is_fixed_and_values_follow_the_seed(name):
    cfg = _config(name)
    cfg["params"].update({"kronecker": dict(scale=10), "laplacian_2d": dict(grid=20)}[cfg["generator"]])
    a = inputs.make_matrix(cfg, 2**31 + 5, "cpu")
    b = inputs.make_matrix(cfg, 11, "cpu")
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.cols, b.cols)
    if cfg["generator"] == "kronecker":
        assert not np.array_equal(a.data, b.data)
        # values held at the configuration's precision
        np.testing.assert_array_equal(a.data, a.data.astype(np.float32).astype(np.float64))
    else:
        np.testing.assert_array_equal(a.data, b.data)
    again = inputs.make_matrix(cfg, 11, "cpu")
    np.testing.assert_array_equal(again.data, b.data)
    xa = inputs.vectors(11, "x", 2, a.shape[1], cfg["dtype"], "cpu")
    xb = inputs.vectors(12, "x", 2, a.shape[1], cfg["dtype"], "cpu")
    assert not torch.equal(xa[0], xb[0]) and not torch.equal(xa[0], xa[1])
    assert torch.equal(xa[1], inputs.vectors(11, "x", 2, a.shape[1], cfg["dtype"], "cpu")[1])


def test_seeds_of_every_size_give_separate_streams():
    seeds = [0, 1, 2**31 + 3, 2**40, -5]
    got = {inputs.stream_seed(s, k) for s in seeds for k in inputs.STREAMS}
    assert len(got) == len(seeds) * len(inputs.STREAMS)
    assert all(0 <= v < 2**63 for v in got)


def test_reference_against_a_dense_product():
    rng = np.random.default_rng(3)
    m, n = 40, 30
    dense = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.15)
    dense[5] = 0.0  # an empty row, and empty rows at the end
    dense[-3:] = 0.0
    rows, cols = np.nonzero(dense)
    indptr = csr_indptr(m, rows)
    x = rng.standard_normal((n, 3))
    np.testing.assert_allclose(product(indptr, cols, dense[rows, cols], x, block=2), dense @ x, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(abs_product(indptr, cols, dense[rows, cols], x[:, 0]), np.abs(dense) @ np.abs(x[:, 0]))
    y = dense @ x[:, 0]
    scale = np.abs(dense) @ np.abs(x[:, 0])
    assert product_error(y, y, scale) == 0.0
    bad = y.copy()
    bad[7] += 1e-3
    assert product_error(bad, y, scale) > 1e-4
    bad[5] = 1e-30  # an empty row must be exactly zero
    assert product_error(bad, y, scale) > 1e100
    assert product_error(np.full_like(y, np.nan), y, scale) == float("inf")
    sq = dense[:30] + 30 * np.eye(30)
    r2, c2 = np.nonzero(sq)
    xs = np.linalg.solve(sq, x[:, 0])
    assert relres(csr_indptr(30, r2), c2, sq[r2, c2], xs, x[:, 0]) < 1e-14


def test_roofline_counts_the_matrixs_own_bytes():
    assert roofline.product_bytes(1000005, 1000005, 3105536, "float32") == 20_422_184  # 20.42 MB
    assert roofline.product_bytes(1000000, 1000000, 4996000, "float64") == 55_968_000  # 55.97 MB
    assert roofline.product_bytes(131072, 131072, 3728216, "float32") == 15_961_440  # graph500-s17-f32
    assert roofline.product_flops(3105536) == 6_211_072
    t = roofline.least_time_s(1000005, 1000005, 3105536, "float32")
    assert t == pytest.approx(20_422_184 / 3.35e12)  # bandwidth-bound
