"""The port's routed multi-device paths against the JAX package's, on the CPU:
the schema'd routed prepare (formats/routed.py: routed_schema_stats,
merge_routed_schemas, prepare_routed(schema=...)), the SPMD routed engine
(parallel/routed_spmd.py) and the multi-device routed engine
(parallel/sharded.py, path 5). The JAX side runs on the 8 virtual CPU
devices of tests/conftest.py, its Pallas kernels in interpret mode; the
port's shards on the CPU, where the routed chain runs its plain versions.

Layouts must be array-equal (every stage array and static field, as in
tests/test_torch_routed.py). y: the port's against JAX's on x ~ N(0, 1)
within 1e-5*max|y| + 1e-6 (f32 sums of the same terms in another order),
and against the oracle of the matrix with the reference's protocol and the
same relative bound, of the matrix as stored (ops/routed_cuda.py::stored_csr:
a dense heavy block holds bf16 rows; a schema takes no heavy split)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu as J
from spmv_openmp_cuda_tpu.formats import routed as jr
from spmv_openmp_cuda_tpu.parallel import mesh as JM
from spmv_openmp_cuda_tpu.parallel import routed_spmd as jspmd
from spmv_openmp_cuda_tpu.parallel import sharded as jsh
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch.config import LANE
from spmv_openmp_cuda_tpu_torch.formats import routed as tr
from spmv_openmp_cuda_tpu_torch.io.vectors import fill_rnd_vector
from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu_torch.parallel import mesh as TM
from spmv_openmp_cuda_tpu_torch.parallel import routed_spmd as tspmd
from spmv_openmp_cuda_tpu_torch.parallel import sharded as tsh
from spmv_openmp_cuda_tpu_torch.utils import synth
from spmv_openmp_cuda_tpu_torch.utils.compare import vectors_diff
from test_torch_routed import PLAN_FIELDS, _routed_equal
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


_MEMO = {}


def _pair(name):
    """(port CSR, JAX CSR): test_sharded.py's SPMD matrix, its multi-device
    one, and a matrix with empty rows."""
    if name not in _MEMO:
        if name == "spmd":
            coo = synth.power_law(m=6000, n=6000, avg_nnz_per_row=7.0, alpha=1.5, seed=11)
        elif name == "md":
            coo = synth.power_law(60_000, 60_000, 6.0, alpha=1.6, seed=41)
        else:  # rows 0-99 and 3000-3999 empty, one 600-nnz row, and rows
            # 5000-5299 one nnz each in a column of residue 0 (their chunk's
            # deep gather tiles: the other chunks pad to them)
            rng = np.random.default_rng(5)
            rows = np.r_[rng.integers(100, 3000, 9000), rng.integers(4000, 6000, 6000),
                         np.full(600, 4500), np.arange(5000, 5300)]
            cols = np.r_[rng.integers(0, 6000, 15000), rng.choice(6000, 600, replace=False),
                         128 * rng.integers(0, 6000 // 128, 300)]
            rows, cols = np.unique(np.stack([rows, cols]), axis=1)
            coo = T.sort_coo(T.COOMatrix((6000, 6000), rows, cols,
                                         rng.standard_normal(rows.shape[0])))
        t = T.coo_to_csr(coo)
        _MEMO[name] = (t, J.CSRMatrix(shape=t.shape, indptr=t.indptr, indices=t.indices,
                                      data=t.data))
    return _MEMO[name]


def _jax_spmd(mesh_shape):
    """(JAX mesh, JAX prepare_routed_spmd op) of the SPMD matrix, built once
    per mesh shape (its schema'd prepare is the slow part of this file)."""
    key = ("jax_spmd", mesh_shape)
    if key not in _MEMO:
        n = mesh_shape[0] * mesh_shape[1]
        jm = JM.make_mesh(mesh_shape, devices=jax.devices()[:n])
        _MEMO[key] = (jm, jspmd.prepare_routed_spmd(_pair("spmd")[1], jm))
    return _MEMO[key]


def _xn(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n)


def _close(y_t, y_j):
    y_t, y_j = y_t.double().numpy(), np.asarray(y_j, np.float64)
    assert y_t.shape == y_j.shape
    err = np.abs(y_t - y_j).max()
    assert err <= 1e-5 * np.abs(y_j).max() + 1e-6, err


def _oracle(y, csr, xn, x_ref, y_ref):
    want = serial_csr_spmv(csr, xn)
    assert np.abs(y.double().numpy() - want).max() <= 1e-5 * np.abs(want).max() + 1e-6
    rep = vectors_diff(y_ref.double().numpy(), serial_csr_spmv(csr, x_ref))
    assert rep.ok, rep


@pytest.mark.parametrize("name,nd,pads,degenerate", [
    ("spmd", 8, False, True), ("holes", 4, True, True),
])
def test_schemad_prepare_matches_jax(name, nd, pads, degenerate):
    tcsr, jcsr = _pair(name)
    bounds = tspmd._fair_nnz_bounds(tcsr, nd)
    assert bounds == jspmd._fair_nnz_bounds(jcsr, nd)
    tch = [tr._sub_csr(tcsr, bounds[b], bounds[b + 1]) for b in range(nd)]
    jch = [jr._sub_csr(jcsr, bounds[b], bounds[b + 1]) for b in range(nd)]
    tstats = [tr.routed_schema_stats(c) for c in tch]
    assert tstats == [jr.routed_schema_stats(c) for c in jch]
    schema = tr.merge_routed_schemas(tstats)
    assert schema == jr.merge_routed_schemas(tstats)
    tmats = [tr.prepare_routed(c, schema=schema, device="cpu") for c in tch]
    if name == "spmd":
        # JAX's chunks as its SPMD prepare stacked them (prepare_routed with
        # this schema; shape and nnz canonicalised for the stack)
        jop = _jax_spmd((nd, 1))[1]
        assert jop.bounds == bounds
        for b, (tm, c) in enumerate(zip(tmats, tch)):
            assert tm.shape == c.shape and tm.nnz == c.nnz
            _routed_equal(dataclasses.replace(tm, shape=(jop.h_out * LANE, tcsr.shape[1]), nnz=-1),
                          jax.tree.map(lambda a, b=b: np.asarray(a[b]), jop.mats))
    else:
        for tm, jc in zip(tmats, jch):
            _routed_equal(tm, jr.prepare_routed(jc, schema=schema))
    # what the schema forces shows: pad tiles, degenerate levels, one output
    # domain, no heavy split
    assert {m.perm_out.h for m in tmats} == {tmats[0].perm_out.h}
    assert all(m.hdense is None and m.hvals is None and m.widx_t == () for m in tmats)
    assert any(s["rows_a"] < schema["rows_a"] for s in tstats) is pads
    assert any(len(s["ladders"]) < schema["n_levels"] for s in tstats) is degenerate
    # each chunk through the chain (the plain versions on the CPU) against
    # its oracle
    xn = _xn(tcsr.shape[1])
    for c, m in zip(tch, tmats):
        y = trc.routed_spmv(m, torch.as_tensor(xn, dtype=torch.float32))
        want = serial_csr_spmv(c, xn)
        assert np.abs(y.double().numpy() - want).max() <= 1e-5 * np.abs(want).max() + 1e-6


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_routed_spmd_single_program(mesh_shape):
    """tests/test_sharded.py's case, against the JAX shard_map program."""
    tcsr, _ = _pair("spmd")
    n = mesh_shape[0] * mesh_shape[1]
    jm, jop = _jax_spmd(mesh_shape)
    tm = TM.make_mesh(mesh_shape, devices=[CPU] * n)
    top = tspmd.prepare_routed_spmd(tcsr, tm)
    assert (top.bounds, top.nwin, top.h_out) == (jop.bounds, jop.nwin, jop.h_out)
    assert len(top.mats) == mesh_shape[0]
    # the stacked JAX operands, shard by shard
    for b, tm_b in enumerate(top.mats):
        for f in ("vals", "pidx", "widx"):
            np.testing.assert_array_equal(getattr(tm_b, f).numpy(),
                                          np.asarray(getattr(jop.mats, f)[b]), f)
        assert tm_b.runs == jop.mats.runs and tm_b.lvl_runs == jop.mats.lvl_runs
    tf, jf = tspmd.make_routed_spmd(tm, top), jspmd.make_routed_spmd(jm, jop)
    xn = _xn(6000)
    y = tf(top, torch.as_tensor(xn, dtype=torch.float32))
    _close(y, jf(jop, jnp.asarray(xn, jnp.float32)))
    x_ref = fill_rnd_vector(6000, seed=2)
    _oracle(y, tcsr, xn, x_ref, tf(top, torch.as_tensor(x_ref, dtype=torch.float32)))
    assert torch.equal(tf(top, torch.as_tensor(xn, dtype=torch.float32)), y)  # a rerun
    # each shard's y is its chunk's chain run alone
    xt = torch.as_tensor(xn, dtype=torch.float32)
    for b, chain in enumerate(top.chains):
        r0, r1 = top.bounds[b], top.bounds[b + 1]
        assert torch.equal(y[r0:r1], trc.routed_spmv_reference(chain, xt))
    # the op built from the JAX op's arrays gives the same y
    conv = tspmd.routed_spmd_from_jax(
        [_jax_kwargs(jax.tree.map(lambda a, b=b: np.asarray(a[b]), jop.mats))
         for b in range(mesh_shape[0])], jop.bounds, jop.shape, jop.nnz, tm)
    assert torch.equal(tf(conv, xt), y)


def _plan(p):
    return {**{f: None if getattr(p, f) is None else np.asarray(getattr(p, f))
               for f in PLAN_FIELDS}, "t": p.t}


def _jax_kwargs(m) -> dict:
    """ops/routed_cuda.py::routed_from_jax keywords of a JAX RoutedCSR."""
    out = dict(
        vals=np.asarray(m.vals), pidx=np.asarray(m.pidx), widx=np.asarray(m.widx),
        perm_products=_plan(m.perm_products), lvl_perms=[_plan(p) for p in m.lvl_perms],
        lvl_masks=[np.asarray(k) for k in m.lvl_masks], perm_out=_plan(m.perm_out),
        shape=m.shape, nnz=m.nnz, n_windows=m.n_windows, rows_a=m.rows_a, runs=m.runs,
        lvl_runs=m.lvl_runs, out_t=m.out_t, heavy_rows=m.heavy_rows, widx_t=m.widx_t,
        heavy_lanes=m.heavy_lanes,
    )
    if m.hdense is not None:
        out["hdense"] = np.asarray(m.hdense)
    return out


def test_routed_multidevice_chunks():
    """tests/test_sharded.py's case: 4 devices, the chunks array-equal to the
    JAX package's, y against its y and the oracle."""
    tcsr, jcsr = _pair("md")
    top = tsh.prepare_routed_multidevice(tcsr, devices=[CPU] * 4)
    jop = jsh.prepare_routed_multidevice(jcsr, devices=jax.devices()[:4])
    assert len(top.chunks) >= 2 and top.bounds == jop.bounds
    for a, b in zip(top.chunks, jop.chunks):
        _routed_equal(a, b)
    xn = _xn(tcsr.shape[1])
    y = tsh.routed_multidevice_spmv(top, np.asarray(xn, np.float32))
    _close(y, jsh.routed_multidevice_spmv(jop, np.asarray(xn, np.float32)))
    x_ref = fill_rnd_vector(tcsr.shape[1], seed=42)
    # the oracle of the matrix as stored (dense heavy blocks hold bf16 rows)
    stored = trc.stored_csr(tcsr, types.SimpleNamespace(mat=tr.RoutedChunks(
        chunks=top.chunks, bounds=top.bounds, shape=top.shape, nnz=top.nnz)))
    _oracle(y, stored, xn, x_ref, tsh.routed_multidevice_spmv(top, np.asarray(x_ref, np.float32)))
    conv = tsh.routed_multidevice_from_jax([_jax_kwargs(c) for c in jop.chunks], jop.bounds,
                                           jop.shape, jop.nnz, [CPU] * 4)
    assert torch.equal(tsh.routed_multidevice_spmv(conv, torch.as_tensor(xn, dtype=torch.float32)), y)
