"""The port's multi-device paths across processes, on the CPU: two ranks of
a gloo group (spawned by parallel/launch.py::run_ranks, once for the
module), each with two CPU shards of a 4-shard mesh, run the seven
shard_map paths on the dryrun's matrices and x (contract.dryrun_cases), the
column psum once more over a cols axis that spans both ranks, and the
collectives on hand-made shards (tests/torch_multiprocess_ranks.py).

Every joined y, on both ranks, is torch.equal to the one-process y on a
4-shard CPU mesh computed here; each rank held exactly its own shards. The
window halo and the SPMD routed y are held to the JAX package's shard_map y
on 4 of its virtual CPU devices within 1e-5*max|y| + 1e-6 (as
tests/test_torch_sharded.py). Path 5 refuses another rank's device, and a
failing or hung rank fails the launch within its timeout.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu as J
from spmv_openmp_cuda_tpu.parallel import mesh as JM
from spmv_openmp_cuda_tpu.parallel import routed_spmd as jspmd
from spmv_openmp_cuda_tpu.parallel import sharded as jsh
from spmv_openmp_cuda_tpu_torch.contract import dryrun_cases
from spmv_openmp_cuda_tpu_torch.parallel.launch import run_ranks
import torch_multiprocess_ranks as R

WORLD, SHARDS = 2, 2
N = WORLD * SHARDS


@pytest.fixture(scope="module")
def cases():
    return dryrun_cases()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's record (rank_main), from one launch of the group."""
    out = tmp_path_factory.mktemp("ranks")
    run_ranks(R.rank_main, WORLD, "gloo", args=(str(out), SHARDS), timeout=120)
    return [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_process(cases):
    """The same products in this process, on a 4-shard CPU mesh."""
    return R.outputs([R.CPU] * N, N, cases)


@pytest.mark.parametrize("name", [*R.SHARD_MAP_PATHS, R.PSUM_ACROSS])
def test_two_ranks_give_the_one_process_y(ranks, one_process, name):
    want = one_process["y"][name]
    for r, rec in enumerate(ranks):
        got = rec["y"][name]
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want)), r
        # rank r holds its own shards only: shards 2r, 2r + 1 of a (4, 1) or
        # (1, 4) mesh; the (2, 2) psum's cols axis lies in rank 0
        own = [r == 0] * 2 if name == "csr_psum" else [i // SHARDS == r for i in range(N)]
        assert rec["held"][name] == own
        assert all(one_process["held"][name])


def test_collectives_cross_ranks(ranks):
    """ppermute both ways and one pair, psum and all_gather over both axes:
    torch.equal the one-process results and their values."""
    want = R.collectives([R.CPU] * N, N)
    vals = torch.arange(1.0, N + 1).repeat_interleave(3)
    for axis in ("rows", "cols"):
        assert torch.equal(want[f"ppermute {axis} +1"], vals.roll(3))
        assert torch.equal(want[f"ppermute {axis} -1"], vals.roll(-3))
        assert torch.equal(want[f"ppermute {axis} 0->last"],
                           torch.cat([torch.zeros(3 * (N - 1)), vals[:3]]))
        assert torch.equal(want[f"psum {axis}"], torch.full((3 * N,), vals.sum() / 3))
        assert torch.equal(want[f"all_gather {axis}"], vals.repeat(N))
    for rec in ranks:
        assert rec["collectives"].keys() == want.keys()
        assert all(torch.equal(rec["collectives"][k], v) for k, v in want.items())


def test_ranks_see_the_group(ranks):
    for r, rec in enumerate(ranks):
        assert rec["process"] == (r, WORLD)
        assert rec["global_devices"] == [(i // SHARDS, "cpu") for i in range(N)]


def test_path5_refuses_another_ranks_device(ranks):
    for r, rec in enumerate(ranks):
        assert rec["path5"] is not None and f"belongs to rank {1 - r}" in rec["path5"]


def _jax_y(path, csr, x):
    jcsr = J.CSRMatrix(shape=csr.shape, indptr=csr.indptr, indices=csr.indices, data=csr.data)
    jm = JM.make_mesh((N, 1), devices=jax.devices()[:N])
    if path == "window_halo":
        jop = jsh.prepare_window_sharded(jcsr, jm)
        return jsh.make_window_sharded(jm, jop)(
            jop, jsh.pad_x_for_window_sharded(x, jop, jm, jnp.float32))
    jop = jspmd.prepare_routed_spmd(jcsr, jm)
    return jspmd.make_routed_spmd(jm, jop)(jop, jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("path", ["window_halo", "routed_spmd"])
def test_against_the_jax_shard_map(one_process, cases, path):
    """The one-process y (which both ranks equal bit for bit) against the
    JAX package's shard_map program on the same matrix and x."""
    _, csr, x = cases[path]
    with jax.enable_x64(False):
        yj = np.asarray(_jax_y(path, csr, x), np.float64)
    y = one_process["y"][path][0].double().numpy()
    assert y.shape == yj.shape
    assert np.abs(y - yj).max() <= 1e-5 * np.abs(yj).max() + 1e-6


@pytest.mark.parametrize("body,timeout,said", [
    # rank 0's barrier may fail too, once rank 1's connection drops
    (R.failing_rank, 60, r"rank\(s\) \[(0, )?1\] of 2 exited with code\(s\) \[(1, )?1\]"),
    (R.hung_rank, 4, r"rank\(s\) \[(0, )?1\] of 2 still running after 4 s"),
], ids=["raises", "hangs"])
def test_a_failing_rank_fails_the_launch(body, timeout, said):
    t = time.monotonic()
    with pytest.raises(RuntimeError, match=said):
        run_ranks(body, WORLD, "gloo", timeout=timeout)
    assert time.monotonic() - t < timeout + 15
