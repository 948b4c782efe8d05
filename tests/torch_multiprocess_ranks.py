"""Rank bodies of tests/test_torch_multiprocess.py: top-level functions that
spmv_openmp_cuda_tpu_torch/parallel/launch.py::run_ranks starts in spawned
processes (each in a gloo group). They import torch and the port only, and
write what they saw to a file the test reads.

outputs() is also what the test runs in its own process, on a one-process
mesh of as many CPU shards, for the one-process y the ranks are held to.
"""
import time

import torch

from spmv_openmp_cuda_tpu_torch.bench.scaling import build
from spmv_openmp_cuda_tpu_torch.contract import dryrun_cases, dryrun_mesh_shape
from spmv_openmp_cuda_tpu_torch.parallel import collectives as C
from spmv_openmp_cuda_tpu_torch.parallel import mesh as M

CPU = torch.device("cpu")
#: the seven shard_map paths of the JAX package (all but path 5)
SHARD_MAP_PATHS = ("ell_rows", "csr_psum", "ell_ring", "dia_halo", "window_halo",
                   "routed_spmd", "dia_halo_df")
#: the column psum also on a (1, n) mesh, whose cols axis spans every rank
PSUM_ACROSS = "csr_psum (1, n)"


def _host(out) -> tuple:
    return tuple(t.cpu() for t in (out if isinstance(out, tuple) else (out,)))


def outputs(devices, n: int, cases=None) -> dict:
    """The raw output (a tuple of CPU tensors) of one product of each
    shard_map path on the dryrun's matrices and x over `devices` (this
    process's; n shards in all), the column psum once more on a (1, n)
    mesh; and, per path, which shards this process held."""
    cases = cases or dryrun_cases()
    out, held = {}, {}
    for name in (*SHARD_MAP_PATHS, PSUM_ACROSS):
        path = "csr_psum" if name == PSUM_ACROSS else name
        coo, csr, x = cases[path]
        shape = (1, n) if name == PSUM_ACROSS else dryrun_mesh_shape(path, n)
        p = build(path, coo, csr, devices, mesh_shape=shape)
        out[name] = _host(p.product(p.place(x)))
        parts = {"window_halo": "shards", "routed_spmd": "chains"}.get(name, "data")
        held[name] = [q is not None for q in getattr(p.op, parts)]
    return {"y": out, "held": held}


def collectives(mesh_devices, n: int) -> dict:
    """The collectives on hand-made shards (shard i holds i + 1 three
    times): ppermute one shard on and one shard back, psum and all_gather
    over the rows of a (n, 1) mesh and the cols of a (1, n) mesh, each
    joined into one tensor."""
    got = {}
    for shape, axis in (((n, 1), M.ROWS), ((1, n), M.COLS)):
        mesh = M.make_mesh(shape, devices=mesh_devices)
        parts = [torch.full((3,), float(i + 1), device=d) if mine else None
                 for i, (d, mine) in enumerate(zip(mesh.axis_devices(axis), mesh.is_local(axis)))]
        for step in (1, -1):
            perm = [(j, (j + step) % n) for j in range(n)]
            got[f"ppermute {axis} {step:+d}"] = C.gather_to(C.ppermute(parts, mesh, axis, perm),
                                                            mesh, axis)
        got[f"ppermute {axis} 0->last"] = C.gather_to(
            C.ppermute(parts, mesh, axis, [(0, n - 1)]), mesh, axis)
        got[f"psum {axis}"] = C.gather_to(C.psum(parts, mesh, axis), mesh, axis)
        got[f"all_gather {axis}"] = C.gather_to(C.all_gather(parts, mesh, axis), mesh, axis)
    return {k: v.cpu() for k, v in got.items()}


def rank_main(rank: int, world: int, result_dir: str, shards: int, device: str = "cpu") -> None:
    """`shards` shards of `device` a rank: every shard_map path, the
    collectives, runtime_info, and path 5 given another rank's device."""
    import torch.distributed as dist

    from spmv_openmp_cuda_tpu_torch.parallel import sharded as sh
    from spmv_openmp_cuda_tpu_torch.utils.envinfo import runtime_info

    torch.set_num_threads(2)
    t = time.perf_counter()
    devices = [torch.device(device)] * shards
    n = world * shards
    cases = dryrun_cases()
    res = outputs(devices, n, cases)
    res["collectives"] = collectives(devices, n)
    info = runtime_info()
    res["process"] = (info["process_index"], info["process_count"])
    mesh = M.make_mesh(devices=devices)
    res["global_devices"] = [(g.rank, str(g.device)) for g in mesh.global_devices()]
    csr = cases["ell_rows"][1]
    try:
        sh.prepare_routed_multidevice(csr, devices=mesh.global_devices())
        res["path5"] = None
    except ValueError as e:
        res["path5"] = str(e)
    dist.barrier()
    res["seconds"] = time.perf_counter() - t
    torch.save(res, f"{result_dir}/rank{rank}.pt")


def failing_rank(rank: int, world: int) -> None:
    """Rank 1 raises; rank 0 waits for it in a barrier it never reaches."""
    import torch.distributed as dist

    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


def hung_rank(rank: int, world: int) -> None:
    """Rank 1 hangs; rank 0 waits for it in a barrier."""
    import torch.distributed as dist

    if rank == 1:
        time.sleep(3600)
    dist.barrier()
