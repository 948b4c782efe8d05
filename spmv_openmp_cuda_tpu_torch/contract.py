"""The port's entry() and dryrun_multichip(n), the two entry points of __graft_entry__.py.

Counterpart of the JAX package's __graft_entry__.py (which stays as it is):
entry() prepares the same DIA step, on the card by default, and
dryrun_multichip(n) runs the eight multi-device paths of parallel/ on the
same synthetic matrices with the same assertions, shard i on cuda:(i mod
the card count), or every shard on the CPU with device="cpu" (the
counterpart of the JAX package's virtual CPU devices). Neither falls back
to the CPU: without a card the default device raises. dryrun_cases and
dryrun_mesh_shape give the dryrun's matrices and meshes to callers that run
its paths otherwise (the ranks of a process group: chip_smoke.py phase 8).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def entry(device=None):
    """The DIA step (csrc/dia_spmv.cu::dia_rows_kernel over the row-group
    slab of synth.banded(2048, 2048, 8)) and its arguments: (fn, (mat, x)),
    fn(mat, x) -> y. device defaults to the card."""
    from . import coo_to_csr
    from .formats.dia import prepare_dia
    from .formats.matrix import target_device
    from .io.vectors import fill_rnd_vector
    from .ops.spmv_cuda import dia_spmv_cuda, pad_dia_for_pallas, plan_dia
    from .utils import synth

    dev = target_device("cuda" if device is None else device)
    coo = synth.banded(2048, 2048, 8, fill=0.9, seed=0)
    mat = prepare_dia(coo_to_csr(coo), dtype=torch.float32, device=dev)
    plan = plan_dia(mat)
    mat = pad_dia_for_pallas(mat, plan)
    x = torch.as_tensor(fill_rnd_vector(2048, seed=1), dtype=torch.float32, device=dev)

    def fn(mat, x):
        return dia_spmv_cuda(mat, x, plan)

    return fn, (mat, x)


def mesh_devices(n_devices: int, device=None) -> List[torch.device]:
    """n_devices shard devices: cuda:(i mod the card count), or the CPU n
    times for device="cpu"."""
    from .formats.matrix import target_device

    dev = target_device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [dev] * n_devices
    k = torch.cuda.device_count()
    return [torch.device("cuda", i % k) for i in range(n_devices)]


#: the dryrun's paths in its order, with the name its checks give each
DRYRUN_PATHS = {
    "ell_rows": "row-sharded", "csr_psum": "col-sharded psum", "ell_ring": "ring",
    "dia_halo": "dia halo", "routed_md": "multidevice routed", "window_halo": "window halo",
    "routed_spmd": "spmd routed", "dia_halo_df": "df dia halo",
}


def dryrun_cases() -> Dict[str, tuple]:
    """The dryrun's matrices and x, from their seeds: path -> (coo, csr,
    x as float64 numpy). Paths share a matrix where the dryrun does."""
    from . import coo_to_csr
    from .io.vectors import fill_rnd_vector
    from .utils import synth

    def case(coo, seed):
        return coo, coo_to_csr(coo), fill_rnd_vector(coo.shape[1], seed=seed)

    small = case(synth.power_law(96, 80, 4.0, seed=3), 4)
    band = case(synth.banded(3000, 3000, 130, fill=0.3, seed=5), 6)
    routed = case(synth.power_law(20000, 20000, 6.0, alpha=1.6, seed=7), 8)
    window = case(synth.fem_like(m=6000, n=6000, nnz=60000, spread=400, lo=4, hi=16, seed=9), 10)
    return {"ell_rows": small, "csr_psum": small, "ell_ring": small, "dia_halo": band,
            "routed_md": routed, "window_halo": window, "routed_spmd": routed,
            "dia_halo_df": band}


def dryrun_mesh_shape(path: str, n_devices: int) -> Tuple[int, int]:
    """The dryrun's mesh for a path over n_devices: the column psum on a
    (n/2, 2) grid (rows, cols), every other path on (n, 1)."""
    if path == "csr_psum":
        rows = max(n_devices // 2, 1)
        return rows, n_devices // rows
    return n_devices, 1


def dryrun_multichip(n_devices: int, device=None) -> Dict[str, np.ndarray]:
    """Run one product of each multi-device path on an n_devices mesh and
    hold it to the oracle: row-sharded ELL, the column psum, the ppermute
    ring, the DIA halo, the multi-device routed engine (on the first 4
    devices), the window halo, the SPMD routed engine and the double-float
    DIA halo, each built by bench/scaling.py::build. Returns each path's y
    (Path.result: float64 on the host)."""
    from .bench.scaling import build
    from .ops.oracle import serial_csr_spmv
    from .utils.compare import vectors_diff

    devices = mesh_devices(n_devices, device)
    ys = {}
    for path, (coo, csr, x) in dryrun_cases().items():
        if path == "routed_md":
            p = build(path, coo, csr, devices[:4])
        else:
            shape = dryrun_mesh_shape(path, n_devices)
            p = build(path, coo, csr, devices[: shape[0] * shape[1]], mesh_shape=shape)
        y = ys[path] = p.y(x)
        if path == "dia_halo_df":
            err = np.abs(y - serial_csr_spmv(csr, x)).max()
            assert err < 1e-10, f"df dia halo error {err}"
        else:
            assert vectors_diff(y, serial_csr_spmv(csr, x)).ok, f"{DRYRUN_PATHS[path]} mismatch"

    print(
        f"dryrun_multichip({n_devices}): row-sharded, psum, ring, dia-halo, "
        "multidevice-routed, window-halo, spmd-routed, df-dia-halo all OK"
    )
    return ys
