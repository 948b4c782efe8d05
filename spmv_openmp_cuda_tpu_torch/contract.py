"""The port's entry() and dryrun_multichip(n), the two entry points of __graft_entry__.py.

Counterpart of the JAX package's __graft_entry__.py (which stays as it is):
entry() prepares the same DIA step, on the card by default, and
dryrun_multichip(n) runs the eight multi-device paths of parallel/ on the
same synthetic matrices with the same assertions, shard i on cuda:(i mod
the card count), or every shard on the CPU with device="cpu" (the
counterpart of the JAX package's virtual CPU devices). Neither falls back
to the CPU: without a card the default device raises.
"""
from __future__ import annotations

from typing import List

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


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run one product of each multi-device path on an n_devices mesh and
    hold it to the oracle: row-sharded ELL, the column psum, the ppermute
    ring, the DIA halo, the multi-device routed engine, the window halo, the
    SPMD routed engine and the double-float DIA halo."""
    from . import coo_to_csr, coo_to_ell
    from .formats.dia import prepare_dia, prepare_dia_df
    from .io.vectors import fill_rnd_vector
    from .ops.oracle import serial_csr_spmv
    from .parallel import mesh as M
    from .parallel import sharded as sh
    from .parallel.routed_spmd import make_routed_spmd, prepare_routed_spmd
    from .utils import synth
    from .utils.compare import vectors_diff

    devices = mesh_devices(n_devices, device)

    def host(y) -> np.ndarray:
        return y.cpu().numpy().astype(np.float64)

    coo = synth.power_law(96, 80, 4.0, seed=3)
    csr = coo_to_csr(coo)
    ell = coo_to_ell(coo)
    x = fill_rnd_vector(coo.shape[1], seed=4)
    oracle = serial_csr_spmv(csr, x)
    xt = torch.as_tensor(x, dtype=torch.float32)

    # 1) row-sharded DP over all devices
    mesh = M.make_mesh((n_devices, 1), devices=devices)
    op = sh.prepare_row_sharded_ell(ell, mesh)
    y = host(sh.make_ell_rows_sharded(mesh)(op, xt.to(devices[0])))[: op.m]
    assert vectors_diff(y, oracle).ok, "row-sharded mismatch"

    # 2) 2D mesh: contraction-axis sharding with psum of partials
    rows = max(n_devices // 2, 1)
    cols = n_devices // rows
    mesh2 = M.make_mesh((rows, cols), devices=devices[: rows * cols])
    op2 = sh.prepare_col_sharded_csr(csr, mesh2)
    xj = sh.pad_x_for_col_sharding(x, op2, mesh2, torch.float32)
    y2 = host(sh.make_csr_cols_psum(mesh2, csr.shape[0])(op2, xj))
    assert vectors_diff(y2, oracle).ok, "col-sharded psum mismatch"

    # 3) fully sharded ppermute ring (x sharded)
    op3 = sh.prepare_ring_ell(csr, mesh)
    xr = sh.pad_x_for_ring(x, op3, mesh, torch.float32)
    y3 = host(sh.make_ell_ring(mesh, op3)(op3, xr))[: op3.m]
    assert vectors_diff(y3, oracle).ok, "ring mismatch"

    # 4) row-sharded DIA with halo exchange (banded flagship)
    coo_b = synth.banded(3000, 3000, 130, fill=0.3, seed=5)
    csr_b = coo_to_csr(coo_b)
    dmat = prepare_dia(csr_b, max_fill_ratio=1e9, device="cpu")
    xb = fill_rnd_vector(3000, seed=6)
    op4 = sh.prepare_dia_sharded(dmat, mesh)
    xs = sh.pad_x_for_dia_sharded(xb, op4, mesh, torch.float32)
    y4 = host(sh.make_dia_sharded(mesh, op4)(op4, xs)).reshape(-1)[: csr_b.shape[0]]
    assert vectors_diff(y4, serial_csr_spmv(csr_b, xb)).ok, "dia halo mismatch"

    # 5) heterogeneous row-block routed engines on separate devices
    coo_r = synth.power_law(20000, 20000, 6.0, alpha=1.6, seed=7)
    csr_r = coo_to_csr(coo_r)
    op5 = sh.prepare_routed_multidevice(csr_r, devices=devices[:4])
    xr5 = fill_rnd_vector(csr_r.shape[1], seed=8)
    y5 = host(sh.routed_multidevice_spmv(op5, np.asarray(xr5, np.float32)))
    assert vectors_diff(y5, serial_csr_spmv(csr_r, xr5)).ok, "multidevice routed mismatch"

    # 6) row-sharded windowed local-gather engine with halo exchange
    coo_w = synth.fem_like(m=6000, n=6000, nnz=60000, spread=400, lo=4, hi=16, seed=9)
    csr_w = coo_to_csr(coo_w)
    xw = fill_rnd_vector(6000, seed=10)
    op6 = sh.prepare_window_sharded(csr_w, mesh)
    xws = sh.pad_x_for_window_sharded(xw, op6, mesh, torch.float32)
    y6 = host(sh.make_window_sharded(mesh, op6)(op6, xws))
    assert vectors_diff(y6, serial_csr_spmv(csr_w, xw)).ok, "window halo mismatch"

    # 7) the SPMD routed engine: schema'd chunks, one per shard
    op7 = prepare_routed_spmd(csr_r, mesh)
    y7 = host(make_routed_spmd(mesh, op7)(op7, torch.as_tensor(xr5, dtype=torch.float32)))
    assert vectors_diff(y7, serial_csr_spmv(csr_r, xr5)).ok, "spmd routed mismatch"

    # 8) double-float DIA halo: (hi, lo) slab pairs, both x planes exchanged
    dmat8 = prepare_dia_df(csr_b, max_fill_ratio=1e9)
    op8 = sh.prepare_dia_sharded_df(dmat8, mesh)
    xh8, xl8 = sh.pad_x_for_dia_sharded_df(xb, op8, mesh)
    yh8, yl8 = sh.make_dia_sharded_df(mesh, op8)(op8, xh8, xl8)
    y8 = (yh8.cpu().double() + yl8.cpu().double()).numpy().reshape(-1)[: csr_b.shape[0]]
    err8 = np.abs(y8 - serial_csr_spmv(csr_b, xb)).max()
    assert err8 < 1e-10, f"df dia halo error {err8}"

    print(
        f"dryrun_multichip({n_devices}): row-sharded, psum, ring, dia-halo, "
        "multidevice-routed, window-halo, spmd-routed, df-dia-halo all OK"
    )
