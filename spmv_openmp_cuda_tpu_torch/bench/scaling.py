"""Mesh-scaling harness: the multi-device paths' time per product against
the shard count.

Counterpart of spmv_openmp_cuda_tpu/bench/scaling.py, with its CLI, paths and
CSV header (preset,path,virtual,devices,time_s,efficiency,ok). For each shard
count d it builds the path's operands on a (d, 1) mesh (a (1, d) one for
csr_psum), checks one product against the oracle with the reference's
protocol, and times back-to-back products after warm-up: CUDA events on the
card (the median of the reps), the host clock on the CPU. efficiency =
t(1) / (d * t(d)). Shard i runs on cuda:(i mod the card count): where shards
share a card (`virtual` = 1) the times are those of several shards on one
device, not a scaling measurement.

Usage:
  python -m spmv_openmp_cuda_tpu_torch.bench.scaling --preset thermal2_like \
      --devices 1 2 4 --path window_halo
  (--virtual N: the shards on the CPU, shard counts above N skipped)
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

PATHS = ("dia_halo", "dia_halo_df", "ell_ring", "ell_rows", "csr_psum", "routed_md",
         "window_halo", "routed_spmd")

HEADER = "preset,path,virtual,devices,time_s,efficiency,ok"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def time_products(step: Callable[[], object], device: torch.device, reps: int = 5,
                  per_rep: int = 10) -> float:
    """Median over reps of the seconds per product of per_rep back-to-back
    calls of step(), after three warm-up calls: CUDA events on a card (the
    first shard's device; the products end there), the host clock on the
    CPU."""
    for _ in range(3):
        step()
    cuda = device.type == "cuda"
    ts = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_rep):
                step()
            stop.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(stop) / 1e3 / per_rep)
        else:
            t0 = time.perf_counter()
            for _ in range(per_rep):
                step()
            ts.append((time.perf_counter() - t0) / per_rep)
    return statistics.median(ts)


@dataclasses.dataclass
class Path:
    """One path's operands on its shards: place(x) puts a host x in the
    path's x form on its devices, product(xs) runs one product (what a
    caller times), result(out) is its y as a host f64 array of length m."""

    name: str
    op: object
    place: Callable
    product: Callable
    result: Callable
    devices: List[torch.device]

    def y(self, x) -> np.ndarray:
        return self.result(self.product(self.place(x)))


def build(path: str, coo, csr, devices: List[torch.device], mesh_shape=None) -> Path:
    """The operands of `path` over shards on `devices`: a (d, 1) mesh, or
    mesh_shape ((1, d) for csr_psum by default). Under a process group
    every rank calls it with its own devices, and d counts every rank's."""
    from .. import coo_to_ell
    from ..formats.dia import prepare_dia, prepare_dia_df
    from ..parallel import mesh as M
    from ..parallel import sharded as sh
    from ..parallel.routed_spmd import make_routed_spmd, prepare_routed_spmd

    m, _ = csr.shape
    dev0 = devices[0]
    f32 = torch.float32
    mesh = M.make_mesh(mesh_shape, devices=devices)
    if mesh_shape is None and path == "csr_psum":
        mesh = mesh.reshape((1, mesh.size))

    def host(y):
        return y.cpu().double().numpy().reshape(-1)[:m]

    def x32(x):
        return torch.as_tensor(np.asarray(x), dtype=f32).to(dev0)

    if path == "window_halo":
        op = sh.prepare_window_sharded(csr, mesh)
        spmv = sh.make_window_sharded(mesh, op)
        place = lambda x: sh.pad_x_for_window_sharded(x, op, mesh, f32)  # noqa: E731
    elif path == "ell_rows":
        op = sh.prepare_row_sharded_ell(coo_to_ell(coo), mesh)
        spmv, place = sh.make_ell_rows_sharded(mesh), x32
    elif path == "csr_psum":
        op = sh.prepare_col_sharded_csr(csr, mesh)
        spmv = sh.make_csr_cols_psum(mesh, m)
        place = lambda x: sh.pad_x_for_col_sharding(x, op, mesh, f32)  # noqa: E731
    elif path == "dia_halo":
        op = sh.prepare_dia_sharded(prepare_dia(csr, max_fill_ratio=1e9, device="cpu"), mesh)
        spmv = sh.make_dia_sharded(mesh, op)
        place = lambda x: sh.pad_x_for_dia_sharded(x, op, mesh, f32)  # noqa: E731
    elif path == "dia_halo_df":
        op = sh.prepare_dia_sharded_df(prepare_dia_df(csr, max_fill_ratio=1e9, device="cpu"), mesh)
        spmv2 = sh.make_dia_sharded_df(mesh, op)
        # the df product consumes both x planes and returns both y planes
        return Path(path, op, lambda x: sh.pad_x_for_dia_sharded_df(x, op, mesh),
                    lambda xs: spmv2(op, *xs), lambda out: host(out[0].double() + out[1].double()),
                    devices)
    elif path == "routed_spmd":
        op = prepare_routed_spmd(csr, mesh)
        spmv, place = make_routed_spmd(mesh, op), x32
    elif path == "routed_md":
        op = sh.prepare_routed_multidevice(csr, devices=devices)
        return Path(path, op, x32, lambda xs: sh.routed_multidevice_spmv(op, xs), host, devices)
    elif path == "ell_ring":
        op = sh.prepare_ring_ell(csr, mesh)
        spmv = sh.make_ell_ring(mesh, op)
        place = lambda x: sh.pad_x_for_ring(x, op, mesh, f32)  # noqa: E731
    else:
        raise ValueError(f"unknown path {path}")
    return Path(path, op, place, lambda xs: spmv(op, xs), host, devices)


def measure(preset: str, device_counts: List[int], path: str, device=None, coo=None,
            max_shards: Optional[int] = None,
            built: Optional[dict] = None) -> List[Tuple[int, int, float, float, bool]]:
    """[(d, virtual, seconds per product, efficiency, ok)] per shard count.
    coo: the matrix (default synth.preset(preset)); device: cuda (the
    default; no card raises) or cpu; shard counts above max_shards are
    skipped; built, a dict, receives each shard count's Path."""
    from .. import coo_to_csr
    from ..contract import mesh_devices
    from ..formats.matrix import target_device
    from ..io.vectors import fill_rnd_vector
    from ..ops.oracle import serial_csr_spmv
    from ..utils import synth
    from ..utils.compare import vectors_diff

    target_device("cuda" if device is None else device)  # no card raises before the matrix is made
    if coo is None:
        coo = synth.preset(preset)
    csr = coo_to_csr(coo)
    x = fill_rnd_vector(csr.shape[1], seed=1)
    oracle = serial_csr_spmv(csr, x)
    rows = []
    t1 = None
    for d in device_counts:
        if max_shards is not None and d > max_shards:
            log(f"d={d}: only {max_shards} virtual devices, skipping")
            continue
        devices = mesh_devices(d, device)
        virtual = int(devices[0].type == "cpu" or len(set(devices)) < d)
        p = build(path, coo, csr, devices)
        if built is not None:
            built[d] = p
        rep = vectors_diff(p.y(x), oracle)
        xs = p.place(x)
        t = time_products(lambda: p.product(xs), devices[0])
        if t1 is None:
            t1 = t
        eff = t1 / (d * t)
        rows.append((d, virtual, t, eff, rep.ok))
        log(f"#scaling preset={preset} path={path} d={d} on {devices[0]}"
            f"{' (virtual: shards share a device)' if virtual else ''}: {t * 1e6:10.1f} us/product "
            f"efficiency={eff:5.2f} check={'OK' if rep.ok else 'FAIL'}")
    return rows


def run_scaling(preset: str, device_counts: List[int], path: str, device=None, coo=None,
                max_shards: Optional[int] = None) -> int:
    """measure, then the CSV on stdout; 0 if every check passed."""
    rows = measure(preset, device_counts, path, device, coo, max_shards)
    print(HEADER + "".join(f"\n{preset},{path},{v},{d},{t:.3e},{e:.3f},{int(ok)}"
                           for d, v, t, e, ok in rows))
    return 0 if all(ok for *_, ok in rows) else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="fem_3d_thermal2_like")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--path", choices=PATHS, default="dia_halo")
    ap.add_argument("--virtual", type=int, default=0, metavar="N",
                    help="run the shards on the CPU, at most N of them (the JAX package's N "
                    "virtual CPU devices); without it the shards run on the cards (no card "
                    "exits 1)")
    args = ap.parse_args(argv)
    device, cap = ("cpu", args.virtual) if args.virtual else ("cuda", None)
    try:
        return run_scaling(args.preset, args.devices, args.path, device, max_shards=cap)
    except RuntimeError as e:
        if "is_available" not in str(e):
            raise
        log(f"scaling: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
