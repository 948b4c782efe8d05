#!/usr/bin/env python3
"""Where the time of the port's CUDA window kernel goes, on one GPU.

Run from the root of the repository: python3 scripts/torch_window_probe.py

It builds spmv_openmp_cuda_tpu_torch/csrc/window_spmv.cu (with
csrc/window_tile.cuh inlined) as it is and in probe variants, each made by a
text substitution in a build copy that takes away or changes one part of
the work (the x window's staging, the slot rows, the overflow rows, the
depth of the cp.async ring), and times window_spmv on the window proxies per call with CUDA
events and in a CUDA graph, variant by variant in turns (as_is first and
last, to show the spread). A variant that computes something else is a
probe only: its y is not checked. Needs nvcc and a CUDA device; prints one
line per (proxy, variant) and a JSON summary last.
"""
import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: variant -> substitutions (old, new) in csrc/window_spmv.cu + window_tile.cuh
VARIANTS = {
    "as_is": [],
    "no_x_stage": [("stage_x(xs, a.x, a.x_lo, a.n_x, x_base * kLane, a.win_rows * kLane, bar);",
                    "__syncthreads();")],
    "no_slot_rows": [("      slot_row<T>(", "      if (false) slot_row<T>("),
                     ("      overflow_lane<T>(", "      if (false) overflow_lane<T>(")],
    "no_overflow": [("      overflow_lane<T>(", "      if (false) overflow_lane<T>(")],
    # a shallower ring inside the plan's (deeper) allocation
    "depth_4": [("constexpr int kDepth = 8;", "constexpr int kDepth = 4;"),
                ("depth != kDepth", "false")],
    "depth_2": [("constexpr int kDepth = 8;", "constexpr int kDepth = 2;"),
                ("depth != kDepth", "false")],
    # every copy through L1 (cp.async.ca), the 16-byte ones too
    "ca_16": [("  if (kBytes == 16)\n", "  if (false)\n")],
}


def build_variant(src: str, subs, out_dir: str, name: str, nvcc: str, flags) -> str:
    from spmv_openmp_cuda_tpu_torch.ops import cuda_lib

    header = (cuda_lib.SRC_DIR / "window_tile.cuh").read_text()
    src = src.replace('#include "window_tile.cuh"', header)
    for old, new in subs:
        if old not in src:
            raise ValueError(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    cu = os.path.join(out_dir, f"{name}.cu")
    so = os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([nvcc, *flags, "-o", so, cu], check=True, capture_output=True, text=True)
    return so


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device ms per call: reps calls captured in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * reps)


def profile_calls(fn, calls: int) -> dict:
    """torch.profiler over `calls` back-to-back calls after warm-up: device
    microseconds per call by kernel name, their sum, and the host wall time
    per call (device busy share = sum / wall)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0)
        if dt and ev.device_type == torch.autograd.DeviceType.CUDA:
            per[ev.key[:60]] = dt / calls
    dev_us = sum(per.values())
    return {"device_us_per_call": dev_us, "wall_us_per_call": wall / calls * 1e6,
            "busy_share": dev_us / (wall / calls * 1e6), "by_kernel_us": per}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--proxies", default="thermal2_like,fem_3d_thermal2_like,delaunay_n12_like")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_window_probe: no CUDA device", file=sys.stderr)
        return 1
    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.cli import time_per_call
    from spmv_openmp_cuda_tpu_torch.ops import cuda_lib, registry
    from spmv_openmp_cuda_tpu_torch.ops import window_cuda as WC
    from spmv_openmp_cuda_tpu_torch.utils import synth

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    names = [v for v in args.variants.split(",") if v]
    src = (cuda_lib.SRC_DIR / "window_spmv.cu").read_text()
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    libs = {}
    with tempfile.TemporaryDirectory() as tmp, concurrent.futures.ThreadPoolExecutor() as pool:
        uniq = list(dict.fromkeys(names))
        paths = pool.map(lambda n: build_variant(src, VARIANTS[n], tmp, n, cuda_lib.nvcc_path(),
                                                 flags), uniq)
        for name, path in zip(uniq, paths):
            lib = ctypes.CDLL(path)
            WC._bind(lib)
            libs[name] = lib
    order = names + ([names[0]] if len(names) > 1 else [])
    dev = torch.device("cuda")
    out = {}
    for proxy in args.proxies.split(","):
        csr = P.coo_to_csr(synth.preset(proxy))
        mat = registry.get("PL_CSR_WINDOW").prepare(csr, None, P.Config(), dev)
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(csr.shape[1]),
                            dtype=torch.float32, device=dev)
        slots = mat.nblocks * mat.k_pad * 128
        for turn, name in enumerate(order):
            cuda_lib._LIBS["window_spmv"] = libs[name]
            ms = time_per_call(lambda v: WC.window_spmv(mat, v), x) * 1e3
            gms = graph_ms(lambda: WC.window_spmv(mat, x))
            out.setdefault(proxy, {}).setdefault(name, []).append([ms, gms])
            print(f"{proxy:20s} g={mat.g} k_pad={mat.k_pad} nblocks={mat.nblocks} "
                  f"turn {turn}: {name:20s} {ms:.4f} ms per call, {gms:.4f} ms graphed "
                  f"({slots / gms / 1e6:.1f} G slots/s)", flush=True)
        # device time by kernel name over 200 back-to-back calls of as_is
        cuda_lib._LIBS["window_spmv"] = libs[names[0]]
        busy = profile_calls(lambda: WC.window_spmv(mat, x), 200)
        out[proxy]["profile"] = busy
        print(f"{proxy:20s} profile of {names[0]}: {busy}", flush=True)
    print(json.dumps({"device": smi, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
