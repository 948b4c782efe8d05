#!/usr/bin/env python3
"""Host prepare time of AutoSpMV per proxy, with the native host library
(io/native.py) and with the numpy paths (the library not loaded), in one
process.

Run from the root of the repository on a machine with a GPU:

    python3 scripts/torch_prepare_probe.py [--proxies a,b] [--f64 a,b]

For each proxy (float32 by default; --f64 names the proxies also prepared
in float64) it times AutoSpMV.from_csr(csr, device="cuda") natively, then
on the numpy path, and holds the two models' y on x ~ N(0, 1) torch.equal
(the same layout, or a coloring that differs would show here). Prints a
line per prepare and, last, one JSON object with the seconds.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROXIES = ("fem_3d_thermal2_like", "thermal2_like", "webbase_like", "caida_like", "sg_rand_like",
           "delaunay_n12_like")
F64 = ("webbase_like", "caida_like")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--proxies", default=",".join(PROXIES))
    ap.add_argument("--f64", default=",".join(F64))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_prepare_probe: no CUDA device", file=sys.stderr)
        return 1
    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.io import native
    from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV
    from spmv_openmp_cuda_tpu_torch.utils import synth

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; cpus: {os.cpu_count()}")
    t = time.perf_counter()
    if not native.available():
        print(f"the native library is not available: {native.failure()}", file=sys.stderr)
        return 1
    print(f"native library {native.library_path()} built and loaded in {time.perf_counter() - t:.1f}s")
    f64 = set(filter(None, args.f64.split(",")))
    out = {}
    for name in filter(None, args.proxies.split(",")):
        t = time.perf_counter()
        csr = P.coo_to_csr(synth.preset(name))
        print(f"{name}: {csr.shape[0]} rows, {csr.nnz} nnz, generated in {time.perf_counter() - t:.1f}s",
              flush=True)
        x = np.random.default_rng(1).standard_normal(csr.shape[1])
        for dtype in ("float32", "float64") if name in f64 else ("float32",):
            secs, ys = {}, {}
            for path in ("native", "numpy"):
                # the numpy paths: the library not loaded
                off = mock.patch.object(native, "load_library", lambda: None)
                with off if path == "numpy" else contextlib.nullcontext():
                    t = time.perf_counter()
                    model = AutoSpMV.from_csr(csr, cfg=P.Config(dtype=dtype), device="cuda")
                    torch.cuda.synchronize()
                    secs[path] = time.perf_counter() - t
                ys[path] = model(x)
                fmt = model.format
                del model
            equal = torch.equal(ys["native"], ys["numpy"])
            print(f"  {dtype} AUTO -> {fmt}: prepare+upload native {secs['native']:.2f}s, numpy "
                  f"{secs['numpy']:.2f}s ({secs['numpy'] / secs['native']:.2f}x); y torch.equal: "
                  f"{equal}", flush=True)
            out[f"{name} {dtype}"] = {"format": fmt, **secs, "y_equal": equal}
            torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "prepare_s": out}))
    return 0 if all(v["y_equal"] for v in out.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
