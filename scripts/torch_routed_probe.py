#!/usr/bin/env python3
"""Probe of the routed reduce kernel C on one GPU: variants of
spmv_openmp_cuda_tpu_torch/csrc/routed_spmv.cu, built by text substitution
in a build copy, each timed alone in a CUDA graph on the C stages of
caida_like's and webbase_like's chains (valid inputs from the plain chain)
and on the whole product, with C's groups packed into chunks of 0 (one
group per CTA) or routed_cuda._CHUNK_ROWS rows; every variant's sums must
be bitwise those of the source as it is (the same adds in the same order).

    python3 scripts/torch_routed_probe.py

Variants: the source as it is (a one-warp CTA per chunk and band of 32
lanes, batches of 16 rows); "cta128" (a CTA of 128 lanes per chunk: one
SM holds a wide group's four bands); "batch8" and "batch32" (rows whose
loads a thread issues together); "ldcg" (value reads cached in L2 only).
Prints the card's name and power limit, then one line per stage and
chunk setting. Needs a CUDA device.
"""
import concurrent.futures
import ctypes
import dataclasses
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

#: variant -> substitutions (old, new) in csrc/routed_spmv.cu
VARIANTS = {
    "as is": [],
    "cta128": [
        ("template <bool kMask>\n__global__ void __launch_bounds__(kBand)",
         "template <bool kMask>\n__global__ void __launch_bounds__(kLane)"),
        ("  constexpr int kBands = kLane / kBand;\n  __shared__ int ends",
         "  constexpr int kBands = 1;\n  __shared__ int ends"),
        ("j < ch.w - ch.z; j += kBand)", "j < ch.w - ch.z; j += kLane)"),
        ("const unsigned grid = (unsigned)n_chunks * (kLane / kBand);",
         "const unsigned grid = (unsigned)n_chunks;"),
        ("<true><<<grid, kBand, 0, st>>>", "<true><<<grid, kLane, 0, st>>>"),
        ("<false><<<grid, kBand, 0, st>>>", "<false><<<grid, kLane, 0, st>>>"),
    ],
    "batch8": [("constexpr int kReduceBatch = 16;", "constexpr int kReduceBatch = 8;")],
    "batch32": [("constexpr int kReduceBatch = 16;", "constexpr int kReduceBatch = 32;")],
    "ldcg": [("v[u] = o[u] >= 0 ? __ldg(src + o[u]) : 0.f;\n      if (kMask)",
              "v[u] = o[u] >= 0 ? __ldcg(src + o[u]) : 0.f;\n      if (kMask)")],
}
PROXIES = ("caida_like", "webbase_like")


def build_variant(src: str, subs, out_dir: str, name: str, nvcc: str, flags) -> str:
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    path = os.path.join(out_dir, f"{name.replace(' ', '_')}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = path[:-3] + ".so"
    proc = subprocess.run([nvcc, *flags, "-o", lib, path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name} does not build:\n{proc.stdout}{proc.stderr}")
    return lib


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device ms per call: reps calls captured in one CUDA graph, replayed."""
    import torch

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


def main() -> int:
    import numpy as np
    import torch

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.ops import cuda_lib
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.utils import synth

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    src = (cuda_lib.SRC_DIR / "routed_spmv.cu").read_text()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
            futures = {name: pool.submit(build_variant, src, subs, tmp, name, cuda_lib.nvcc_path(),
                                         cuda_lib.NVCC_FLAGS) for name, subs in VARIANTS.items()}
            libs = {name: f.result() for name, f in futures.items()}

        def use(name):
            lib = ctypes.CDLL(libs[name])
            RC._bind(lib)
            cuda_lib._LIBS["routed_spmv"] = lib

        for proxy in PROXIES:
            use("as is")
            csr = P.coo_to_csr(synth.preset(proxy))
            chain = RC.prepare_routed_chain(csr, device=dev)
            x = torch.as_tensor(np.random.default_rng(4).standard_normal(csr.shape[1]),
                                dtype=torch.float32, device=dev)
            bufs = RC._buffers(chain, x)
            for st in chain.stages:
                RC.run_stage(st, bufs, plain=True)
            level = 0
            for st in chain.stages:
                if not isinstance(st, RC.ReduceStage):
                    continue
                ref = None
                for rows in (0, RC._CHUNK_ROWS):
                    saved, RC._CHUNK_ROWS = RC._CHUNK_ROWS, rows
                    try:
                        v = dataclasses.replace(st, chunks=RC.reduce_chunks(st.runs, dev))
                    finally:
                        RC._CHUNK_ROWS = saved
                    cells = []
                    for name in VARIANTS:
                        use(name)
                        us = min(graph_ms(lambda s=v: RC.run_stage(s, bufs, plain=False))
                                 for _ in range(3)) * 1e3
                        out = RC._view(bufs, st.out, st.out_elems()).clone()
                        ref = out if ref is None else ref
                        if not torch.equal(out, ref):
                            raise AssertionError(f"{proxy} C level {level} {name}: other sums")
                        cells.append(f"{name} {us:6.2f}")
                    print(f"  {proxy} C level {level}, chunks of {rows:2d} rows "
                          f"({v.chunks.shape[0]} chunks), us in a graph: " + " | ".join(cells),
                          flush=True)
                level += 1
            cells = []
            for name in VARIANTS:
                use(name)
                cells.append(f"{name} "
                             f"{graph_ms(lambda: RC.routed_chain_spmv(chain, x), reps=10) * 1e3:6.2f}")
            print(f"  {proxy} product, us in a graph: " + " | ".join(cells), flush=True)
            del chain, bufs
    return 0


if __name__ == "__main__":
    sys.exit(main())
