#!/usr/bin/env python3
"""A/B of two checkouts of the PyTorch/CUDA port on one GPU: the window
kernels (PL_CSR_WINDOW, PL_CSR_WINDOW_BF16 and PL_CSR_WINDOW_F64 on
thermal2_like, fem_3d_thermal2_like and delaunay_n12_like), the dense
heavy-row kernel D and the W-stage kernel B (caida_like's chain), the
PL_CSR_ROUTED product on caida_like and on three small domains
(delaunay_n12_like, west2021_like, a 9000-row random matrix: the small
kernel), and the PL_CSR_LANES product (lanes_kernel) on delaunay_n12_like,
raefsky1_like, cavity10_like and west2021_like, each per call through its
wrapper and in a CUDA graph, whether a rerun on the same x is bitwise equal,
and, for the window and lanes products, the share of the bound: the bytes
the product must move (the layout's arrays and x read once, y written once)
over 3.35 TB/s, against the graphed time. The F64 operands are the f32 layout with a
zero lo plane (the df layout's shape and bytes, without a second prepare).

    python3 scripts/torch_close_ab.py PARENT_DIR CHANGE_DIR

runs each checkout in a process of its own (its package on the path, its
kernels built from its csrc/) in the order parent, change, change, parent,
and prints each run's numbers and the mean of the two runs of each tree.
`--one DIR` runs one checkout and prints one JSON line. Needs a CUDA device.
"""
import json
import os
import subprocess
import sys
import time

PROXIES = ("thermal2_like", "fem_3d_thermal2_like", "delaunay_n12_like")
LANES_PROXIES = ("delaunay_n12_like", "raefsky1_like", "cavity10_like", "west2021_like")
MODES = ("PL_CSR_WINDOW", "PL_CSR_WINDOW_BF16", "PL_CSR_WINDOW_F64")  # all run by window_spmv
#: H100 SXM data sheet: the HBM rate
HBM_BYTES_PER_S = 3.35e12


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


def one(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import dataclasses

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.ops import registry
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.utils import synth
    from spmv_openmp_cuda_tpu_torch.utils.profiling import time_per_call

    assert P.__file__.startswith(os.path.abspath(tree)), P.__file__
    dev = torch.device("cuda")
    out = {}
    for name in PROXIES:
        csr = P.coo_to_csr(synth.preset(name))
        xn = np.random.default_rng(4).standard_normal(csr.shape[1])
        spec = registry.get("PL_CSR_WINDOW")
        mat = spec.prepare(csr, None, P.Config(), dev)
        for mode in MODES:
            # the bf16 layout is the f32 one with vals cast, as prepare makes it
            ops = {"PL_CSR_WINDOW": mat,
                   "PL_CSR_WINDOW_BF16": dataclasses.replace(mat, vals=mat.vals.to(torch.bfloat16)),
                   "PL_CSR_WINDOW_F64": dataclasses.replace(mat, vals_lo=torch.zeros_like(mat.vals)),
                   }[mode]
            df = mode == "PL_CSR_WINDOW_F64"
            x = torch.as_tensor(xn, dtype=torch.float64 if df else torch.float32, device=dev)
            fn = registry.get(mode).jitted(ops)
            a, b = fn(x), fn(x)
            torch.cuda.synchronize()
            moved = sum(t.numel() * t.element_size() for t in (ops.vals, ops.vals_lo, ops.sidx,
                                                                ops.gid, ops.rsrc) if t is not None)
            moved += x.element_size() * sum(csr.shape)
            tg = graph_ms(lambda: fn(x))
            out[f"{name} {mode}"] = {"ms": time_per_call(fn, x) * 1e3, "graph_ms": tg,
                                     "rerun_equal": bool(torch.equal(a, b)),
                                     "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                                     "bound_share": moved / HBM_BYTES_PER_S * 1e3 / tg}
    csr = P.coo_to_csr(synth.preset("caida_like"))
    mat = RC.prepare_routed_chain(csr, device=dev).mat
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(csr.shape[1]),
                        dtype=torch.float32, device=dev)
    n_h = mat.hdense.shape[0]
    target = torch.arange(n_h, dtype=torch.int32, device=dev)
    y = torch.zeros(-(-n_h // 128) * 128, device=dev)

    def d(v):  # kernel D alone: y[target[k]] += H[k] . x
        return RC.routed_hdense_cuda(mat.hdense, v, target, y)

    a = d(x).clone()
    y.zero_()
    b = d(x).clone()
    torch.cuda.synchronize()
    out[f"caida_like kernel D {tuple(mat.hdense.shape)}"] = {
        "ms": time_per_call(d, x) * 1e3, "graph_ms": graph_ms(lambda: d(x)),
        "rerun_equal": bool(torch.equal(a, b))}
    # kernel B: each W stage of caida_like's chain alone, on valid inputs
    chain = RC.build_chain(mat)
    bufs = RC._buffers(chain, x)
    for st in chain.stages:
        RC.run_stage(st, bufs, plain=True)
    w_stages = [st for st in chain.stages if isinstance(st, RC.WStage)]
    out[f"caida_like kernel B ({len(w_stages)} W stages)"] = {
        "ms": sum(time_per_call(lambda v, st=st: RC.run_stage(st, bufs, plain=False), x)
                  for st in w_stages) * 1e3,
        "graph_ms": sum(graph_ms(lambda st=st: RC.run_stage(st, bufs, plain=False))
                        for st in w_stages),
        "rerun_equal": None}  # data movement: not a sum
    # whole routed products (small domains: the staged chain in a parent
    # without the small kernel)
    for name, coo in (("caida_like", None), ("delaunay_n12_like", synth.preset("delaunay_n12_like")),
                      ("west2021_like", synth.preset("west2021_like")),
                      ("random_uniform 9000", synth.random_uniform(9000, 9000, density=5e-4, seed=7))):
        c = chain if coo is None else RC.prepare_routed_chain(P.coo_to_csr(coo), device=dev)
        xc = x if coo is None else torch.as_tensor(
            np.random.default_rng(4).standard_normal(c.shape[1]), dtype=torch.float32, device=dev)
        a, b = RC.routed_chain_spmv(c, xc), RC.routed_chain_spmv(c, xc)
        torch.cuda.synchronize()
        out[f"{name} PL_CSR_ROUTED product"] = {
            "ms": time_per_call(lambda v, c=c: RC.routed_chain_spmv(c, v), xc) * 1e3,
            "graph_ms": graph_ms(lambda c=c, xc=xc: RC.routed_chain_spmv(c, xc)),
            "rerun_equal": bool(torch.equal(a, b))}
    # lane-gather products (PL_CSR_LANES)
    spec = registry.get("PL_CSR_LANES")
    for name in LANES_PROXIES:
        csr = P.coo_to_csr(synth.preset(name))
        ops = spec.prepare(csr, None, P.Config(), dev)
        fn = spec.jitted(ops)
        xl = torch.as_tensor(np.random.default_rng(4).standard_normal(csr.shape[1]),
                             dtype=torch.float32, device=dev)
        a, b = fn(xl), fn(xl)
        torch.cuda.synchronize()
        moved = sum(t.numel() * t.element_size() for t in (ops.vals, ops.pidx, ops.gid,
                                                            ops.tile_win))
        moved += 4 * sum(csr.shape)
        tg = graph_ms(lambda: fn(xl))
        out[f"{name} PL_CSR_LANES product"] = {
            "ms": time_per_call(fn, xl) * 1e3, "graph_ms": tg, "rerun_equal": bool(torch.equal(a, b)),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            "bound_share": moved / HBM_BYTES_PER_S * 1e3 / tg}
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    parent, change = argv
    runs = {parent: [], change: []}
    for tree in (parent, change, change, parent):
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[tree].append(res)
        print(f"{tree} ({time.perf_counter() - t:.0f}s): {json.dumps(res)}", flush=True)
    print(f"mean of two runs per tree, on {smi} (ms per call through the wrapper | ms in a CUDA "
          "graph | rerun bitwise equal | graphed share of the bound):")
    for key in runs[parent][0]:
        cells = []
        for tree in (parent, change):
            r = [run[key] for run in runs[tree] if key in run]
            eq = [v["rerun_equal"] for v in r]
            share = [v["bound_share"] for v in r if "bound_share" in v]
            cells.append(f"{sum(v['ms'] for v in r) / len(r):.4f} | "
                         f"{sum(v['graph_ms'] for v in r) / len(r):.4f} | "
                         f"{'-' if None in eq else all(eq)} | "
                         f"{f'{100 * sum(share) / len(share):.1f} %' if share else '-'}")
        bound = runs[change][0][key].get("bound_ms")
        print(f"  {key:46s} parent {cells[0]}   change {cells[1]}"
              + (f"   (bound {bound:.4f} ms)" if bound else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
