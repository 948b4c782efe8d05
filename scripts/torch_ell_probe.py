#!/usr/bin/env python3
"""Probe of the transposed-ELL kernel's layouts on one GPU: variants of
spmv_openmp_cuda_tpu_torch/csrc/ell_spmv.cu, built by text substitution in
a build copy, each timed per call and in a CUDA graph on sg_like and
thermal2_like (PL_ELL_ROWS_T, their published sizes); every variant's y
must be bitwise the source's (the same terms added in the same order) and
equal (torch.equal) to the full-width walk (ops/ell_cuda.py::ell_t_in_order
without a walk table).

    python3 scripts/torch_ell_probe.py [--proxies sg_like,thermal2_like]

Variants: "as is" (a thread per four rows, 16-byte loads of data and cols,
each thread walking to the longest of its four rows); "full" (the same
kernel given a table of W_pad: every slot of the slab, as the kernel before
the walk table); "quad128" (the same threads, each warp walking to the
longest of its 128 rows); "rows32" and "rows1" (a thread per row, 4-byte
loads, each warp walking to the longest of its 32 rows, or each thread to
its own row's end). Prints, per proxy, the bytes each walk reads (values
and columns of the slots walked, at the table's rows per entry) beside the
nonzero slots' and the whole slab's, and cuSPARSE (torch.sparse CSR f32)
per call and graphed.
Prints the card's name and power limit first. Needs a CUDA device.
"""
import concurrent.futures
import ctypes
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

#: layout (a): a thread per row, 4-byte loads of data and cols
ROW_KERNEL = """__global__ void __launch_bounds__(kThreads)
ell_t_kernel(const float* __restrict__ data, const int* __restrict__ cols,
             const int* __restrict__ walk, long long m_pad, long long m,
             const float* __restrict__ x, long long n_x, float* __restrict__ y) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= m) return;
  const int len = __ldg(walk + r / kGroupRows);
  const float* dr = data + r;
  const int* cr = cols + r;
  float d[kBatch];
  int c[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    d[u] = u < len ? __ldg(dr + (long long)u * m_pad) : 0.f;
    c[u] = u < len ? __ldg(cr + (long long)u * m_pad) : -1;
  }
  float acc = 0.f;
  for (int w0 = 0; w0 < len; w0 += kBatch) {
    float xv[kBatch], dv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      xv[u] = x_at(x, c[u], n_x);
      dv[u] = d[u];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int w = w0 + kBatch + u;
      d[u] = w < len ? __ldg(dr + (long long)w * m_pad) : 0.f;
      c[u] = w < len ? __ldg(cr + (long long)w * m_pad) : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (w0 + u < len) acc = __fmaf_rn(dv[u], xv[u], acc);
  }
  y[r] = acc;
}

}  // namespace"""


def _consts(rows: int, group: int, batch: int):
    """Substitutions of the source's rows per thread, walk-table group and
    batch."""
    return [(r"constexpr int kRowsPerThread = \d+;", f"constexpr int kRowsPerThread = {rows};"),
            (r"constexpr int kGroupRows = \d+;", f"constexpr int kGroupRows = {group};"),
            (r"constexpr int kBatch = \d+;", f"constexpr int kBatch = {batch};")]


#: variant -> (substitutions in csrc/ell_spmv.cu: (regex, text), or (None,
#: a whole kernel); rows per walk-table entry, None: W_pad for every row)
VARIANTS = {
    "as is": ([], "source"),
    "full": ([], None),
    "quad128": (_consts(4, 128, 4), 128),
    "rows32": (_consts(1, 32, 8) + [(None, ROW_KERNEL)], 32),
    "rows1": (_consts(1, 1, 8) + [(None, ROW_KERNEL)], 1),
}
PROXIES = ("sg_like", "thermal2_like")


def build_variant(src: str, subs, out_dir: str, name: str, nvcc: str, flags) -> str:
    for old, new in subs:
        if old is None:  # the whole kernel, up to the end of its namespace
            head = src.index("__global__ void __launch_bounds__(kThreads)\nell_t_kernel(")
            src = src[:head] + new + src[src.index("}  // namespace", head) + len("}  // namespace"):]
            continue
        src, n = re.subn(old, new, src)
        if n != 1:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
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


def walked_bytes(mat, walk, group: int) -> int:
    """Bytes of values and columns in the slots the warps walk: each group
    of rows below m to its table entry."""
    import torch

    m = mat.shape[0]
    rows = torch.full((-(-m // group),), group, device=walk.device)
    rows[-1] = m - group * (rows.numel() - 1)
    return 8 * int((walk.long() * rows).sum())


def main() -> int:
    import argparse

    import numpy as np
    import torch

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.formats.matrix import device_ell
    from spmv_openmp_cuda_tpu_torch.ops import cuda_lib
    from spmv_openmp_cuda_tpu_torch.ops import ell_cuda as EC
    from spmv_openmp_cuda_tpu_torch.utils import synth
    from spmv_openmp_cuda_tpu_torch.utils.profiling import time_per_call

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--proxies", default=",".join(PROXIES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    src = (cuda_lib.SRC_DIR / "ell_spmv.cu").read_text()
    dev = torch.device("cuda", torch.cuda.current_device())
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
            futures = {name: pool.submit(build_variant, src, subs, tmp, name,
                                         cuda_lib.nvcc_path(), cuda_lib.NVCC_FLAGS)
                       for name, (subs, _group) in VARIANTS.items()}
            libs = {name: ctypes.CDLL(f.result()) for name, f in futures.items()}
        for lib in libs.values():
            EC._bind(lib)
        for proxy in args.proxies.split(","):
            coo = synth.preset(proxy)
            csr = P.coo_to_csr(coo)
            mat = device_ell(P.coo_to_ell(coo), transposed=True, device=dev)
            m, n = csr.shape
            w_pad, m_pad = mat.data.shape
            x = torch.as_tensor(np.random.default_rng(4).standard_normal(n), dtype=torch.float32,
                                device=dev)
            EC._plan(mat, dev)  # the layout's checks, once
            full = EC.ell_t_in_order(mat, x)
            lib_fn = torch.sparse_csr_tensor(
                torch.as_tensor(csr.indptr.astype(np.int32), device=dev),
                torch.as_tensor(csr.indices.astype(np.int32), device=dev),
                torch.as_tensor(csr.data, dtype=torch.float32, device=dev), size=csr.shape)
            t_lib = time_per_call(lambda v: lib_fn @ v, x) * 1e3
            g_lib = graph_ms(lambda: lib_fn @ x)
            nz = 8 * csr.nnz
            print(f"  {proxy} {m}x{n}, {csr.nnz} nnz, slab ({w_pad}, {m_pad}) "
                  f"{8 * w_pad * m_pad / 1e6:.2f} MB, nonzero slots {nz / 1e6:.2f} MB; cuSPARSE "
                  f"{t_lib:.4f} ms per call, {g_lib:.4f} ms graphed", flush=True)
            ref = None
            for name, (_subs, group) in VARIANTS.items():
                lib = libs[name]
                group = EC.GROUP_ROWS if group == "source" else group
                walk = (EC.walk_table(mat.row_lens, m, group) if group else
                        torch.full((-(-m // EC.GROUP_ROWS),), w_pad, dtype=torch.int32, device=dev))

                def run(v, lib=lib, walk=walk):
                    y = torch.empty(m, device=dev)
                    rc = lib.ell_t_launch(mat.data.data_ptr(), mat.cols.data_ptr(), walk.data_ptr(),
                                          m_pad, m, v.data_ptr(), n, y.data_ptr(),
                                          cuda_lib.current_stream(dev))
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                    return y

                y = run(x)
                torch.cuda.synchronize()
                ref = y if ref is None else ref
                if not torch.equal(y, ref) or not torch.equal(y, full):
                    raise AssertionError(f"{proxy} {name}: another y")
                tk = min(time_per_call(run, x) for _ in range(3)) * 1e3
                tg = min(graph_ms(lambda: run(x)) for _ in range(3))
                read = walked_bytes(mat, walk, group or EC.GROUP_ROWS)
                print(f"    {name:6s} {tk:.4f} ms per call | {tg:.4f} ms graphed | walks "
                      f"{read / 1e6:.2f} MB of slab | {tk / t_lib:.3f}x cuSPARSE per call, "
                      f"{tg / g_lib:.3f}x graphed", flush=True)
            del mat, lib_fn
    return 0


if __name__ == "__main__":
    sys.exit(main())
