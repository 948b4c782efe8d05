#!/usr/bin/env python3
"""Probe of the routed kernels C, A and E on one GPU: variants of
spmv_openmp_cuda_tpu_torch/csrc/routed_spmv.cu, built by text substitution
in a build copy, each timed alone in a CUDA graph on caida_like's and
webbase_like's chains (valid inputs from the plain chain) and on the whole
product; every variant's output must be bitwise the source's (the same
products and adds in the same order).

    python3 scripts/torch_routed_probe.py [--kernel C|A|D|E] [--proxies a,b]

--kernel C (the default): C's stages, with its groups packed into chunks
of 0 (one group per CTA) or routed_cuda._CHUNK_ROWS rows. Variants: the
source as it is (a one-warp CTA per chunk and band of 32 lanes, batches of
16 rows); "cta128" (a CTA of 128 lanes per chunk: one SM holds a wide
group's four bands); "batch8" and "batch32" (rows whose loads a thread
issues together); "ldcg" (value reads cached in L2 only).

--kernel A: the gather. Variants: the source as it is (a CTA per two
bands of a tile, the x window bulk-copied into each); "loop1" and "loop4"
(one band, four bands per CTA); "slab" (A stores each product at the slab
slot where C level 0 reads it, through an int32 map composed from W1 and
C's offsets, and C level 0 reads its slab through identity offsets).
Prints A alone, A + C level 0 in one graph, and the product, per variant.

--kernel E: the pooled heavy tiles with their close, on the proxies that
have them (webbase_like): the source as it is, "walk1" (one warp walks
each residue's 128 lanes), "ctas1" (one persistent CTA per SM), and
variants named "-..." that leave out part of the work (their sums are
wrong), to see what each part costs.

--kernel D --proxies caida_like: the dense heavy rows (one launch, the
last CTA closing the product): the source as it is (rows per CTA halved
from all, up to 8, while the CTAs would be fewer than half the SMs),
"rows8" (all the rows in one CTA per chunk: x read once), "rows2" and
"rows1" (x read once per row, as before the redesign), and "-close" (no
close: wrong sums, to price it). Prints D alone in a CUDA graph per
variant, each exact one bitwise routed_cuda.hdense_in_order.

Prints the card's name and power limit first. Needs a CUDA device.
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
#: A's variants: substitutions in csrc/routed_spmv.cu
A_VARIANTS = {
    "as is": [],
    "loop1": [("constexpr int kGatherBands = 2;", "constexpr int kGatherBands = 1;")],
    "loop4": [("constexpr int kGatherBands = 2;", "constexpr int kGatherBands = 4;")],
    # w1 carries the int32 slab map: each product goes straight to its slot
    # (one band per CTA)
    "slab": [("constexpr int kGatherBands = 2;", "constexpr int kGatherBands = 1;"),
             ("  if (tile >= n_real) {\n", "  if (tile >= n_real) {  // no products: no slab slot\n    return;\n"),
             ("""#pragma unroll
    for (int k = 0; k < 16; ++k)
      pr[s * kBand + ((16 * h + k) ^ (s % kBand))] = __fmul_rn(cur.v[k], xw[pb[k] * kLane + s]);
""", """    {
      const int32_t* smap = reinterpret_cast<const int32_t*>(w1) + base + (long long)s * kLane +
                            (band0 + kb) * kBand + 16 * h;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int d = __ldg(smap + k);
        if (d >= 0) out[d] = __fmul_rn(cur.v[k], xw[pb[k] * kLane + s]);
      }
      return;
    }
""")],
}
#: E's variants; those named "-" leave out part of the work (their sums are
#: wrong): they time what the rest costs
E_VARIANTS = {
    "as is": [],
    "walk1": [("constexpr int kWalkSegs = 4;", "constexpr int kWalkSegs = 1;")],
    "ctas1": [("constexpr int kHeavyCtasPerSm = 2;", "constexpr int kHeavyCtasPerSm = 1;")],
    "-spill": [("if (!__any_sync(0xffffffffu, open || more)) break;", "if (!more) break;")],
    "-walk": [("    if (seg < kWalkSegs) {", "    if (false) {")],
    "-compute": [("    heavy_sums<T>(stage[k & 1], fl_s, item / kQuarters, item % kQuarters, part);",
                  "    part[item * kLane + threadIdx.x] = stage[k & 1].xs[threadIdx.x];")],
}
#: D's variants: rows of the heavy block per CTA
_D_RULE = "while (rows > 1 && 2LL * n_cta"
D_VARIANTS = {
    "as is": [],
    "rows8": [(_D_RULE, "while (false && 2LL * n_cta")],
    "rows2": [("int rows = min(n_h, kHRows);", "int rows = min(n_h, 2);"),
              (_D_RULE, "while (false && 2LL * n_cta")],
    "rows1": [("int rows = min(n_h, kHRows);", "int rows = 1;"),
              (_D_RULE, "while (false && 2LL * n_cta")],
    # no close (wrong sums): what the last CTA's close costs
    "-close": [("  if (!last) return;\n", "  return;\n")],
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


def slab_map(gather, reduce_, dev):
    """(smap, identity IndexMap) for the "slab" variant: smap[p] = the slot
    of C level 0's slab that reads A's product p (element (T*128 + s)*128 +
    l before W1), -1 where none does; the identity map reads slot i where
    C's offset was not -1."""
    import dataclasses

    import torch

    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC

    lane, tile = RC.LANE, RC.LANE * RC.LANE
    off = reduce_.imap.idx.reshape(-1).long()
    n_real = gather.vals.shape[0] // lane
    slot = torch.arange(off.numel(), device=dev)
    keep = (off >= 0) & (off < n_real * tile)
    e, i = off[keep], slot[keep]
    t, j, ln = e // tile, (e // lane) % lane, e % lane
    s = gather.w1[t * lane + ln, j].long()
    smap = torch.full((n_real * tile,), -1, dtype=torch.int64, device=dev)
    smap[(t * lane + s) * lane + ln] = i
    ident = torch.where(off >= 0, slot, torch.full_like(slot, -1))
    ident = ident.to(torch.int32).reshape(reduce_.imap.idx.shape).contiguous()
    imap = dataclasses.replace(reduce_.imap, idx=ident, span=off.numel())
    return smap.to(torch.int32).contiguous(), imap


def probe_a(libs, use, proxies, dev) -> None:
    """A's variants on each proxy's first domain: A alone, A + C level 0 in
    one graph, the product; outputs bitwise those of the source as is."""
    import dataclasses

    import numpy as np
    import torch

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.utils import synth

    for proxy in proxies:
        use("as is")
        csr = P.coo_to_csr(synth.preset(proxy))
        chain = RC.prepare_routed_chain(csr, device=dev)
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(csr.shape[1]),
                            dtype=torch.float32, device=dev)
        bufs = RC._buffers(chain, x)
        for st in chain.stages:
            RC.run_stage(st, bufs, plain=True)
        k = next(i for i, st in enumerate(chain.stages) if isinstance(st, RC.GatherStage))
        ga, c0 = chain.stages[k], chain.stages[k + 1]
        assert isinstance(c0, RC.ReduceStage)
        smap, ident = slab_map(ga, c0, dev)
        slab = torch.zeros(ident.idx.numel(), device=dev)
        c_out = RC._view(bufs, c0.out, c0.out_elems())
        y_ref = RC.routed_chain_spmv(chain, x).clone()
        a_ref = RC._view(bufs, ga.out, ga.out_elems()).clone()
        c_ref = None  # kernel C's sums from the source's A (C adds in its own order)

        def a_op(variant):
            if variant == "slab":
                return RC._gather_op(ga.vals, ga.pidx, ga.widx, smap, ga.n_tiles, slab)
            return RC._gather_op(ga.vals, ga.pidx, ga.widx, ga.w1, ga.n_tiles,
                                 RC._view(bufs, ga.out, ga.out_elems()))

        cells = {}
        for name in A_VARIANTS:
            use(name)
            prog_a = RC.Program(a_op(name))
            src = slab if name == "slab" else bufs["s"][c0.src.off:]
            imap = ident if name == "slab" else c0.imap
            prog_c = RC.Program(RC._reduce_op(src, imap, c0.mask, c0.groups, c0.chunks, c_out))

            def a_alone(p=prog_a):
                p.run(x, 0, 0, dev)

            def a_c(pa=prog_a, pc=prog_c):
                pa.run(x, 0, 0, dev)
                pc.run(x, 0, 0, dev)

            a_us = min(graph_ms(a_alone) for _ in range(3)) * 1e3
            ac_us = min(graph_ms(a_c) for _ in range(3)) * 1e3
            if name != "slab" and not torch.equal(RC._view(bufs, ga.out, ga.out_elems()), a_ref):
                raise AssertionError(f"{proxy} A {name}: other products")
            c_ref = c_out.clone() if c_ref is None else c_ref
            if not torch.equal(c_out, c_ref):
                raise AssertionError(f"{proxy} A {name}: other C level 0 sums")
            stages = list(chain.stages)
            if name == "slab":  # A into the slab, C from it: the slab in scratch
                at = RC.Buf("s", chain.scratch_elems)
                stages[k] = dataclasses.replace(ga, w1=smap, out=at)
                stages[k + 1] = dataclasses.replace(c0, src=at, imap=ident)
                scratch = chain.scratch_elems + ident.idx.numel()
            else:
                scratch = chain.scratch_elems
            var = dataclasses.replace(chain, stages=tuple(stages), scratch_elems=scratch,
                                      segments=tuple(RC.Program(g) if isinstance(g, np.ndarray)
                                                     else g for g in RC._encode(stages)))
            y = RC.routed_chain_spmv(var, x)
            if not torch.equal(y, y_ref):
                raise AssertionError(f"{proxy} A {name}: another y")
            p_us = min(graph_ms(lambda v=var: RC.routed_chain_spmv(v, x), reps=10)
                       for _ in range(3)) * 1e3
            cells[name] = (a_us, ac_us, p_us)
        print(f"  {proxy} A ({ga.vals.shape[0] // RC.LANE} real tiles of {ga.n_tiles}), us in a "
              "graph (A alone, A + C level 0, product): " + " | ".join(
                  f"{n} {a:6.2f} {ac:6.2f} {pu:6.2f}" for n, (a, ac, pu) in cells.items()),
              flush=True)
        del chain, bufs


def probe_e(libs, use, proxies, dev) -> None:
    """E's variants alone (with its close) on each proxy's pooled tiles; the
    exact ones bitwise the source's."""
    import numpy as np
    import torch

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.utils import synth

    for proxy in proxies:
        use("as is")
        csr = P.coo_to_csr(synth.preset(proxy))
        chain = RC.prepare_routed_chain(csr, device=dev)
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(csr.shape[1]),
                            dtype=torch.float32, device=dev)
        bufs = RC._buffers(chain, x)
        est = None
        for st in chain.stages:
            if isinstance(st, RC.HeavyStage):
                est, y0 = st, bufs["y"].clone()
            RC.run_stage(st, bufs, plain=True)
        if est is None:
            print(f"  {proxy}: no pooled heavy tiles", flush=True)
            continue
        ref, cells = None, []
        for name in E_VARIANTS:
            use(name)
            bufs["y"].copy_(y0)
            RC.run_stage(est, bufs, plain=False)
            y = bufs["y"].clone()
            ref = y if ref is None else ref
            if not name.startswith("-") and not torch.equal(y, ref):
                raise AssertionError(f"{proxy} E {name}: other sums")
            us = min(graph_ms(lambda: RC.run_stage(est, bufs, plain=False)) for _ in range(3))
            cells.append(f"{name} {us * 1e3:6.2f}")
        print(f"  {proxy} E and its close ({est.hvals.shape[0] // RC.LANE} tiles), us in a "
              "graph: " + " | ".join(cells), flush=True)
        del chain, bufs


def probe_d(libs, use, proxies, dev) -> None:
    """D's variants alone on each proxy's dense heavy block, each bitwise
    hdense_in_order."""
    import numpy as np
    import torch

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.utils import synth

    for proxy in proxies:
        use("as is")
        csr = P.coo_to_csr(synth.preset(proxy))
        chain = RC.prepare_routed_chain(csr, device=dev)
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(csr.shape[1]),
                            dtype=torch.float32, device=dev)
        bufs = RC._buffers(chain, x)
        dst = None
        for st in chain.stages:
            if isinstance(st, RC.HDenseStage) and st.kernel is not None:
                dst, y0 = st, RC._view(bufs, st.out, st.out_elems()).clone()
            RC.run_stage(st, bufs, plain=True)
        if dst is None:
            print(f"  {proxy}: no dense heavy block in the kernel", flush=True)
            continue
        want = y0.clone()
        want[dst.target.long()] += RC.hdense_in_order(dst.hdense, x)
        out = RC._view(bufs, dst.out, dst.out_elems())
        cells = []
        for name in D_VARIANTS:
            use(name)
            out.copy_(y0)
            RC.run_stage(dst, bufs, plain=False)
            if not name.startswith("-") and not torch.equal(out, want):
                raise AssertionError(f"{proxy} D {name}: not hdense_in_order bit for bit")
            us = min(graph_ms(lambda: RC.run_stage(dst, bufs, plain=False)) for _ in range(3))
            cells.append(f"{name} {us * 1e3:6.2f}")
        print(f"  {proxy} D {tuple(dst.hdense.shape)}, us in a graph: " + " | ".join(cells),
              flush=True)
        del chain, bufs


def probe_c(libs, use, proxies, dev) -> None:
    """C's variants on each proxy's C stages and product."""
    import numpy as np
    import torch

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.utils import synth

    for proxy in proxies:
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


def main() -> int:
    import argparse

    import torch

    from spmv_openmp_cuda_tpu_torch.ops import cuda_lib
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--kernel", choices=("C", "A", "D", "E"), default="C")
    ap.add_argument("--proxies", default=",".join(PROXIES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    src = (cuda_lib.SRC_DIR / "routed_spmv.cu").read_text()
    dev = torch.device("cuda", torch.cuda.current_device())
    variants = {"A": A_VARIANTS, "C": VARIANTS, "D": D_VARIANTS, "E": E_VARIANTS}[args.kernel]
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
            futures = {name: pool.submit(build_variant, src, subs, tmp, name, cuda_lib.nvcc_path(),
                                         cuda_lib.NVCC_FLAGS) for name, subs in variants.items()}
            libs = {name: f.result() for name, f in futures.items()}

        def use(name):
            lib = ctypes.CDLL(libs[name])
            RC._bind(lib)
            cuda_lib._LIBS["routed_spmv"] = lib

        probe = {"A": probe_a, "C": probe_c, "D": probe_d, "E": probe_e}[args.kernel]
        probe(libs, use, args.proxies.split(","), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
