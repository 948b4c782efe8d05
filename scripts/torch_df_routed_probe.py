#!/usr/bin/env python3
"""Probe of the double-float routed product (PL_CSR_ROUTED_F64) on one GPU,
on webbase_like (1,000,005 rows, webbase-1M's size; its 193 heavy rows are
too many for the dense (hi, lo) block, so they reduce over the routed run
levels: C-df's multi-level path) and, with --proxies, on other synthetic
presets.

    python3 scripts/torch_df_routed_probe.py [--proxies NAME,...]

For each matrix: the df prepare once (AutoSpMV's operands at float64), the
program's stages and launches per product; the product on x ~ N(0, 1) from a
seed, bit for bit against its plain chain (plain=True) and the staged chain
(the W stages one by one), a rerun bit for bit, and within 1e-11 * max|y| of
the exact f64 oracle (1e-10 for a chunked layout); then its time per call
through routed_df_spmv and in a CUDA graph (CUDA events), the plain chain's,
cuSPARSE's f64 CSR product (torch.sparse, the yardstick; the port never
calls it), and each launch alone in a CUDA graph with its bound (the bytes
of its inputs and outputs, once, over 3.35 TB/s), each D-df launch beside
torch.mv on its f64 block (the one PyTorch call of the same function; the
port never calls it), the output gather beside one f64 torch.take through
its map (the movement alone). Prints the card's name and
power limit first and one JSON line last. Needs a CUDA device; any failure
raises and exits non-zero.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

#: H100 SXM data sheet: the HBM rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def stage_bytes(stage, n_x: int) -> int:
    """Bytes one df stage must move: its inputs read once (x in f64, both
    planes of the elements its offsets name), its outputs written once."""
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC

    def reduce_bytes(st):
        off = st.imap.idx
        mask = 4 * off.numel() if st.mask is not None else 0
        return nbytes(off, st.groups, st.chunks, st.tasks) + mask + 8 * int((off >= 0).sum()) \
            + 8 * st.out_elems()

    if isinstance(stage, RC.DFGatherReduceStage):
        b = nbytes(stage.vals, stage.cols, stage.groups, stage.chunks, stage.tasks) + 8 * n_x \
            + 8 * stage.out_elems()
        return b + (reduce_bytes(stage.tail) if stage.tail is not None else 0)
    if isinstance(stage, RC.DFReduceStage):
        return reduce_bytes(stage)
    if isinstance(stage, RC.DFPermuteStage):
        idx = stage.imap.idx.reshape(-1)[:stage.n]
        return 4 * idx.numel() + 8 * int((idx >= 0).sum()) + 8 * stage.n
    return nbytes(stage.hh, stage.hl, stage.rows) + 8 * n_x + 8 * stage.hh.shape[0]


def stage_label(stage, level: int) -> str:
    """A df stage's name: C-df with its level (level 0 with the level its
    last CTA closes), D-df with its rows."""
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC

    if isinstance(stage, RC.DFGatherReduceStage):
        return "df_gather_reduce level 0" + (" + 1 (closed)" if stage.tail is not None else "")
    if isinstance(stage, RC.DFReduceStage):
        return f"df_reduce level {level}"
    if isinstance(stage, RC.DFRowdotStage):
        return f"df_rowdot {stage.hh.shape[0]} rows"
    return stage.kernel


def probe(name: str, dev, smi: str) -> dict:
    import numpy as np
    import torch

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
    from spmv_openmp_cuda_tpu_torch.utils import synth
    from spmv_openmp_cuda_tpu_torch.utils.profiling import time_per_call

    t = time.perf_counter()
    csr = P.coo_to_csr(synth.preset(name))
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    model = AutoSpMV.from_csr(csr, cfg=P.Config(dtype="float64"), device=dev)
    prep_s = time.perf_counter() - t
    chain = model._operands
    if model.format != "routed" or not isinstance(chain, RC.RoutedDFChain):
        raise AssertionError(f"{name}: AutoSpMV at float64 picked {model.format}, not routed")
    m, n = csr.shape
    doms = chain.domains
    print(f"{name}: {m}x{n}, {csr.nnz} nnz, generated in {gen_s:.1f}s, df prepare+upload "
          f"{prep_s:.1f}s; {len(doms)} domain(s); first: rows_a={doms[0].mat.rows_a} "
          f"t1={doms[0].mat.perm_products.t} levels={[p.t for p in doms[0].mat.lvl_perms]} "
          f"groups per level={[r[-1][3] + r[-1][1] for r in (doms[0].mat.runs, *doms[0].mat.lvl_runs)]} "
          f"dense heavy rows {len(doms[0].heavy_rows_df)}; program per product {chain.counts} "
          f"({RC.df_chain_launches(chain)} launches, one host call)", flush=True)
    # device bytes of the layout's pieces the chain adds or drops: level 0's
    # composed value pairs and x columns, the K3 products scratch and x's
    # planes they replace, level 0's offsets (composed from, then kept on
    # the host), and the per-call scratch
    composed = sum(nbytes(st.vals, st.cols) for st in chain.stages
                   if isinstance(st, RC.DFGatherReduceStage))
    offsets = sum(nbytes(st.imap.idx) for st in chain.stages
                  if isinstance(st, RC.DFGatherReduceStage))
    k3 = max(8 * d.mat.vals.numel() for d in doms)  # the largest domain's products
    planes = 8 * (-(-n // 64) * 64) if any(d.heavy_rows_df for d in doms) else 0
    print(f"{name}: level 0's composed operands {composed / 1e6:.3f} MB (vals and cols), in place of "
          f"K3's products scratch {k3 / 1e6:.3f} MB, x's planes {planes / 1e6:.3f} MB and level 0's "
          f"offsets {offsets / 1e6:.3f} MB (kept on the host); scratch "
          f"{4 * chain.scratch_elems / 1e6:.3f} MB per call", flush=True)
    xn = np.random.default_rng(3).standard_normal(n)
    x = torch.as_tensor(xn, dtype=torch.float64, device=dev)
    before = {k: fn.launches for k, fn in RC._DF_COUNTERS.items()}
    y, y2 = RC.routed_df_spmv(chain, x), RC.routed_df_spmv(chain, x)
    torch.cuda.synchronize()
    made = {k: fn.launches - before[k] for k, fn in RC._DF_COUNTERS.items()}
    yp = RC.routed_df_spmv(chain, x, plain=True)
    ys = RC.routed_df_staged_reference(chain, x)
    o = serial_csr_spmv(csr, xn)
    rel = float(np.abs(y.cpu().numpy() - o).max() / np.abs(o).max())
    lim = 1e-10 if len(doms) > 1 else 1e-11
    checks = {"plain": RC.bits_equal(y, yp), "staged": RC.bits_equal(y, ys),
              "rerun": RC.bits_equal(y, y2), "launches": made == {k: 2 * v for k, v in chain.counts.items()},
              "oracle": rel <= lim, "finite": bool(torch.isfinite(y).all())}
    print(f"{name}: bit for bit its plain chain {checks['plain']}, the staged chain "
          f"{checks['staged']}, its rerun {checks['rerun']}; launches of two products {made}; "
          f"{rel:.3e} * max|y| of the exact f64 oracle <= {lim:.0e}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"{name}: failed {[k for k, v in checks.items() if not v]}")
    t_k = time_per_call(lambda v: RC.routed_df_spmv(chain, v), x)
    t_g = graph_ms(lambda: RC.routed_df_spmv(chain, x), reps=10) / 1e3
    t_p = time_per_call(lambda v: RC.routed_df_spmv(chain, v, plain=True), x)
    crow = torch.as_tensor(csr.indptr.astype(np.int32), device=dev)
    col = torch.as_tensor(csr.indices.astype(np.int32), device=dev)
    a = torch.sparse_csr_tensor(crow, col, torch.as_tensor(csr.data, device=dev), size=csr.shape)
    t_l = time_per_call(lambda v: a @ v, x)
    del a
    bufs = RC._df_buffers(chain, x)
    for st in chain.stages:  # valid inputs for every stage
        RC.run_df_stage(st, bufs, plain=True)
    stages, total_b, level = [], 0, 0
    for i, st in enumerate(chain.stages):
        us = graph_ms(lambda s=st: RC.run_df_stage(s, bufs, plain=False)) * 1e3
        b = stage_bytes(st, n)
        total_b += b
        if isinstance(st, RC.DFGatherReduceStage):
            level = 1 + (st.tail is not None)
        label = stage_label(st, level)
        level += isinstance(st, RC.DFReduceStage)
        row = {"stage": i, "kernel": label, "us": us, "bytes": b, "bound_us": b / HBM_BYTES_PER_S * 1e6}
        extra = ""
        if isinstance(st, RC.DFRowdotStage):
            # the one PyTorch call of the same function: the f64 block times x
            block = st.hh.double() + st.hl.double()
            xpad = torch.nn.functional.pad(x, (0, block.shape[1] - n))
            row["library_us"] = graph_ms(lambda: torch.mv(block, xpad)) * 1e3
            extra = f" | torch.mv (f64 block) {row['library_us']:.2f} us"
            del block, xpad
        if isinstance(st, RC.DFPermuteStage):
            # the movement alone: one f64 torch.take through the same map
            # (its -1 pointed at a zero appended), the pairs combined first
            src = RC._pairs(bufs, st.src)
            src = torch.cat([src[:, 0].double() + src[:, 1].double(), src.new_zeros(1).double()])
            idx = st.imap.idx.reshape(-1)[:st.n].long()
            idx = torch.where(idx >= 0, idx, src.numel() - 1)
            row["library_us"] = graph_ms(lambda: torch.take(src, idx)) * 1e3
            extra = f" | torch.take (f64) {row['library_us']:.2f} us"
            del src, idx
        stages.append(row)
        print(f"  stage {i:2d} {label:28s} {us:8.2f} us in a graph | {b / 1e6:8.3f} MB, bound "
              f"{b / HBM_BYTES_PER_S * 1e6:7.2f} us{extra}", flush=True)
    del bufs
    bound_ms = total_b / HBM_BYTES_PER_S * 1e3
    print(f"{name} PL_CSR_ROUTED_F64 on {smi}: {t_k * 1e3:.4f} ms per call ({t_g * 1e3:.4f} ms in a "
          f"CUDA graph) {2 * csr.nnz / t_k / 1e9:.2f} GFLOP/s | plain chain {t_p * 1e3:.4f} ms | "
          f"cuSPARSE CSR f64 {t_l * 1e3:.4f} ms ({t_k / t_l:.2f}x per call, {t_g / t_l:.2f}x "
          f"graphed) | stages move {total_b / 1e6:.3f} MB: bound {bound_ms:.4f} ms, graphed at "
          f"{100 * bound_ms / (t_g * 1e3):.1f} % of it", flush=True)
    return {"name": name, "shape": [m, n], "nnz": csr.nnz, "domains": len(doms),
            "launches_per_product": RC.df_chain_launches(chain), "counts": chain.counts,
            "ms": t_k * 1e3, "graph_ms": t_g * 1e3, "plain_ms": t_p * 1e3, "library_ms": t_l * 1e3,
            "bound_ms": bound_ms, "oracle_rel": rel, "prepare_s": prep_s, "stages": stages,
            "composed_bytes": composed, "k3_scratch_bytes": k3, "x_planes_bytes": planes,
            "level0_offsets_host_bytes": offsets,
            "scratch_bytes": 4 * chain.scratch_elems}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--proxies", default="webbase_like",
                    help="comma-separated synth presets (default webbase_like)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_df_routed_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda")
    out = [probe(name, dev, smi) for name in args.proxies.split(",")]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "results": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
