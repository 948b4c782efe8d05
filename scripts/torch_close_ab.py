#!/usr/bin/env python3
"""A/B of two checkouts of the PyTorch/CUDA port on one GPU: the window
kernels (PL_CSR_WINDOW, PL_CSR_WINDOW_BF16 and PL_CSR_WINDOW_F64 on
thermal2_like, fem_3d_thermal2_like and delaunay_n12_like, hashed), the
transposed-ELL product (PL_ELL_ROWS_T, ell_t_kernel) on sg_like and
thermal2_like, hashed, the dense heavy-row kernel D on caida_like (with its
close; its sums hashed), the routed kernels A (the gather), B
(the output permutation, and any other W-stage launches), C (per level)
and E (webbase_like's pooled heavy tiles, with their close) each alone in
a CUDA graph on caida_like's and webbase_like's chains, the routed
products in f32 and bf16 (the bf16 operands: the f32 layout with its gather
and pooled values cast) on caida_like, webbase_like and sg_rand_like and the
double-float routed product (PL_CSR_ROUTED_F64, with the kernels and
memsets one product enqueues, from a torch.profiler trace) on caida_like,
sg_rand_like and webbase_like (on caida_like and webbase_like also each df
kernel alone in a CUDA graph, summed over its launches, and torch.mv on the
f64 heavy blocks), with a hash of each y from a seeded x (parent and change
bitwise equal or not),
the PL_CSR_ROUTED product on three small domains
(delaunay_n12_like, west2021_like, a 9000-row random matrix: the small
kernel), the PL_CSR_LANES product (lanes_kernel) on delaunay_n12_like,
raefsky1_like, cavity10_like and west2021_like, the DIA+residual product
(PL_DIA_RESID, _BF16 and _F64) on raefsky1_like and on a 200,000-row banded
check matrix, and the DIA rows products (dia_rows_kernel: PL_DIA_ROWS on
cube_coup_like, cavity10_like and the 5-point Laplacian of a 1000 x 1000
grid, PL_DIA_BF16 on cube_coup_like; dia_df_kernel: PL_DIA_F64 on
cube_coup_like, cavity10_like and the Laplacian; hashed), each per call
through its wrapper and in a
CUDA graph, whether a rerun on the same x is bitwise equal, and, for the
window, lanes and DIA products, the share of the bound: the bytes the
product must move (the layout's arrays and x read once, y written once)
over 3.35 TB/s, against the graphed time. The window F64 operands are the
f32 layout with a zero lo plane (the df layout's shape and bytes, without a
second prepare); the 200,000-row band is prepared once in df, its f32
operands are the hi planes (what the f32 prepare makes) and bf16 their
cast. The large matrices are generated by the first run and kept in a
temporary directory for the other three.

    python3 scripts/torch_close_ab.py [--dia | --df] [--rounds N] PARENT_DIR CHANGE_DIR [MORE_DIRS...]

runs each checkout in a process of its own (its package on the path, its
kernels built from its csrc/) in the order last .. first, first .. last
(change, parent, parent, change for two trees; the last tree runs first and
fills the matrix cache, which a tree older than utils/synth.py's
laplacian_2d could not), N rounds of it (default 1), and prints each run's
numbers, the mean and the range (min .. max) of each tree's runs, and
whether each hashed y is bitwise the same in every run. --dia runs only the
DIA rows products (dia_rows_products), for a quick A/B of the DIA rows
kernels; --df only the double-float routed products (df_routed_products).
`--one DIR [CACHE_DIR] [--dia | --df]` runs one checkout and prints one
JSON line. Needs a CUDA device.
"""
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

PROXIES = ("thermal2_like", "fem_3d_thermal2_like", "delaunay_n12_like")
LANES_PROXIES = ("delaunay_n12_like", "raefsky1_like", "cavity10_like", "west2021_like")
ROUTED_PROXIES = ("caida_like", "webbase_like", "sg_rand_like")
MODES = ("PL_CSR_WINDOW", "PL_CSR_WINDOW_BF16", "PL_CSR_WINDOW_F64")  # all run by window_spmv
#: H100 SXM data sheet: the HBM rate
HBM_BYTES_PER_S = 3.35e12
#: the DIA+residual check matrix: 61 diagonals, 38 TPU blocks, 201,015
#: fringe nnz (the band streams from HBM)
RESID_BIG = "banded_200000"
#: CG's matrix in chip_smoke.py's phase 6: the 5-point Laplacian of a
#: 1000 x 1000 grid (10^6 rows, 4,996,000 nnz)
LAPLACE_N = 1000
LAPLACE = f"laplacian_{LAPLACE_N}x{LAPLACE_N}"
RESID_MODES = ("PL_DIA_RESID", "PL_DIA_RESID_BF16", "PL_DIA_RESID_F64")


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


def device_ops_per_call(fn):
    """The kernels and memsets one call of fn enqueues, from a torch.profiler
    trace of one call after a warm-up (None where the trace holds no device
    events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def cached_csr(name: str, cache) -> "CSRMatrix":
    """The named matrix (a preset, RESID_BIG or LAPLACE), from
    cache/<name>.npz when an earlier run of this A/B left it there."""
    import numpy as np

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.utils import synth

    path = os.path.join(cache, f"{name}.npz") if cache else None
    if path and os.path.exists(path):
        z = np.load(path)
        return P.CSRMatrix(tuple(int(d) for d in z["shape"]), z["indptr"], z["indices"], z["data"])
    if name == LAPLACE:
        csr = P.coo_to_csr(synth.laplacian_2d(LAPLACE_N))
    elif name == RESID_BIG:
        csr = P.coo_to_csr(synth.banded(200_000, 200_000, 30, fill=1.0, exact_nnz=12_400_000, seed=0))
    else:
        csr = P.coo_to_csr(synth.preset(name))
    if path:
        np.savez(path, shape=np.asarray(csr.shape), indptr=csr.indptr, indices=csr.indices,
                 data=csr.data)
    return csr


def _timed(out: dict, key: str, fn, x, moved: int) -> None:
    """out[key]: per call, graphed, rerun bitwise equal, the bound of
    `moved` bytes and its graphed share."""
    import torch

    from spmv_openmp_cuda_tpu_torch.utils.profiling import time_per_call

    a, b = fn(x), fn(x)
    torch.cuda.synchronize()
    tg = graph_ms(lambda: fn(x))
    out[key] = {"ms": time_per_call(fn, x) * 1e3, "graph_ms": tg,
                "rerun_equal": bool(torch.equal(a, b)),
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "bound_share": moved / HBM_BYTES_PER_S * 1e3 / tg}


def resid_products(dev, cache) -> dict:
    """The DIA+residual products on raefsky1_like and RESID_BIG."""
    import dataclasses

    import numpy as np
    import torch

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.ops import registry
    from spmv_openmp_cuda_tpu_torch.ops import spmv_cuda as SC

    derive = getattr(SC, "with_fringe_lists", lambda dr, plan: dr)  # a tree without lists
    out = {}
    for name in ("raefsky1_like", RESID_BIG):
        csr = cached_csr(name, cache)
        m, n = csr.shape
        if name == RESID_BIG:
            big64, plan = SC.prepare_dia_resid(csr, df=True, device=dev)
            ops = {"PL_DIA_RESID_F64": (big64, plan)}
            for mode, dt in (("PL_DIA_RESID", torch.float32), ("PL_DIA_RESID_BF16", torch.bfloat16)):
                mat = big64.mat.as_dia()
                mat = dataclasses.replace(mat, data=mat.data.to(dt))
                ops[mode] = (derive(dataclasses.replace(big64, mat=mat, rvals=big64.rvals.to(dt),
                                                        rvals_lo=None), plan), plan)
        else:
            ops = {mode: registry.get(mode).prepare(
                csr, None, P.Config(dtype="float64" if mode.endswith("F64") else "float32"), dev)
                for mode in RESID_MODES}
        xn = np.random.default_rng(4).standard_normal(n)
        for mode in RESID_MODES:
            dr, plan = ops[mode]
            df = mode.endswith("F64")
            x = torch.as_tensor(xn, dtype=torch.float64 if df else torch.float32, device=dev)
            d = len(dr.mat.offsets)
            # the slab's rows < m (both planes in df), the per-row fringe
            # lists (row_ptr, value words, column), x and y
            moved = (2 if df else 1) * d * m * dr.mat.data.element_size() + 4 * d
            moved += 4 * (m + 1) + (12 if df else 8) * dr.nnz_resid + x.element_size() * (n + m)
            _timed(out, f"{name} {mode} product", registry.get(mode).jitted(ops[mode]), x, moved)
        del ops
    return out


def ell_t_products(dev, cache) -> dict:
    """PL_ELL_ROWS_T (ell_t_kernel) on sg_like and thermal2_like, hashed."""
    import numpy as np
    import torch

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.ops import registry

    out = {}
    spec = registry.get("PL_ELL_ROWS_T")
    for name in ("sg_like", "thermal2_like"):
        csr = cached_csr(name, cache)
        ops = spec.prepare(csr, P.coo_to_ell(P.csr_to_coo(csr)), P.Config(), dev)
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(csr.shape[1]),
                            dtype=torch.float32, device=dev)
        fn = spec.jitted(ops)
        # the slab whole, x and y: the bound the parent's full-width walk had
        moved = sum(t.numel() * t.element_size() for t in (ops.data, ops.cols)) + 4 * sum(csr.shape)
        _timed(out, f"{name} PL_ELL_ROWS_T product", fn, x, moved)
        out[f"{name} PL_ELL_ROWS_T product"]["hash"] = hashlib.sha256(
            fn(x).cpu().numpy().tobytes()).hexdigest()[:16]
        del ops
    return out


#: the DIA rows products: matrix -> modes
DIA_ROWS_CELLS = {
    "cube_coup_like": ("PL_DIA_ROWS", "PL_DIA_BF16", "PL_DIA_F64"),
    "cavity10_like": ("PL_DIA_ROWS", "PL_DIA_F64"),
    LAPLACE: ("PL_DIA_ROWS", "PL_DIA_F64"),
}


def dia_rows_products(dev, cache) -> dict:
    """The DIA rows products (dia_rows_kernel, dia_df_kernel), hashed; the
    bound counts the slab's first m rows (both planes in df: the kernels
    stop at row m, so the plan's padding rows are never read), the offsets,
    x and y."""
    import numpy as np
    import torch

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.ops import registry

    out = {}
    for name, modes in DIA_ROWS_CELLS.items():
        csr = cached_csr(name, cache)
        xn = np.random.default_rng(4).standard_normal(csr.shape[1])
        for mode in modes:
            df = mode == "PL_DIA_F64"
            mat, plan = ops = registry.get(mode).prepare(
                csr, None, P.Config(dtype="float64" if df else "float32"), dev)
            x = torch.as_tensor(xn, dtype=torch.float64 if df else torch.float32, device=dev)
            moved = (2 if df else 1) * len(mat.offsets) * csr.shape[0] * mat.data.element_size()
            moved += 4 * len(mat.offsets)
            fn = registry.get(mode).jitted(ops)
            key = f"{name} {mode} product"
            _timed(out, key, fn, x, moved + x.element_size() * sum(csr.shape))
            out[key]["hash"] = hashlib.sha256(fn(x).cpu().numpy().tobytes()).hexdigest()[:16]
            del mat, ops, fn
    return out


def bf16(mat):
    """The PL_CSR_ROUTED_BF16 operands of a routed layout (a RoutedCSR or
    RoutedChunks): its gather values, and pooled heavy values, cast."""
    import dataclasses

    import torch

    if hasattr(mat, "chunks"):
        return dataclasses.replace(mat, chunks=tuple(bf16(c) for c in mat.chunks))
    return dataclasses.replace(
        mat, vals=mat.vals.to(torch.bfloat16),
        hvals=None if mat.hvals is None else mat.hvals.to(torch.bfloat16))


def routed_stage_times(name: str, chain, x) -> dict:
    """Kernels A, B, C and E of a routed chain, each launch alone in a CUDA
    graph on valid inputs, summed per role: A (the gather), C by level (the
    i-th reduce of a domain), B as the output permutation (the B launches
    after a domain's last reduce) or the W stages before a reduce (a tree
    whose chain still runs them), E (the pooled heavy tiles and their
    close)."""
    import torch

    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.utils.profiling import time_per_call

    bufs = RC._buffers(chain, x)
    for st in chain.stages:
        RC.run_stage(st, bufs, plain=True)
    out, level = {}, 0
    for i, st in enumerate(chain.stages):
        if type(st).__name__ == "GatherStage":
            level = 0
        if st.kernel == "gather":
            role = "A"
        elif st.kernel == "heavy":
            role = "E"
        elif st.kernel == "perm_reduce":
            role, level = f"C level {level}", level + 1
        elif st.kernel in ("w_stage", "permute"):
            later = chain.stages[i + 1:]
            end = next((j for j, s in enumerate(later) if type(s).__name__ == "GatherStage"),
                       len(later))
            role = "B before a reduce" if any(s.kernel == "perm_reduce" for s in later[:end]) \
                else "B output permutation"
        else:
            continue
        cell = out.setdefault(f"{name} kernel {role}",
                              {"ms": 0.0, "graph_ms": 0.0, "rerun_equal": None, "launches": 0})
        cell["ms"] += time_per_call(lambda v, st=st: RC.run_stage(st, bufs, plain=False), x) * 1e3
        cell["graph_ms"] += graph_ms(lambda st=st: RC.run_stage(st, bufs, plain=False))
        cell["launches"] += 1
    return out


def df_routed_products(dev, cache) -> dict:
    """The double-float routed products (PL_CSR_ROUTED_F64) on caida_like,
    sg_rand_like and webbase_like, hashed (y for x ~ N(0, 1) and for the
    reference's x), with the scratch a call takes, the kernels and memsets one
    product enqueues (a torch.profiler trace); on caida_like and
    webbase_like each kernel's launches alone in a CUDA graph, summed per
    kernel name (the chain's stages run with their plain versions first, so
    each launch reads valid inputs), and torch.mv on each dense heavy block
    in f64 (the one PyTorch call of D-df's function)."""
    import numpy as np
    import torch

    from spmv_openmp_cuda_tpu_torch.io.vectors import fill_rnd_vector
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.utils.profiling import time_per_call

    out = {}
    for name in ("caida_like", "sg_rand_like", "webbase_like"):
        csr = cached_csr(name, cache)
        c = RC.prepare_routed_df_chain(csr, device=dev)
        xd = torch.as_tensor(np.random.default_rng(4).standard_normal(csr.shape[1]),
                             dtype=torch.float64, device=dev)
        xr = torch.as_tensor(fill_rnd_vector(csr.shape[1], seed=2), dtype=torch.float64,
                             device=dev)
        a, b = RC.routed_df_spmv(c, xd), RC.routed_df_spmv(c, xd)
        ar = RC.routed_df_spmv(c, xr)
        torch.cuda.synchronize()
        out[f"{name} PL_CSR_ROUTED_F64 product"] = {
            "ms": time_per_call(lambda v, c=c: RC.routed_df_spmv(c, v), xd) * 1e3,
            "graph_ms": graph_ms(lambda c=c, xd=xd: RC.routed_df_spmv(c, xd), reps=10),
            "rerun_equal": bool(torch.equal(a, b)),
            "launches": device_ops_per_call(lambda c=c, xd=xd: RC.routed_df_spmv(c, xd)),
            "scratch_mb": 4 * c.scratch_elems / 1e6,
            # y for x ~ N(0, 1) and for the reference's x (fill_rnd_vector)
            "hash": hashlib.sha256(a.cpu().numpy().tobytes()
                                   + ar.cpu().numpy().tobytes()).hexdigest()[:16]}
        if name != "sg_rand_like":
            bufs = RC._df_buffers(c, xd)
            for st in c.stages:
                RC.run_df_stage(st, bufs, plain=True)
            per = {}
            for st in c.stages:
                ms = graph_ms(lambda s=st: RC.run_df_stage(s, bufs, plain=False))
                acc = per.setdefault(st.kernel, [0.0, 0])
                acc[0] += ms
                acc[1] += 1
            for k, (ms, n) in per.items():
                out[f"{name} df kernel {k} alone, summed over its launches"] = {
                    "ms": ms, "graph_ms": ms, "rerun_equal": None, "launches": n}
            for i, st in enumerate(s for s in c.stages if s.kernel == "df_rowdot"):
                block = st.hh.double() + st.hl.double()
                xpad = torch.nn.functional.pad(xd, (0, block.shape[1] - xd.shape[0]))
                out[f"{name} torch.mv f64 on D-df block {i} {tuple(block.shape)}"] = {
                    "ms": time_per_call(lambda v: torch.mv(block, v), xpad) * 1e3,
                    "graph_ms": graph_ms(lambda: torch.mv(block, xpad)), "rerun_equal": None}
                del block, xpad
            del bufs
        del c
    return out


def one(tree: str, cache=None, dia_only: bool = False, df_only: bool = False) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    if dia_only or df_only:
        import spmv_openmp_cuda_tpu_torch as P

        assert P.__file__.startswith(os.path.abspath(tree)), P.__file__
        if df_only:
            return df_routed_products(torch.device("cuda"), cache)
        return dia_rows_products(torch.device("cuda"), cache)

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
                                     "bound_share": moved / HBM_BYTES_PER_S * 1e3 / tg,
                                     "hash": hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()[:16]}
    csr = cached_csr("caida_like", cache)
    mat = RC.prepare_routed_chain(csr, device=dev).mat
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(csr.shape[1]),
                        dtype=torch.float32, device=dev)
    n_h = mat.hdense.shape[0]
    target = torch.arange(n_h, dtype=torch.int32, device=dev)
    y = torch.zeros(-(-n_h // 128) * 128, device=dev)
    # the tree's own scratch size (zero: a ticket where the tree keeps one)
    part = torch.zeros(RC._hdense_part_elems(mat.hdense), device=dev)

    def d(v):  # kernel D alone: y[target[k]] += H[k] . x
        return RC.routed_hdense_cuda(mat.hdense, v, target, y, part)

    a = d(x).clone()
    y.zero_()
    b = d(x).clone()
    torch.cuda.synchronize()
    out[f"caida_like kernel D {tuple(mat.hdense.shape)}"] = {
        "ms": time_per_call(d, x) * 1e3, "graph_ms": graph_ms(lambda: d(x)),
        "rerun_equal": bool(torch.equal(a, b)),
        "hash": hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()[:16]}
    chain = RC.build_chain(mat)
    out.update(routed_stage_times("caida_like", chain, x))
    # whole routed products, f32 and bf16, hashed
    for name in ROUTED_PROXIES:
        csr = cached_csr(name, cache)
        c32 = chain if name == "caida_like" else RC.prepare_routed_chain(csr, device=dev)
        xr = torch.as_tensor(np.random.default_rng(4).standard_normal(csr.shape[1]),
                             dtype=torch.float32, device=dev)
        if name == "webbase_like":
            out.update(routed_stage_times(name, c32, xr))
        for mode, c in (("PL_CSR_ROUTED", c32), ("PL_CSR_ROUTED_BF16", RC.build_chain(bf16(c32.mat)))):
            a, b = RC.routed_chain_spmv(c, xr), RC.routed_chain_spmv(c, xr)
            torch.cuda.synchronize()
            out[f"{name} {mode} product"] = {
                "ms": time_per_call(lambda v, c=c: RC.routed_chain_spmv(c, v), xr) * 1e3,
                "graph_ms": graph_ms(lambda c=c: RC.routed_chain_spmv(c, xr)),
                "rerun_equal": bool(torch.equal(a, b)),
                "hash": hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()[:16]}
        del c32
    out.update(df_routed_products(dev, cache))
    # small domains (the small kernel)
    for name, coo in (("delaunay_n12_like", synth.preset("delaunay_n12_like")),
                      ("west2021_like", synth.preset("west2021_like")),
                      ("random_uniform 9000", synth.random_uniform(9000, 9000, density=5e-4, seed=7))):
        c = RC.prepare_routed_chain(P.coo_to_csr(coo), device=dev)
        xc = torch.as_tensor(np.random.default_rng(4).standard_normal(c.shape[1]),
                             dtype=torch.float32, device=dev)
        a, b = RC.routed_chain_spmv(c, xc), RC.routed_chain_spmv(c, xc)
        torch.cuda.synchronize()
        out[f"{name} PL_CSR_ROUTED product"] = {
            "ms": time_per_call(lambda v, c=c: RC.routed_chain_spmv(c, v), xc) * 1e3,
            "graph_ms": graph_ms(lambda c=c, xc=xc: RC.routed_chain_spmv(c, xc)),
            "rerun_equal": bool(torch.equal(a, b)),
            "hash": hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()[:16]}
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
    out.update(ell_t_products(dev, cache))
    out.update(resid_products(dev, cache))
    out.update(dia_rows_products(dev, cache))
    return out


def main(argv) -> int:
    dia_only, df_only = "--dia" in argv, "--df" in argv
    argv = [a for a in argv if a not in ("--dia", "--df")]
    if argv[:1] == ["--one"]:
        print(json.dumps(one(*argv[1:3], dia_only=dia_only, df_only=df_only)))
        return 0
    rounds = 1
    if argv[:1] == ["--rounds"]:
        rounds, argv = int(argv[1]), argv[2:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    trees = argv
    runs = {tree: [] for tree in trees}
    cache = tempfile.TemporaryDirectory()
    for tree in (trees[::-1] + trees) * rounds:
        t = time.perf_counter()
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree, cache.name]
        flags = (["--dia"] if dia_only else []) + (["--df"] if df_only else [])
        proc = subprocess.run(cmd + flags, capture_output=True, text=True,
                              timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[tree].append(res)
        print(f"{tree} ({time.perf_counter() - t:.0f}s): {json.dumps(res)}", flush=True)
    cache.cleanup()
    print(f"mean (min .. max) of {2 * rounds} runs per tree, on {smi} (ms per call through the "
          "wrapper | ms in a CUDA graph | rerun bitwise equal | graphed share of the bound; kernels "
          "B and C alone: launches per product in brackets):")
    every = [run for tree in trees for run in runs[tree]]
    keys = list(dict.fromkeys([k for run in every for k in run]))
    for key in keys:
        print(f"  {key}" + next((f"   (bound {run[key]['bound_ms']:.4f} ms)" for run in every
                                 if "bound_ms" in run.get(key, {})), ""))
        for tree in trees:
            r = [run[key] for run in runs[tree] if key in run]
            if not r:
                continue
            eq = [v["rerun_equal"] for v in r]
            share = [v["bound_share"] for v in r if "bound_share" in v]
            ms, gms = [v["ms"] for v in r], [v["graph_ms"] for v in r]
            print(f"    {tree:28s} {sum(ms) / len(ms):.4f} ({min(ms):.4f} .. {max(ms):.4f}) | "
                  f"{sum(gms) / len(gms):.4f} ({min(gms):.4f} .. {max(gms):.4f}) | "
                  f"{'-' if None in eq else all(eq)} | "
                  f"{f'{100 * sum(share) / len(share):.1f} %' if share else '-'}"
                  + (f" ({r[0]['launches']})" if "launches" in r[0] else ""))
    print("y of every tree against the others (the same x from a seed; every run's hash):")
    for key in keys:
        hashes = [run[key]["hash"] for run in every if "hash" in run.get(key, {})]
        if hashes:
            print(f"  {key:46s} bitwise equal: {len(hashes) == len(every) and len(set(hashes)) == 1} "
                  f"({', '.join(hashes)})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
