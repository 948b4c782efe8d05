"""Iterative solvers over the port's SpMV engines.

Counterpart of spmv_openmp_cuda_tpu/models/solvers.py: conjugate gradients
and power iteration over any matvec (an AutoSpMV qualifies, with every
format it picks: DIA, DIA+residual, window, lanes, routed, transposed ELL,
binned, and the double-float ones at float64).

The JAX package compiles a whole solve into one XLA program
(`lax.while_loop`), with no host round trip per iteration. On the card the
counterpart is a CUDA graph: CHUNK iterations are captured once and
replayed. CG keeps while_loop's condition on the device as a mask: each
graphed iteration computes active = (k < maxiter) & (sqrt(rs) > tol*||b||)
and updates (x, r, p, rs, k) through torch.where, so the iterations after
convergence leave the state untouched bit for bit; the host reads `active`
once per replay. Power iteration has a fixed count: its chunk is replayed
iters // CHUNK times and the rest runs eagerly.

A capture costs more than the iterations it holds cost eagerly, so a graph
pays back only over a long solve: graph=None (the default) runs the first
GRAPH_AFTER iterations eagerly and graphs only what is left after them;
graph=True graphs from the first iteration, graph=False never. On the CPU
the solvers run eagerly. Every route runs the same operations, so a
graphed solve equals an eager one bit for bit.

Like the port's other entry points, the solvers run on the card unless the
caller asks for the CPU: the vectors go to the matvec's device (an
AutoSpMV's), else to `device`.

The vector operations (dots, axpys) are plain torch ops, as the JAX package
runs them as XLA ops outside its Pallas kernels.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from ..formats.matrix import target_device

Matvec = Callable[[torch.Tensor], torch.Tensor]

#: iterations per graph replay: the host reads CG's convergence flag once
#: per replay, and up to CHUNK - 1 masked iterations run past convergence
CHUNK = 8
#: iterations graph=None runs eagerly before it captures. On one H100 a
#: capture cost as much as 25-80 eager iterations and a replayed iteration
#: saved 24-59 % of an eager one (PERF.md), so a graph repays its capture
#: only after 100-140 iterations; a solve that ends just past this point
#: pays its capture for little
GRAPH_AFTER = 256

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor  # iterations taken (int32)
    relres: torch.Tensor  # ||b - A x|| / ||b|| as CG tracks it


class PowerResult(NamedTuple):
    eigenvalue: torch.Tensor
    eigenvector: torch.Tensor


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def _vector(v, matvec, device, dtype=None) -> torch.Tensor:
    """v as a tensor on the matvec's device and in its dtype (an AutoSpMV's
    `device` and `dtype`), else on `device` (which must exist) in `dtype`,
    else in its own."""
    v = torch.as_tensor(v)
    own = getattr(matvec, "device", None)
    device = torch.device(own) if own is not None else target_device(device)
    dtype = _DTYPES.get(getattr(matvec, "dtype", None)) or dtype or v.dtype
    return v.to(device=device, dtype=dtype)


def _eager_iters(graph: Optional[bool], device: torch.device, total: int) -> int:
    """How many of a solve's first `total` iterations run eagerly: none
    with graph=True, GRAPH_AFTER with graph=None on a CUDA device, else
    all."""
    if graph and device.type != "cuda":
        raise ValueError("a CUDA graph needs tensors on a CUDA device")
    if graph is None:
        return min(GRAPH_AFTER, total) if device.type == "cuda" else total
    return 0 if graph else total


def _cg_step(matvec: Matvec, x, r, p, rs):
    """One CG iteration (the JAX package's while_loop body)."""
    ap = matvec(p)
    alpha = rs / _dot(p, ap)
    x = torch.addcmul(x, alpha, p)
    r = torch.addcmul(r, alpha, ap, value=-1)
    rs_new = _dot(r, r)
    p = torch.addcmul(r, rs_new / rs, p)
    return x, r, p, rs_new


def _cg_active(rs, k, thr, maxiter: int) -> torch.Tensor:
    """while_loop's condition, on the device."""
    return (k < maxiter) & (torch.sqrt(rs) > thr)


def cg_chunk(matvec: Matvec, state: List[torch.Tensor], thr, maxiter: int, chunk: int):
    """`chunk` masked CG iterations from state (x, r, p, rs, k): an
    iteration whose condition is false returns its state unchanged. Returns
    (the new state, the condition after the last iteration). This is what
    the CUDA graph captures."""
    x, r, p, rs, k = state
    for _ in range(chunk):
        active = _cg_active(rs, k, thr, maxiter)
        nx, nr, np_, nrs = _cg_step(matvec, x, r, p, rs)
        x, r, p, rs = (torch.where(active, a, b) for a, b in ((nx, x), (nr, r), (np_, p), (nrs, rs)))
        k = k + active.to(k.dtype)
    return [x, r, p, rs, k], _cg_active(rs, k, thr, maxiter)


def _warm_up(fn) -> None:
    """Run fn once on a side stream before capture: the wrappers make their
    launch plans (a device sync) at a layout's first launch, and the CUDA
    libraries load lazily; neither may happen inside capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)


def cg_graph(matvec: Matvec, state: List[torch.Tensor], thr, maxiter: int, chunk: int):
    """Capture cg_chunk over the buffers of state (x, r, p, rs, k; distinct
    tensors on a CUDA device), which each replay advances in place: returns
    (the CUDA graph, its condition flag after the chunk)."""
    _warm_up(lambda: cg_chunk(matvec, [t.clone() for t in state], thr, maxiter, 1))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, active = cg_chunk(matvec, state, thr, maxiter, chunk)
        for dst, src in zip(state, out):
            dst.copy_(src)
    return graph, active


def cg_initial(matvec: Matvec, b: torch.Tensor, x: torch.Tensor, tol: float):
    """(state (x, r, p, rs, k) before the first iteration, the stopping
    threshold tol * ||b||, ||b||)."""
    bnorm = torch.sqrt(_dot(b, b))
    r = b - matvec(x)
    state = [x, r, r.clone(), _dot(r, r), torch.zeros((), dtype=torch.int32, device=b.device)]
    return state, tol * bnorm, bnorm


def _cg_graphed(matvec: Matvec, state: List[torch.Tensor], thr, maxiter: int):
    if not bool(_cg_active(state[3], state[4], thr, maxiter)):
        return state
    state = [t.clone() for t in state]  # the graph's own buffers
    graph, active = cg_graph(matvec, state, thr, maxiter, CHUNK)
    while True:
        graph.replay()
        if not bool(active):
            return state


def conjugate_gradient(
    matvec: Matvec,
    b,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 200,
    graph: Optional[bool] = None,
    device="cuda",
) -> CGResult:
    """CG for a symmetric positive-definite A. It stops when k == maxiter
    or sqrt(rs) <= tol * ||b||, and relres is sqrt(rs) / ||b|| (the JAX
    package's semantics). b goes to the matvec's device and dtype (an
    AutoSpMV's), else to `device`. graph: see the module's docstring."""
    b = _vector(b, matvec, device)
    x = torch.zeros_like(b) if x0 is None else _vector(x0, matvec, b.device, b.dtype)
    state, thr, bnorm = cg_initial(matvec, b, x, tol)
    eager = _eager_iters(graph, b.device, maxiter)
    x, r, p, rs, _k = state
    n = 0
    while n < eager and bool(torch.sqrt(rs) > thr):
        x, r, p, rs = _cg_step(matvec, x, r, p, rs)
        n += 1
    state = [x, r, p, rs, torch.tensor(n, dtype=torch.int32, device=b.device)]
    if n == eager < maxiter:
        state = _cg_graphed(matvec, state, thr, maxiter)
    x, r, _p, rs, k = state
    return CGResult(x=x, iters=k, relres=torch.sqrt(rs) / bnorm)


def _power_body(matvec: Matvec, v: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.sqrt(_dot(w, w))
    return v


def start_vector(n: int, seed: int = 0, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """power_iteration's v0 (before normalization), on the CPU."""
    return torch.randn(n, generator=torch.Generator().manual_seed(seed), dtype=torch.float64).to(dtype)


def power_iteration(
    matvec: Matvec,
    n: int,
    iters: int = 100,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    graph: Optional[bool] = None,
    device="cuda",
) -> PowerResult:
    """Dominant eigenpair by `iters` power iterations from v0 ~ N(0, 1),
    drawn on the CPU from a torch.Generator seeded with `seed` (the same v0
    on every device; the JAX package's PRNG stream is not reproduced). It
    runs on the matvec's device and in its dtype (an AutoSpMV's), else on
    `device` in `dtype`. graph: see the module's docstring."""
    v = _vector(start_vector(n, seed, dtype), matvec, device)
    v = v / torch.sqrt(_dot(v, v))
    eager = _eager_iters(graph, v.device, iters)
    v = _power_body(matvec, v, eager)
    chunk = min(CHUNK, iters - eager)
    if chunk:
        v = v.clone()  # the graph's buffer
        _warm_up(lambda: _power_body(matvec, v.clone(), 1))
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            v.copy_(_power_body(matvec, v, chunk))
        for _ in range((iters - eager) // chunk):
            g.replay()
        v = _power_body(matvec, v, (iters - eager) % chunk)
    lam = _dot(v, matvec(v)) / _dot(v, v)
    return PowerResult(eigenvalue=lam, eigenvector=v)
