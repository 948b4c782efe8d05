"""The general traffic generator: one caller in a closed loop, as a traffic
file describes it.

- `"op": "product"`: products y = A x back to back over a pool of `x_pool`
  vectors. With `"sync_each": false` the caller dispatches ahead and the
  window closes at a synchronize; with true each product is followed by a
  synchronize and timed from its call to the synchronize's return.
- `"op": "solve"`: whole solves of A x = b from x0 = 0, b = A x* over a
  pool of `rhs_pool` right-hand sides, with the configuration's solver
  settings.

The window runs whole operations until `seconds` have passed; its length
is taken from its start to the end of its last operation, all work
included. A sample of the answers, drawn from the seed, is kept for the
check (every solve's).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import inputs, reference, trace
from .inputs import Matrix
from .trace import sync


@dataclasses.dataclass
class Window:
    seconds: float
    attempted: int
    failed: int
    #: (pool index of the input, the answer) of the operations kept
    answers: List[Tuple[int, torch.Tensor]]
    call_s: Optional[np.ndarray] = None  # host time in the call, per product
    sync_s: Optional[np.ndarray] = None  # call to synchronize, per product
    iters: Optional[np.ndarray] = None  # iterations, per solve
    solve_s: Optional[np.ndarray] = None  # host time, per solve


class Products:
    def __init__(self, system, matrix: Matrix, traffic: dict, seed: int, device):
        self.system, self.traffic, self.seed, self.device = system, traffic, seed, device
        self.sync_each = bool(traffic["sync_each"])
        self.xs = inputs.vectors(seed, "x", traffic["x_pool"], matrix.shape[1], matrix.dtype, device)
        self.per_op_s = None

    def _run(self, count: int) -> None:
        product, xs, sync_each, dev = self.system.product, self.xs, self.sync_each, self.device
        for i in range(count):
            product(xs[i % len(xs)])
            if sync_each:
                sync(dev)
        sync(dev)

    def warm(self) -> None:
        """Every vector of the pool through the product, then a timed
        stretch that estimates the window's operation count."""
        self._run(2 * len(self.xs))
        count = self.traffic["warm_products"]
        t = time.perf_counter()
        self._run(count)
        self.per_op_s = (time.perf_counter() - t) / count

    def window(self, seconds: float) -> Window:
        product, xs, dev = self.system.product, self.xs, self.device
        expected = int(0.9 * seconds / self.per_op_s)
        keep = set(inputs.sample_indices(self.seed, self.traffic["samples"], expected).tolist())
        answers, call_s, sync_s = [], [], []
        sync(dev)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        if self.sync_each:
            while True:
                x = xs[i % len(xs)]
                ta = time.perf_counter()
                y = product(x)
                tb = time.perf_counter()
                sync(dev)
                tc = time.perf_counter()
                call_s.append(tb - ta)
                sync_s.append(tc - ta)
                if i in keep:
                    answers.append((i % len(xs), y))
                i += 1
                if tc >= deadline:
                    break
        else:
            while True:
                y = product(xs[i % len(xs)])
                if i in keep:
                    answers.append((i % len(xs), y))
                i += 1
                if time.perf_counter() >= deadline:
                    break
        if i - 1 not in keep:
            answers.append(((i - 1) % len(xs), y))
        sync(dev)
        t1 = time.perf_counter()
        return Window(
            seconds=t1 - t0,
            attempted=i,
            failed=0,
            answers=answers,
            call_s=np.array(call_s) if self.sync_each else None,
            sync_s=np.array(sync_s) if self.sync_each else None,
        )

    def profile(self) -> trace.Trace:
        count = self.traffic["trace_products"]

        def span():
            self._run(count)
            return count

        return trace.profile(span, self.device)

    def check(self, matrix: Matrix, answers) -> dict:
        """The largest row error of the kept products against the float64
        reference (one reference product per vector of the pool)."""
        worst = 0.0
        for j in sorted({j for j, _ in answers}):
            x = inputs.host(self.xs[j])
            ref = reference.product(matrix.indptr, matrix.cols, matrix.data, x)
            scale = reference.abs_product(matrix.indptr, matrix.cols, matrix.data, x)
            for k, y in answers:
                if k == j:
                    worst = max(worst, reference.product_error(y, ref, scale))
        return {"y_err": worst}


class Solves:
    def __init__(self, system, matrix: Matrix, traffic: dict, seed: int, device, solver: dict):
        self.system, self.traffic, self.device = system, traffic, device
        self.rtol, self.maxiter = float(solver["rtol"]), int(solver["maxiter"])
        sol = inputs.vectors(seed, "solution", traffic["rhs_pool"], matrix.shape[1], matrix.dtype, device)
        # b = A x* by the reference, on the host: the inputs are the benchmark's
        xs = np.stack([inputs.host(s) for s in sol], axis=1)
        bs = reference.product(matrix.indptr, matrix.cols, matrix.data, xs)
        self.bs = [
            torch.from_numpy(np.ascontiguousarray(bs[:, j])).to(device=device, dtype=inputs.DTYPES[matrix.dtype])
            for j in range(bs.shape[1])
        ]

    def _solve(self, j: int):
        return self.system.solve(self.bs[j % len(self.bs)], self.rtol, self.maxiter)

    def warm(self) -> None:
        for _ in range(self.traffic["warm_solves"]):
            self._solve(0)
        sync(self.device)

    def window(self, seconds: float) -> Window:
        runs = []
        sync(self.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        j = 0
        ends = [t0]
        while True:
            x, iters, relres = self._solve(j)
            runs.append((j % len(self.bs), x, iters, relres))
            j += 1
            ends.append(time.perf_counter())
            if ends[-1] >= deadline:
                break
        sync(self.device)
        t1 = time.perf_counter()
        iters = np.array([int(r[2]) for r in runs])
        # a solve that stopped at maxiter above its tolerance failed
        failed = sum(int(r[2]) >= self.maxiter and float(r[3]) > self.rtol for r in runs)
        return Window(
            seconds=t1 - t0,
            attempted=j,
            failed=failed,
            answers=[(r[0], r[1]) for r in runs],
            iters=iters,
            solve_s=np.diff(ends),
        )

    def profile(self) -> trace.Trace:
        count = self.traffic["trace_solves"]

        def span():
            return sum(int(self._solve(j)[1]) for j in range(count))

        return trace.profile(span, self.device)

    def check(self, matrix: Matrix, answers) -> dict:
        """The largest true relative residual ||b - A x|| / ||b|| of the
        window's solves, recomputed in float64."""
        worst = 0.0
        for j, x in answers:
            b = inputs.host(self.bs[j])
            worst = max(worst, reference.relres(matrix.indptr, matrix.cols, matrix.data, x, b))
        return {"x_relres": worst}


def make_traffic(system, matrix: Matrix, config: dict, traffic: dict, seed: int, device):
    if traffic["op"] == "product":
        return Products(system, matrix, traffic, seed, device)
    if traffic["op"] == "solve":
        return Solves(system, matrix, traffic, seed, device, config["solver"])
    raise ValueError(f"unknown traffic op {traffic['op']!r}")
