"""Timing and profiling utilities.

Counterpart of spmv_openmp_cuda_tpu/utils/profiling.py: the reference's
two-level timing (wall time around the call and ElapsedInternal inside it,
here time_per_call: CUDA events over back-to-back calls) and a trace of the
device, torch.profiler's in place of jax.profiler's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class Timings:
    """Two-level timing record (Elapsed / ElapsedInternal analog)."""

    wall: float = 0.0  # host prepare + transfer + launches
    internal: float = 0.0  # device time per call


@contextlib.contextmanager
def wall_timer(t: Timings):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t.wall = time.perf_counter() - t0


def time_per_call(f: Callable, x: torch.Tensor, min_seconds: float = 0.2) -> float:
    """Seconds per call of f(x) over a back-to-back run after warm-up: CUDA
    events on a GPU, the host clock on the CPU."""
    cuda = x.device.type == "cuda"

    def run(reps: int) -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                f(x)
            stop.record()
            torch.cuda.synchronize(x.device)
            return start.elapsed_time(stop) / 1e3
        t0 = time.perf_counter()
        for _ in range(reps):
            f(x)
        return time.perf_counter() - t0

    run(3)  # warm-up
    probe = max(run(10) / 10, 1e-7)
    reps = int(min(max(min_seconds / probe, 10), 10_000))
    return run(reps) / reps


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Record a torch.profiler trace (CPU and, with a card, CUDA activity)
    of the enclosed calls into log_dir/trace.json (chrome trace format) when
    log_dir is set; a no-op otherwise."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
