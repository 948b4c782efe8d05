"""A bounded profiled span and what the device did in it.

torch.profiler (CUPTI) over a short steady stretch after the window, kept
in memory: the device operations (kernels, copies, fills) with their
times, the span's length on the host clock, and the host activity during
each stretch of device idleness.
"""
from __future__ import annotations

import dataclasses
import re
import time
from collections import defaultdict
from typing import Callable, List, Tuple

import numpy as np
import torch

#: idle gaps labelled by host activity: the longest this many
LABELLED_GAPS = 500


@dataclasses.dataclass
class Trace:
    window_s: float  # the span's length
    busy_s: float  # seconds in which some device operation ran
    ops: int  # products, or CG iterations, in the span
    kernels: int  # kernel launches seen on the device
    device_s: float  # summed time of the device operations
    device_ops: List[Tuple[str, float]]  # the 10 that took most time, by name
    idle_gaps: List[Tuple[str, float]]  # the 10 longest, by host activity


def sync(device) -> None:
    """Wait for the device (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile(fn: Callable[[], int], device) -> Trace:
    """Run fn once under torch.profiler (torch's host operations, the CUDA
    API calls and the device), from an idle device to an idle device; fn
    returns what it did (products, or CG iterations), for the ratios."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ops = fn()
        sync(device)
        window_s = time.perf_counter() - t0
    return summarize(prof.events(), ops, window_s)


def short_name(name: str) -> str:
    """A kernel's name without its return type and namespaces, cut to 160
    characters (torch's template arguments name the functor early)."""
    name = re.sub(r"^void ", "", name)
    for ns in ("(anonymous namespace)::", "at::native::", "at::"):
        name = name.replace(ns, "")
    return name[:160]


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def summarize(events, ops: int, window_s: float) -> Trace:
    dev = [e for e in events if _is_device(e)]
    by_name = defaultdict(float)
    for e in dev:
        by_name[short_name(e.name)] += (e.time_range.end - e.time_range.start) * 1e-6
    iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, gaps, cursor = 0.0, [], None
    for a, b in iv:  # merge the intervals; the holes between them are idle
        if cursor is not None and a > cursor:
            gaps.append((cursor, a))
        if cursor is None or b > cursor:
            busy += b - (a if cursor is None else max(a, cursor))
            cursor = b
    busy_s = busy * 1e-6
    return Trace(
        window_s=window_s,
        busy_s=busy_s,
        ops=ops,
        kernels=sum(_is_kernel(e.name) for e in dev),
        device_s=sum(by_name.values()),
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=_label_gaps(gaps, events, window_s - busy_s),
    )


def _label_gaps(gaps, events, idle_s: float) -> List[Tuple[str, float]]:
    """Idle seconds by the innermost host range open at each gap's middle
    (the longest LABELLED_GAPS gaps between device operations; the shorter
    ones summed as one entry, and the span's ends before the first and
    after the last device operation as another)."""
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    totals = defaultdict(float)
    for a, b in gaps[:LABELLED_GAPS]:
        mid = 0.5 * (a + b)
        open_ = np.flatnonzero((starts <= mid) & (ends >= mid))
        label = host[open_[np.argmax(starts[open_])]].name if open_.size else "no host range"
        totals[label] += (b - a) * 1e-6
    rest = sum(b - a for a, b in gaps[LABELLED_GAPS:]) * 1e-6
    if rest:
        totals[f"shorter gaps ({len(gaps) - LABELLED_GAPS})"] += rest
    ends_s = idle_s - sum(b - a for a, b in gaps) * 1e-6
    if ends_s > 0:
        totals["span start and end"] += ends_s
    return sorted(totals.items(), key=lambda kv: -kv[1])[:10]
