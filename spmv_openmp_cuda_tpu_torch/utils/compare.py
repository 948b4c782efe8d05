"""Tolerance-based vector comparison and statistics.

Analog of the reference's doubleVectorsDiff (utils.c:362-393, absolute
tolerance DOUBLE_DIFF_THREASH against the oracle) and statsAvgVar
(utils.c:340-348).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from ..config import DOUBLE_DIFF_THRESH


@dataclasses.dataclass
class DiffReport:
    ok: bool
    max_abs_diff: float
    num_exceeding: int
    first_bad_index: int = -1


def vectors_diff(
    a: np.ndarray,
    b: np.ndarray,
    threshold: float = DOUBLE_DIFF_THRESH,
) -> DiffReport:
    """Elementwise |a-b| <= threshold check (doubleVectorsDiff analog).

    Returns a report rather than early-exiting so harness logs can show the
    worst offender (the reference optionally early-exits via
    DOUBLE_VECT_DIFF_EARLY_EXIT, config.h:73).
    """
    a = np.asarray(a, dtype=np.float64).ravel()
    b = np.asarray(b, dtype=np.float64).ravel()
    if a.shape != b.shape:
        return DiffReport(False, float("inf"), max(a.size, b.size))
    diff = np.abs(a - b)
    # NaN must count as bad: `nan > t` is False, so test the complement
    bad = ~(diff <= threshold)
    nbad = int(bad.sum())
    return DiffReport(
        ok=nbad == 0,
        max_abs_diff=float(diff.max(initial=0.0)),
        num_exceeding=nbad,
        first_bad_index=int(np.argmax(bad)) if nbad else -1,
    )


def stats_avg_var(times: Sequence[float]) -> Tuple[float, float]:
    """Mean and population variance of timing samples (statsAvgVar analog)."""
    t = np.asarray(times, dtype=np.float64)
    avg = float(t.mean())
    var = float(((t - avg) ** 2).mean())
    return avg, var
