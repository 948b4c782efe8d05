"""Dense vector I/O and random generation.

Capability analog of the reference's vector utilities
(reference: src/commons/utils.c — readDoubleVector/readDoubleVectorStr
incremental-realloc readers, writeDoubleVector[AsStr] dumpers utils.c:135-168,
fillRndVector utils.c:351-359 generating values bounded by MAXRND from
/dev/urandom).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import MAXRND


def fill_rnd_vector(n: int, seed: Optional[int] = None) -> np.ndarray:
    """Random vector with entries in (-MAXRND, MAXRND).

    The magnitude cap bounds accumulation-order FP error so kernel outputs
    stay within the oracle tolerance (reference utils.c:351-359 uses
    sin(urandom)*MAXRND; we use a seeded PRNG for reproducibility, or OS
    entropy when seed is None, matching the reference's /dev/urandom).
    """
    if seed is None:
        seed = int.from_bytes(os.urandom(8), "little")
    rng = np.random.default_rng(seed)
    return ((rng.random(n) * 2.0) - 1.0) * MAXRND


def write_vector_raw(path: str, v: np.ndarray) -> None:
    """Binary float64 dump (writeDoubleVector analog, utils.c:135-147)."""
    np.asarray(v, dtype=np.float64).tofile(path)


def read_vector_raw(path: str) -> np.ndarray:
    """Binary float64 read of unknown length (readDoubleVector analog)."""
    return np.fromfile(path, dtype=np.float64)


def write_vector_str(path: str, v: np.ndarray) -> None:
    """Text dump, one value per line (writeDoubleVectorAsStr analog)."""
    np.savetxt(path, np.asarray(v, dtype=np.float64), fmt="%.17g")


def read_vector_str(path: str) -> np.ndarray:
    """Text read of unknown length (readDoubleVectorStr analog,
    incremental growth replaced by one-shot loadtxt)."""
    v = np.loadtxt(path, dtype=np.float64)
    return np.atleast_1d(v)


def read_vector(path: str) -> np.ndarray:
    """Read a vector, sniffing text vs raw binary format."""
    try:
        return read_vector_str(path)
    except ValueError:
        return read_vector_raw(path)
