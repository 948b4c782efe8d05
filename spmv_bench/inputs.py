"""A run's inputs: the configuration's matrix and the vectors of its traffic.

The sparsity pattern comes from the configuration's fixed `structure_seed`
(a deployment holds one matrix); the values, the vectors and the sample of
answers to check come from the run's --seed, each on a random stream of its
own. Values and vectors are drawn on the run's device, at the
configuration's precision, so the program and the reference are handed the
same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from . import generators
from .reference import csr_indptr

DTYPES = {"float32": torch.float32, "float64": torch.float64}
#: the random streams drawn from one --seed
STREAMS = {"values": 1, "x": 2, "solution": 3, "sample": 4}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for the stream of that name, from any whole --seed."""
    state = np.random.SeedSequence([seed % 2**64, STREAMS[stream]]).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


@dataclasses.dataclass
class Matrix:
    """The configuration's matrix: CSR arrays on the host, the values in
    float64 holding exactly the configuration-precision numbers."""

    shape: tuple
    indptr: np.ndarray
    cols: np.ndarray
    data: np.ndarray
    dtype: str

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])


def make_matrix(config: dict, seed: int, device) -> Matrix:
    gen = generators.load(config["generator"])
    shape, rows, cols, vals = gen.pattern(config["structure_seed"], **config["params"])
    dtype = config["dtype"]
    if vals is None or callable(vals):  # drawn from the seed, at the configuration's precision
        g = generator(seed, "values", device)
        if vals is None:
            vals = torch.randn(rows.shape[0], generator=g, device=device, dtype=DTYPES[dtype])
        else:
            vals = vals(g, DTYPES[dtype], device)
        vals = vals.to(torch.float64).cpu().numpy()
    else:
        vals = torch.from_numpy(np.asarray(vals, dtype=np.float64)).to(DTYPES[dtype]).to(torch.float64).numpy()
    return Matrix(
        shape=tuple(shape),
        indptr=csr_indptr(shape[0], rows),
        cols=np.ascontiguousarray(cols, dtype=np.int64),
        data=vals,
        dtype=dtype,
    )


def vectors(seed: int, stream: str, count: int, n: int, dtype: str, device) -> List[torch.Tensor]:
    """`count` vectors ~ N(0, 1) of length n, each a tensor of its own."""
    g = generator(seed, stream, device)
    return [torch.randn(n, generator=g, device=device, dtype=DTYPES[dtype]) for _ in range(count)]


def sample_indices(seed: int, count: int, expected: int) -> np.ndarray:
    """`count` distinct indices in [0, expected), 0 among them: the answers
    of the window checked, besides its last."""
    rng = np.random.default_rng(stream_seed(seed, "sample"))
    pool = np.arange(1, max(expected, 1))
    picked = rng.choice(pool, size=min(max(count - 1, 0), pool.size), replace=False)
    return np.unique(np.r_[0, picked]).astype(np.int64)


def host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()
