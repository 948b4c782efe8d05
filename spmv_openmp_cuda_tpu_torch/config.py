"""Run configuration for the PyTorch/CUDA SpMV port.

Counterpart of spmv_openmp_cuda_tpu/config.py: the same constants and the
same Config dataclass with environment-variable overrides (reference:
src/include/config.h:21-32 CONFIG struct, config.h:38-119 macros,
utils.c:279-302 env overrides). Only the dtype mapping changes: torch dtypes
in place of jnp dtypes.
"""
from __future__ import annotations

import dataclasses
import os

import torch

#: Max padded (2 * M * max_row_nz) entries allowed for an ELL materialization
#: (reference: config.h:69-70 ELL_MAX_ENTRIES = 6 << 27, parser.c:223-232).
ELL_MAX_ENTRIES: int = 6 << 27

#: Absolute elementwise tolerance for oracle comparison
#: (reference: config.h:113 DOUBLE_DIFF_THREASH).
DOUBLE_DIFF_THRESH: float = 7e-4

#: Random vectors are capped at this magnitude so accumulation-order FP error
#: stays within tolerance (reference: config.h:115 MAXRND).
MAXRND: float = 3e-5

#: Default number of timed repetitions per kernel in the bench harness
#: (reference: config.h:83-85 AVG_TIMES_ITERATION).
AVG_TIMES_ITERATION: int = 5

#: Fair chunk folding factor for the dynamic-schedule analog
#: (reference: config.h:87-89 FAIR_CHUNKS_FOLDING).
FAIR_CHUNKS_FOLDING: int = 4

#: Default random vector size when no matrix dictates one
#: (reference: config.h:76 RNDVECTORSIZE).
RNDVECTORSIZE: int = 100_000

#: Row-layout width shared with the JAX package: the DIA slab is laid out as
#: (S, 128) row groups, so prepared operands are interchangeable.
LANE: int = 128

#: Row-group granularity of the JAX package's block plans.
SUBLANE: int = 8

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


@dataclasses.dataclass
class Config:
    """One run's configuration (reference CONFIG struct analog).

    The fields are those of the JAX package's Config, so the same
    environment overrides apply to both packages.
    """

    grid_rows: int = 8
    grid_cols: int = 8
    block_rows: int = 256
    block_width: int = 128
    pallas_block_n: int = 2048
    #: Compute dtype: float32, or float64 for the double-float engines
    #: (SPMV_DTYPE overrides).
    dtype: str = "float32"
    avg_times_iteration: int = AVG_TIMES_ITERATION
    schedule: str = "static"
    chunk_folding: int = FAIR_CHUNKS_FOLDING
    row_lens: bool = True
    simd_reduction: bool = True
    ell_max_entries: int = ELL_MAX_ENTRIES
    #: Dump directory for output vectors (reference TMPDIR, config.h:116-119).
    tmpdir: str = "/tmp"
    seed: int = 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        """Build a Config applying env-var overrides (getConfig analog,
        utils.c:279-302)."""
        cfg = cls(**overrides)
        env_map = {
            "GRID_ROWS": ("grid_rows", int),
            "GRID_COLS": ("grid_cols", int),
            "BLOCK_ROWS": ("block_rows", int),
            "BLOCK_WIDTH": ("block_width", int),
            "PALLAS_BLOCK_N": ("pallas_block_n", int),
            "SPMV_DTYPE": ("dtype", str),
            "AVG_TIMES_ITERATION": ("avg_times_iteration", int),
            "SPMV_SCHEDULE": ("schedule", str),
            "SPMV_ROWLENS": ("row_lens", lambda s: s not in ("0", "false", "False")),
            "SPMV_SIMD": ("simd_reduction", lambda s: s not in ("0", "false", "False")),
            "TMPDIR": ("tmpdir", str),
        }
        for env, (field, conv) in env_map.items():
            val = os.environ.get(env)
            if val is not None:
                setattr(cfg, field, conv(val))
        return cfg


DEFAULT_CONFIG = Config()
