"""Runtime environment introspection.

Counterpart of spmv_openmp_cuda_tpu/utils/envinfo.py (reference: the OMP
ICV dump, ompGetICV.c:23-73, and the env-check programs, test/ompChecks):
report the torch build, the CUDA devices and the config env overrides in
effect.
"""
from __future__ import annotations

import os
from typing import Dict

import torch


def env_overrides() -> Dict[str, str]:
    keys = [
        "GRID_ROWS", "GRID_COLS", "BLOCK_ROWS", "BLOCK_WIDTH",
        "PALLAS_BLOCK_N", "SPMV_DTYPE", "AVG_TIMES_ITERATION",
        "SPMV_SCHEDULE", "SPMV_ROWLENS", "SPMV_SIMD", "TMPDIR",
        "CUDA_VISIBLE_DEVICES", "CUDA_HOME",
    ]
    return {k: os.environ[k] for k in keys if k in os.environ}


def runtime_info() -> Dict[str, object]:
    cuda = torch.cuda.is_available()
    info: Dict[str, object] = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] if cuda else [],
        "cpu_threads": torch.get_num_threads(),
        "env_overrides": env_overrides(),
    }
    if cuda:
        props = torch.cuda.get_device_properties(0)
        info["device_kind"] = props.name
        info["capability"] = f"sm_{props.major}{props.minor}"
        info["sm_count"] = props.multi_processor_count
        info["hbm_bytes"] = props.total_memory
    return info


def format_info() -> str:
    return "\n".join(f"{k}: {v}" for k, v in runtime_info().items())


if __name__ == "__main__":
    print(format_info())
