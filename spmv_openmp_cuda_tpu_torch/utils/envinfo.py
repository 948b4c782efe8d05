"""Runtime environment introspection.

Counterpart of spmv_openmp_cuda_tpu/utils/envinfo.py (reference: the OMP
ICV dump, ompGetICV.c:23-73, and the env-check programs, test/ompChecks):
report the torch build, the CUDA devices, the config env overrides in
effect and whether the native host library (io/native.py) is in use.
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
        "CUDA_VISIBLE_DEVICES", "CUDA_HOME", "CXX",
    ]
    return {k: os.environ[k] for k in keys if k in os.environ}


def runtime_info() -> Dict[str, object]:
    import torch.distributed as dist

    from ..io import native

    cuda = torch.cuda.is_available()
    group = dist.is_available() and dist.is_initialized()
    info: Dict[str, object] = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        # this process's rank and the processes of its torch.distributed
        # group (jax.process_index / process_count): 0 and 1 without one
        "process_index": dist.get_rank() if group else 0,
        "process_count": dist.get_world_size() if group else 1,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] if cuda else [],
        "cpu_threads": torch.get_num_threads(),
        "env_overrides": env_overrides(),
        # builds the library at first use; the numpy prepares run without it
        "native_available": native.available(),
        "native_library": str(native.library_path()) if native.available() else native.failure(),
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
