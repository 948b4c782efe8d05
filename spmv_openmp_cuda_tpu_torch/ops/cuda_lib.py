"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface. It is compiled with nvcc
for sm_90a into a shared library under the package's `_build/` directory
(listed in .gitignore) at first use, and loaded with ctypes. The library's
file name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing is built at import
time: a machine without nvcc or a GPU imports this module freely.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Tuple

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the CUDA "
        "kernels are built from csrc/ at first use and need the CUDA toolkit"
    )


def build(name: str) -> Tuple[str, str]:
    """Compile csrc/<name>.cu unless this source was already built.

    Returns (library path, nvcc output). The output holds ptxas's
    register, shared-memory and spill report for every kernel.
    """
    src = SRC_DIR / f"{name}.cu"
    tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}_{tag.hexdigest()[:12]}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        log_tmp = log.with_name(f"{log.name}.{os.getpid()}.tmp")
        log_tmp.write_text(proc.stdout + proc.stderr)
        os.replace(log_tmp, log)
        os.replace(tmp, lib)
    return str(lib), log.read_text()


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; `bind` declares the C
    functions' argtypes and restype once."""
    if name not in _LIBS:
        path, _ = build(name)
        lib = ctypes.CDLL(path)
        bind(lib)
        _LIBS[name] = lib
    return _LIBS[name]
