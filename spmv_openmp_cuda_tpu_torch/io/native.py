"""ctypes bindings to the native C++ host backend (native/spmv_native.cpp).

Counterpart of spmv_openmp_cuda_tpu/io/native.py: MatrixMarket parse and the
COO -> CSR/ELL conversions (the reference's C ingestion layer, mmio.c +
parser.c), and the threaded prepare passes of the routed and window engines
(the Euler-split edge coloring of ops/route.py, the window scan, rank and
slot fill of formats/window.py). Every function returns None (False for the
fill) when the library is not available, and its caller runs the numpy path
it has always had, the JAX package's own fallbacks.

The port builds the repository's own native/spmv_native.cpp with g++ at
first use, into the package's `_build/` directory (listed in .gitignore),
never into native/ (the JAX package loads native/libspmv_native.so when it
is built there). The library's file name carries a hash of the source, the
flags and the host CPU (-march=native), so an edited source or another CPU
gets its own build; it is written under a temporary name and renamed, so
concurrent builds never load a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from ..formats.matrix import COOMatrix, CSRMatrix, ELLMatrix

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "spmv_native.cpp"
BUILD_DIR = _PKG / "_build"
#: native/Makefile's flags, plus -shared
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-fopenmp", "-shared")
#: spmv_native_abi_version() of the source these bindings declare
ABI_VERSION = 4

_ERRORS = {
    1: "invalid MatrixMarket banner",
    2: "unsupported matrix type (dense/complex/skew?)",
    3: "invalid size line",
    4: "invalid entry",
    5: "entry count mismatch with header",
    6: "entry index out of bounds",
    7: "allocation failure",
}

_I64 = ctypes.c_int64
_P64 = ctypes.POINTER(ctypes.c_int64)
_PF64 = ctypes.POINTER(ctypes.c_double)
_P32 = ctypes.POINTER(ctypes.c_int32)
_P8 = ctypes.POINTER(ctypes.c_int8)


class _SpmvCoo(ctypes.Structure):
    _fields_ = [
        ("m", ctypes.c_int64),
        ("n", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("rows", _P64),
        ("cols", _P64),
        ("vals", _PF64),
        ("row_lens", _P64),
    ]


#: the loaded library, or the reason it is not available
_lib: Optional[ctypes.CDLL] = None
_failure: Optional[str] = None


def _cpu_tag() -> bytes:
    """The host CPU's model and flags: -march=native code runs only there."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return os.uname().machine.encode()
    keep = [ln for ln in text.splitlines() if ln.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode()


def library_path() -> Path:
    """Where this source, these flags and this CPU's build lives."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + _cpu_tag())
    return BUILD_DIR / f"libspmv_native_{tag.hexdigest()[:12]}.so"


def compilers() -> list:
    """The C++ compilers to try, in order: $CXX, g++ on PATH, the system's
    /usr/bin/g++ (a toolchain's g++ may lack OpenMP's runtime)."""
    found = [os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++"]
    return [c for i, c in enumerate(found) if c and os.path.exists(c) and c not in found[:i]]


def build() -> Path:
    """Compile native/spmv_native.cpp unless this build exists, with the
    first compiler that succeeds; raises RuntimeError when none does."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    errors = []
    for cxx in compilers():
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True
        )
        if proc.returncode == 0:
            os.replace(tmp, lib)
            return lib
        errors.append(f"{cxx} (exit {proc.returncode}): {proc.stdout}{proc.stderr}")
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"no C++ compiler built {SOURCE}: " + ("; ".join(errors) or "none found"))


def _bind(lib: ctypes.CDLL) -> None:
    sigs = {
        "spmv_native_abi_version": (ctypes.c_int, []),
        "spmv_parse_mtx": (ctypes.c_int, [ctypes.c_char_p, _I64, ctypes.POINTER(_SpmvCoo)]),
        "spmv_free_coo": (None, [ctypes.POINTER(_SpmvCoo)]),
        "spmv_coo_to_csr": (ctypes.c_int, [_I64, _I64, _P64, _P64, _PF64, _P64, _P64, _P64, _PF64]),
        "spmv_coo_to_ell": (ctypes.c_int, [_I64, _I64, _P64, _P64, _PF64, _I64, _P64, _PF64]),
        "spmv_color_bipartite": (ctypes.c_int, [_I64, _P64, _P64, _I64, _I64, ctypes.c_int, _P64]),
        "spmv_window_scan": (ctypes.c_int, [_I64, _P64, _P64, _P64, _P64, _I64, _I64, _P64, _P64,
                                            _P32, _P32]),
        "spmv_rank_in_group": (ctypes.c_int, [_I64, _P64, _I64, _I64, _P64]),
        "spmv_window_fill": (ctypes.c_int, [_I64, _P64, _P64, _P64, _P64, _P64, _PF64, _I64, _I64,
                                            _I64, _I64, _I64, _I64, ctypes.c_int, _PF64, _P8, _P8,
                                            _P8]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def load_library() -> Optional[ctypes.CDLL]:
    """The library, built at first use; None when it cannot be built or
    loaded (the reason is kept, `failure()`)."""
    global _lib, _failure
    if _lib is not None or _failure is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
        _bind(lib)
        abi = lib.spmv_native_abi_version()
        if abi != ABI_VERSION:
            raise RuntimeError(f"native ABI version {abi}, expected {ABI_VERSION}")
        _lib = lib
    except (OSError, RuntimeError, AttributeError) as e:
        _failure = str(e)
    return _lib


def available() -> bool:
    return load_library() is not None


def failure() -> Optional[str]:
    """Why the library is not in use (None when it is, or not tried)."""
    return _failure


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_P64)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def parse_mtx_bytes(data: bytes) -> COOMatrix:
    """Parse a MatrixMarket body (already decompressed) natively."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native library not available ({failure()})")
    out = _SpmvCoo()
    rc = lib.spmv_parse_mtx(data, len(data), ctypes.byref(out))
    if rc != 0:
        raise ValueError(f"native parse failed: {_ERRORS.get(rc, rc)}")
    try:
        nnz, m = int(out.nnz), int(out.m)
        rows = np.ctypeslib.as_array(out.rows, shape=(nnz,)).copy() if nnz else np.empty(0, np.int64)
        cols = np.ctypeslib.as_array(out.cols, shape=(nnz,)).copy() if nnz else np.empty(0, np.int64)
        vals = np.ctypeslib.as_array(out.vals, shape=(nnz,)).copy() if nnz else np.empty(0, np.float64)
        rl = np.ctypeslib.as_array(out.row_lens, shape=(max(m, 1),))[:m].copy()
    finally:
        lib.spmv_free_coo(ctypes.byref(out))
    return COOMatrix((m, int(out.n)), rows, cols, vals, row_lens=rl)


def read_coo_native(path: str) -> COOMatrix:
    """File -> sorted COO via the native parser (decompression in Python).
    The entries go through sort_coo so that duplicate merging matches the
    pure-Python reader exactly."""
    from ..formats.convert import sort_coo
    from .mmio import _open_maybe_compressed

    with _open_maybe_compressed(path) as f:
        data = f.read()
    out = sort_coo(parse_mtx_bytes(data))
    out.row_lens = None  # merged duplicates may change lengths: recompute
    out.compute_row_lens()
    return out


def coo_to_csr_native(coo: COOMatrix) -> CSRMatrix:
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native library not available ({failure()})")
    m = coo.shape[0]
    rl = coo.compute_row_lens().astype(np.int64)
    indptr = np.zeros(m + 1, dtype=np.int64)
    indices = np.zeros(coo.nnz, dtype=np.int64)
    data = np.zeros(coo.nnz, dtype=np.float64)
    rows, cols = _i64(coo.rows), _i64(coo.cols)
    vals = np.ascontiguousarray(coo.vals, dtype=np.float64)
    rc = lib.spmv_coo_to_csr(
        m, coo.nnz, _p64(rows), _p64(cols), vals.ctypes.data_as(_PF64), _p64(rl),
        _p64(indptr), _p64(indices), data.ctypes.data_as(_PF64),
    )
    if rc != 0:
        raise ValueError(f"native COO->CSR failed: {_ERRORS.get(rc, rc)}")
    return CSRMatrix(coo.shape, indptr, indices, data, row_lens=rl)


_CAP_DEFAULT = object()  # sentinel: "apply the default ELL cap"


def coo_to_ell_native(coo: COOMatrix, max_entries=_CAP_DEFAULT) -> ELLMatrix:
    """max_entries=None disables the cap, as in convert.coo_to_ell."""
    from ..config import ELL_MAX_ENTRIES
    from ..formats.convert import EllSizeError

    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native library not available ({failure()})")
    m = coo.shape[0]
    rl = coo.compute_row_lens().astype(np.int64)
    w = int(rl.max(initial=0))
    cap = ELL_MAX_ENTRIES if max_entries is _CAP_DEFAULT else max_entries
    if cap is not None and 2 * m * w > cap:
        raise EllSizeError(f"ELL padded entries 2*{m}*{w} exceed cap {cap}")
    wa = max(w, 1)
    ja = np.zeros((m, wa), dtype=np.int64)
    data = np.zeros((m, wa), dtype=np.float64)
    rows, cols = _i64(coo.rows), _i64(coo.cols)
    vals = np.ascontiguousarray(coo.vals, dtype=np.float64)
    rc = lib.spmv_coo_to_ell(
        m, coo.nnz, _p64(rows), _p64(cols), vals.ctypes.data_as(_PF64), wa,
        _p64(ja), data.ctypes.data_as(_PF64),
    )
    if rc != 0:
        raise ValueError(f"native COO->ELL failed: {_ERRORS.get(rc, rc)}")
    return ELLMatrix(coo.shape, ja, data, max_row_nz=w, nnz=coo.nnz, row_lens=rl)


def color_bipartite_native(
    left: np.ndarray, right: np.ndarray, n_colors: int
) -> Optional[np.ndarray]:
    """Edge-color a bipartite multigraph with the native Euler-split router
    (ops/route.py's planning core). None when the library is not available
    or refuses the graph (the caller runs the numpy coloring)."""
    lib = load_library()
    if lib is None:
        return None
    e = left.shape[0]
    left, right = _i64(left), _i64(right)
    out = np.empty(e, dtype=np.int64)
    bits = int(n_colors).bit_length() - 1
    rc = lib.spmv_color_bipartite(
        e, _p64(left), _p64(right),
        int(left.max()) + 1 if e else 1, int(right.max()) + 1 if e else 1,
        bits, _p64(out),
    )
    return out if rc == 0 else None


def window_scan_native(rq, lane, q, jres, g: int, nblocks: int):
    """The fused per-g window-prepare scan (formats/window.py): (d_min,
    d_max, hl, hr), hl/hr the (nblocks, 8, 128) int32 per-(block, gid % 8)
    lane/residue degree histograms. None when the library is not available
    (the caller runs the numpy passes)."""
    lib = load_library()
    if lib is None:
        return None
    arrs = [_i64(a) for a in (rq, lane, q, jres)]
    hl = np.empty((nblocks, 8, 128), dtype=np.int32)
    hr = np.empty((nblocks, 8, 128), dtype=np.int32)
    d_min, d_max = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.spmv_window_scan(
        arrs[0].shape[0], *(_p64(a) for a in arrs), g, nblocks,
        ctypes.byref(d_min), ctypes.byref(d_max), hl.ctypes.data_as(_P32), hr.ctypes.data_as(_P32),
    )
    if rc != 0:
        return None
    return int(d_min.value), int(d_max.value), hl, hr


def rank_in_group_native(key: np.ndarray, stride: int, nblocks: int) -> Optional[np.ndarray]:
    """Stable rank within equal keys, for keys whose key // stride prefix is
    non-decreasing (CSR row order): the O(n) threaded pass that replaces
    the argsort of formats/window.py. None when the library is not
    available."""
    lib = load_library()
    if lib is None:
        return None
    key = _i64(key)
    out = np.empty(key.shape[0], dtype=np.int64)
    rc = lib.spmv_rank_in_group(key.shape[0], _p64(key), stride, nblocks, _p64(out))
    return out if rc == 0 else None


def window_fill_native(
    rq, lane, q, jres, srow, data, g: int, k_pad: int, k_c: int, n_ktiles: int, wr: int,
    bps: int, mode: int, vals: np.ndarray, sidx: np.ndarray, gslab: np.ndarray,
    rsrc: np.ndarray,
) -> bool:
    """The slot-slab scatter and Q bake of prepare_window in one threaded
    pass (the packing guarantees distinct cells); mode 0 standard, 1
    xdirect, 2 shared_w. False when the library is not available (the
    caller runs the numpy scatters)."""
    lib = load_library()
    if lib is None:
        return False
    arrs = [_i64(a) for a in (rq, lane, q, jres, srow)]
    data = np.ascontiguousarray(data, dtype=np.float64)
    for a, dt in ((vals, np.float64), (sidx, np.int8), (gslab, np.int8), (rsrc, np.int8)):
        if not a.flags.c_contiguous or a.dtype != dt:
            raise ValueError("window_fill_native fills C-contiguous float64/int8 slabs")
    rc = lib.spmv_window_fill(
        arrs[0].shape[0], *(_p64(a) for a in arrs), data.ctypes.data_as(_PF64),
        g, k_pad, k_c, n_ktiles, wr, max(bps, 1), mode,
        vals.ctypes.data_as(_PF64), sidx.ctypes.data_as(_P8), gslab.ctypes.data_as(_P8),
        rsrc.ctypes.data_as(_P8),
    )
    return rc == 0
