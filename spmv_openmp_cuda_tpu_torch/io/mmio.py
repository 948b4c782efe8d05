"""MatrixMarket coordinate-format I/O.

Counterpart of spmv_openmp_cuda_tpu/io/mmio.py, carried over unchanged (pure
numpy). Capability analog of the reference's vendored NIST mmio + MM->COO
parser (reference: src/lib/mmio.c banner/typecode/size parsing,
src/lib/parser.c:30-153 MMtoCOO with symmetric expansion, pattern val=1.0,
real/integer typecodes), transparent decompression of .gz/.xz/.bz2/.zip
inputs (the extractInTmpFS analog, reference utils.c:433-462), and a writer
used for test fixtures.
"""
from __future__ import annotations

import bz2
import dataclasses
import gzip
import lzma
import zipfile
from typing import IO, Optional, Tuple

import numpy as np

from ..formats.matrix import COOMatrix
from ..formats.convert import sort_coo

_BANNER = "%%MatrixMarket"

_SUPPORTED_FORMATS = {"coordinate"}
_SUPPORTED_FIELDS = {"real", "integer", "pattern"}
_SUPPORTED_SYMMETRY = {"general", "symmetric"}


@dataclasses.dataclass
class MMHeader:
    """Parsed banner + size line (mm_read_banner / mm_read_mtx_crd_size analog)."""

    object: str
    format: str
    field: str
    symmetry: str
    shape: Tuple[int, int]
    nnz_stored: int

    @property
    def is_pattern(self) -> bool:
        return self.field == "pattern"

    @property
    def is_symmetric(self) -> bool:
        return self.symmetry == "symmetric"


class MMError(ValueError):
    pass


def _open_maybe_compressed(path: str) -> IO[bytes]:
    """Transparent decompression (extractInTmpFS analog, utils.c:433-462)."""
    lower = path.lower()
    if lower.endswith(".gz"):
        return gzip.open(path, "rb")
    if lower.endswith(".xz"):
        return lzma.open(path, "rb")
    if lower.endswith(".bz2"):
        return bz2.open(path, "rb")
    if lower.endswith(".zip"):
        zf = zipfile.ZipFile(path)
        names = zf.namelist()
        if not names:
            raise MMError(f"empty zip archive: {path}")
        return zf.open(names[0])
    return open(path, "rb")


def read_header(f: IO[bytes]) -> MMHeader:
    banner = f.readline().decode("ascii", errors="replace").strip()
    parts = banner.split()
    if len(parts) < 5 or parts[0] != _BANNER:
        raise MMError(f"invalid MatrixMarket banner: {banner!r}")
    obj, fmt, field, symmetry = (p.lower() for p in parts[1:5])
    if obj != "matrix":
        raise MMError(f"invalid matrix: not a matrix (object={obj})")
    if fmt not in _SUPPORTED_FORMATS:
        # MMCheck analog (parser.c:30-44): dense/array matrices rejected.
        raise MMError(f"invalid matrix: unsupported format {fmt} (dense?)")
    if field not in _SUPPORTED_FIELDS:
        raise MMError(f"unsupported field {field}")
    if symmetry not in _SUPPORTED_SYMMETRY:
        raise MMError(f"unsupported symmetry {symmetry}")
    # skip comment/blank lines to the size line
    while True:
        line = f.readline()
        if not line:
            raise MMError("missing size line")
        s = line.decode("ascii", errors="replace").strip()
        if s and not s.startswith("%"):
            break
    dims = s.split()
    if len(dims) != 3:
        raise MMError(f"invalid size line: {s!r}")
    m, n, nz = (int(x) for x in dims)
    return MMHeader("matrix", fmt, field, symmetry, (m, n), nz)


def read_coo(path: str, sort: bool = True) -> COOMatrix:
    """Parse a .mtx[.gz|.xz|.bz2|.zip] file into sorted COO.

    Symmetric matrices are expanded: every stored off-diagonal entry is
    mirrored, matching the reference (parser.c:85-91); pattern matrices get
    val = 1.0 (parser.c:60-61). Output entries are sorted by (row, col) — the
    contract the reference enforces via CONSISTENCY_CHECKS.
    """
    with _open_maybe_compressed(path) as f:
        header = read_header(f)
        body = f.read()

    m, n = header.shape
    # Bulk-parse the numeric body.
    if header.is_pattern:
        flat = np.array(body.split(), dtype=np.float64)
        if flat.size % 2:
            raise MMError("pattern entry count not a multiple of 2")
        flat = flat.reshape(-1, 2)
        rows = flat[:, 0].astype(np.int64) - 1
        cols = flat[:, 1].astype(np.int64) - 1
        vals = np.ones(flat.shape[0], dtype=np.float64)
    else:
        toks = body.split()
        flat = np.array(toks, dtype=np.float64)
        if flat.size % 3:
            raise MMError("entry count not a multiple of 3")
        flat = flat.reshape(-1, 3)
        rows = flat[:, 0].astype(np.int64) - 1
        cols = flat[:, 1].astype(np.int64) - 1
        vals = flat[:, 2]

    if rows.shape[0] != header.nnz_stored:
        raise MMError(
            f"parsed {rows.shape[0]} entries, header promised {header.nnz_stored}"
        )
    if rows.size and (
        rows.min() < 0 or cols.min() < 0 or rows.max() >= m or cols.max() >= n
    ):
        raise MMError("entry index out of bounds")

    if header.is_symmetric:
        if m != n:
            raise MMError(f"symmetric matrix must be square, got {m}x{n}")
        off = rows != cols
        mirr_r, mirr_c = cols[off], rows[off]
        rows = np.concatenate([rows, mirr_r])
        cols = np.concatenate([cols, mirr_c])
        vals = np.concatenate([vals, vals[off]])
        # MMtoCOO asserts expanded count == 2*NZ - diagEntries (parser.c:94-97)
        assert rows.shape[0] == 2 * header.nnz_stored - int((~off).sum())

    coo = COOMatrix((m, n), rows, cols, vals)
    return sort_coo(coo) if sort else coo


def write_mtx(
    path: str,
    coo: COOMatrix,
    field: str = "real",
    symmetry: str = "general",
    comment: Optional[str] = None,
) -> None:
    """Write COO to a MatrixMarket file (fixture/writer utility).

    With symmetry="symmetric", only lower-triangle (incl. diagonal) entries
    are written; callers must pass a symmetric matrix.
    """
    rows, cols, vals = coo.rows, coo.cols, coo.vals
    if symmetry == "symmetric":
        keep = rows >= cols
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    lines = [f"{_BANNER} matrix coordinate {field} {symmetry}\n"]
    if comment:
        lines.append(f"%{comment}\n")
    lines.append(f"{coo.shape[0]} {coo.shape[1]} {rows.shape[0]}\n")
    if field == "pattern":
        for r, c in zip(rows, cols):
            lines.append(f"{r + 1} {c + 1}\n")
    elif field == "integer":
        for r, c, v in zip(rows, cols, vals):
            lines.append(f"{r + 1} {c + 1} {int(v)}\n")
    else:
        for r, c, v in zip(rows, cols, vals):
            lines.append(f"{r + 1} {c + 1} {v:.17g}\n")
    data = "".join(lines)
    lower = path.lower()
    if lower.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(data)
    elif lower.endswith(".xz"):
        with lzma.open(path, "wt") as f:
            f.write(data)
    elif lower.endswith(".bz2"):
        with bz2.open(path, "wt") as f:
            f.write(data)
    elif lower.endswith(".zip"):
        import os as _os
        import zipfile as _zipfile

        inner = _os.path.basename(path)[: -len(".zip")]
        with _zipfile.ZipFile(path, "w", _zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(inner, data)
    else:
        with open(path, "w") as f:
            f.write(data)


def mm_to_csr(path: str):
    """File -> CSR one-shot (reference MMtoCSR analog, parser.c:298-344)."""
    from ..formats.convert import coo_to_csr

    return coo_to_csr(read_coo(path))


_CAP_DEFAULT = object()  # sentinel: "apply the default ELL cap"


def mm_to_ell(path: str, max_entries=_CAP_DEFAULT):
    """File -> ELL one-shot (reference MMtoELL analog, parser.c:347-376).

    max_entries=None disables the size cap (LIMIT_ELL_SIZE off), matching
    formats.convert.coo_to_ell."""
    from ..formats.convert import coo_to_ell
    from ..config import ELL_MAX_ENTRIES

    cap = ELL_MAX_ENTRIES if max_entries is _CAP_DEFAULT else max_entries
    return coo_to_ell(read_coo(path), max_entries=cap)
