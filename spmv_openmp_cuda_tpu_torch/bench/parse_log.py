"""Harness-log -> CSV reducer.

The port's copy of spmv_openmp_cuda_tpu/bench/parse_log.py: both packages'
harnesses write the same schema, so it reads the logs of either. Analog of
the reference's scripts/parseLog.py (regex parse of
#matrix/config/@func/stats log structure into per-run CSV rows, with an
optional per-matrix pivot grouping implementations into columns —
parseLog.py:51-58,113-168,201-261). Parses the schema emitted by
bench/harness.py:format_log.
"""
from __future__ import annotations

import argparse
import csv
import re
import sys
from typing import Dict, Iterable, List, Optional

FIELDS = [
    "source",
    "funcID",
    "impl",
    # wall time per repetition (in the JAX package's logs a dispatch time
    # only, its backend did not synchronize); kernel time = internalTimeAvg
    "wallDispatchAvg",
    "wallDispatchVar",
    "internalTimeAvg",
    "internalTimeVar",
    "prepTime",
    "GFLOPS",
    "NNZs",
    "ok",
    "det",
    "matRows",
    "matCols",
    "NNZ",
    "maxRowNNZ",
    "grid",
    "dtype",
    "schedule",
    "sampleSize",
    "devices",
    "backend",
    "error",
]

_MATRIX_RE = re.compile(r"^#matrix:\s+(\S+)\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)")
_CONFIG_RE = re.compile(
    r"^#config:\s+grid=(\S+)\s+dtype=(\S+)\s+schedule=(\S+)\s+reps=(\d+).*?"
    r"devices=(\d+)\s+backend=(\S+)"
)
_FUNC_RE = re.compile(r"^@computing SpMV with func:(\S+)\s+(\S+)")
_STAT_RE = re.compile(
    # wallDispatchAvg is the current schema; timeAvg accepted for logs
    # recorded before the rename (e.g. scripts/sample_*.log)
    r"^(\S+)\s+(?:wallDispatchAvg|timeAvg):(\S+)\s+"
    r"(?:wallDispatchVar|timeVar):(\S+)\s+internalTimeAvg:(\S+)\s+"
    r"internalTimeVar:(\S+)\s+prepTime:(\S+)\s+GFLOPS:(\S+)\s+NNZs:(\S+)\s+ok:(\d)"
    r"(?:\s+det:(\d))?"
)
_ERR_RE = re.compile(r"^(\S+)\s+ERROR:\s*(.*)")


def parse_lines(lines: Iterable[str]) -> List[Dict[str, str]]:
    rows: List[Dict[str, str]] = []
    ctx: Dict[str, str] = {}
    impl = ""
    for line in lines:
        line = line.rstrip("\n")
        m = _MATRIX_RE.match(line)
        if m:
            ctx.update(
                source=m.group(1),
                matRows=m.group(2),
                matCols=m.group(3),
                NNZ=m.group(4),
                maxRowNNZ=m.group(5),
            )
            continue
        m = _CONFIG_RE.match(line)
        if m:
            ctx.update(
                grid=m.group(1),
                dtype=m.group(2),
                schedule=m.group(3),
                sampleSize=m.group(4),
                devices=m.group(5),
                backend=m.group(6),
            )
            continue
        m = _FUNC_RE.match(line)
        if m:
            impl = m.group(1)
            continue
        m = _ERR_RE.match(line)
        if m and " timeAvg:" not in line and " wallDispatchAvg:" not in line:
            rows.append(
                {
                    **ctx,
                    "funcID": m.group(1),
                    "impl": impl,
                    "wallDispatchAvg": "", "wallDispatchVar": "",
                    "internalTimeAvg": "", "internalTimeVar": "",
                    "prepTime": "", "GFLOPS": "", "NNZs": "",
                    "ok": "0",
                    "det": "",
                    "error": m.group(2),
                }
            )
            continue
        m = _STAT_RE.match(line)
        if m:
            rows.append(
                {
                    **ctx,
                    "funcID": m.group(1),
                    "impl": impl,
                    "wallDispatchAvg": m.group(2),
                    "wallDispatchVar": m.group(3),
                    "internalTimeAvg": m.group(4),
                    "internalTimeVar": m.group(5),
                    "prepTime": m.group(6),
                    "GFLOPS": m.group(7),
                    "NNZs": m.group(8),
                    "ok": m.group(9),
                    "det": m.group(10) or "",
                    "error": "",
                }
            )
            continue
    return rows


def pivot_by_matrix(rows: List[Dict[str, str]]) -> List[Dict[str, str]]:
    """GROUP_IMPLEMENTATIONS analog (parseLog.py:201-261): one row per
    (matrix, config) with per-implementation internal-time columns."""
    groups: Dict[tuple, Dict[str, str]] = {}
    for r in rows:
        key = (r.get("source"), r.get("grid"), r.get("dtype"), r.get("schedule"))
        g = groups.setdefault(
            key,
            {
                k: r.get(k, "")
                for k in (
                    "source",
                    "matRows",
                    "matCols",
                    "NNZ",
                    "maxRowNNZ",
                    "grid",
                    "dtype",
                    "schedule",
                )
            },
        )
        g[f"time_{r['funcID']}"] = r["internalTimeAvg"]
        g[f"gflops_{r['funcID']}"] = r["GFLOPS"]
    return list(groups.values())


def write_csv(rows: List[Dict[str, str]], out, pivot: bool = False) -> None:
    if pivot:
        rows = pivot_by_matrix(rows)
        fields: List[str] = []
        for r in rows:
            for k in r:
                if k not in fields:
                    fields.append(k)
    else:
        fields = FIELDS
    w = csv.DictWriter(out, fieldnames=fields, extrasaction="ignore")
    w.writeheader()
    w.writerows(rows)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="reduce harness logs to CSV")
    p.add_argument("logs", nargs="+", help="log files (- for stdin)")
    p.add_argument("-o", "--out", default="-")
    p.add_argument(
        "--pivot", action="store_true", help="one row per matrix, impls as columns"
    )
    args = p.parse_args(argv)
    rows: List[Dict[str, str]] = []
    for path in args.logs:
        if path == "-":
            rows.extend(parse_lines(sys.stdin))
        else:
            with open(path) as f:
                rows.extend(parse_lines(f))
    out = sys.stdout if args.out == "-" else open(args.out, "w", newline="")
    try:
        write_csv(rows, out, pivot=args.pivot)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
