"""Find a cell's configuration, traffic mix and metric readers by name.

`BENCHMARK.json`, at the root of the checkout, names them. A configuration
is the file its entry names; a traffic mix is `traffic/<name>.json`; a
metric is `metrics/<name>.py`, whose `read(run)` gives the metric's value
or None. Adding a configuration, a cell or a metric is adding files and
entries: nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

BASE = Path(__file__).resolve().parent
SPEC = BASE.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    #: the metrics this cell reports without and with --trace 1
    end_to_end: List[dict]
    per_layer: List[dict]


def load_spec(path: Path = SPEC) -> dict:
    return json.loads(Path(path).read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, spec_path: Path = SPEC, base: Path = BASE) -> Cell:
    """The cell `name` of the spec at spec_path, its files resolved (the
    configuration's against the spec's directory, the traffic mix under
    base/traffic). Raises KeyError for an unknown cell or configuration."""
    spec_path = Path(spec_path)
    spec = load_spec(spec_path)
    work = {w["name"]: w for w in spec["workloads"]}[name]
    entry = {c["name"]: c for c in spec["configs"]}[work["config"]]
    config = json.loads((spec_path.parent / entry["file"]).read_text())
    traffic = json.loads((Path(base) / "traffic" / f"{work['traffic']}.json").read_text())
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def reader(name: str, base: Path = BASE) -> Callable[[object], Optional[float]]:
    """`read` of metrics/<name>.py under base."""
    path = Path(base) / "metrics" / f"{name}.py"
    module_name = "spmv_bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
