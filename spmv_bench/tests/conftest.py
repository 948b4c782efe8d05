"""Shared fixtures of the benchmark's own tests (run them with
`python -m pytest spmv_bench/tests -q`; the card tests with `-m gpu` on a
machine that has one)."""
from __future__ import annotations

import copy
import json

import pytest
import torch

from spmv_bench import spec

SMALL = {"kronecker": dict(scale=10), "laplacian_2d": dict(grid=24)}


def file_cell(config: str, traffic: str) -> spec.Cell:
    """A cell built from a configuration file and a traffic file alone, as
    a cell that waits for its BENCHMARK.json entry (no metrics)."""
    cfg = json.loads((spec.BASE / "configs" / f"{config}.json").read_text())
    mix = json.loads((spec.BASE / "traffic" / f"{traffic}.json").read_text())
    return spec.Cell(name=f"{config}.{traffic}", chips=1, config=cfg, traffic=mix, end_to_end=[], per_layer=[])


def small_cell(cell) -> spec.Cell:
    """The cell (a BENCHMARK.json name, or a Cell) with its matrix cut to a
    size a test holds (and CG's maxiter to suit it); traffic and limits as
    they are."""
    cell = spec.find_cell(cell) if isinstance(cell, str) else copy.deepcopy(cell)
    cfg = copy.deepcopy(cell.config)
    cfg["params"].update(SMALL[cfg["generator"]])
    if "solver" in cfg:
        cfg["solver"]["maxiter"] = 500
    cell.config = cfg
    return cell


@pytest.fixture
def card():
    """The card's device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
