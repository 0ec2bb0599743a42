"""Where each piece of a cell lives, found by the names in BENCHMARK.json.

  configs/<config>.json     a deployment: its source, its generator and
                            its parameters ("params"), the same keys at a
                            size a CPU test run holds ("small"), the
                            program's format
  inputs/<generator>.py     generate(params) -> (n_rows, n_cols, I, J, V)
  cells/<cell>.json         a traffic mix: operation, precision, vectors,
                            the limits of ``correct``
  metrics/<metric>.py       read(ctx) -> a number or None

A later cell or metric adds files and entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]  # spmv_cells/
ROOT = HERE.parent  # the checkout
BENCHMARK = ROOT / "BENCHMARK.json"


def _load_module(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = "spmv_cells_" + path.parent.name + "_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """The cell's traffic file, with its config's file under "config"."""
    c = read_json(HERE / "cells" / f"{name}.json")
    c["name"] = name
    c["config"] = config(c["config"])
    return c


def config(name: str) -> dict:
    c = read_json(HERE / "configs" / f"{name}.json")
    c["name"] = name
    return c


def generator(name: str) -> ModuleType:
    return _load_module(HERE / "inputs" / f"{name}.py")


def reader(metric: str) -> ModuleType:
    return _load_module(HERE / "metrics" / f"{metric}.py")


def benchmark() -> dict:
    return read_json(BENCHMARK)


def workload(bench: dict, name: str) -> Optional[dict]:
    return next((w for w in bench["workloads"] if w["name"] == name), None)


def metrics_for(bench: dict, name: str) -> Dict[str, List[dict]]:
    """The cell's end-to-end metrics (``--trace 0``) and per-layer metrics
    (``--trace 1``) as BENCHMARK.json names them: an end-to-end metric
    without "workloads" is every cell's; a per-layer metric without it is
    every cell's that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in names
                              else [])]
    return {"end_to_end": e2e, "per_layer": layer}
