"""The result line of a run, from its record: the metrics that
BENCHMARK.json names for the cell, each read by its reader in metrics/,
the device, the breakdown of a traced run, and the numbers ``correct``
compares, each beside its limit."""

from __future__ import annotations

import math
from typing import List, Optional

from . import spec, tracing, work


class Ctx:
    """What a metric's reader reads: the cell, the run's record and its
    run (record["runs"][0])."""

    def __init__(self, cell: dict, record: dict):
        self.cell = cell
        self.record = record
        self.run = record["runs"][0]
        m = record["matrix"]
        self.nnz, self.n_rows, self.n_cols = m["nnz"], m["n_rows"], m["n_cols"]
        self.value_type = cell["value_type"]
        self.bs = int(cell["block_vec_size"])
        self.device_name = record["device_name"]

    def summary(self, key: str = "traced") -> Optional[tracing.Summary]:
        """The trace summary of the run's traced window ("traced") or of
        its device copy ("copy"); None where the run has none."""
        part = self.run.get(key)
        return tracing.Summary.from_json(part["summary"]) if part else None

    def bytes_per_spmv(self) -> int:
        return work.bytes_per_spmv(self.nnz, self.n_rows, self.n_cols,
                                   self.value_type, self.bs)

    def flops_per_spmv(self) -> int:
        return work.flops_per_spmv(self.nnz, self.bs)

    def peak_bytes_per_s(self) -> Optional[float]:
        return work.hbm_bytes_per_s(self.device_name)


def read_metrics(ctx: Ctx, wanted: List[dict]) -> dict:
    out = {}
    for m in wanted:
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def checks(cell: dict, record: dict) -> dict:
    """Each number ``correct`` compares beside its limit; a number that
    is not finite (a result that overflowed or is missing) reads null."""
    got = record["runs"][0]["checks"]
    out = {}
    for name, limit in cell["limits"].items():
        value = got.get(name)
        ok = value is not None and math.isfinite(value)
        out[name] = {"value": value if ok else None, "limit": limit}
    return out


def is_correct(checked: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checked.values())


def assemble(cell: dict, metrics: dict, record: dict, trace: bool) -> dict:
    """The result line's object; "checks" comes last."""
    ctx = Ctx(cell, record)
    checked = checks(cell, record)
    correct = is_correct(checked)
    done = ctx.run.get("window", ctx.run.get("traced", {}))
    gpu = ctx.device_name != "cpu"
    device = {"platform": "gpu" if gpu else "cpu", "kind": ctx.device_name,
              "count": record["n_cards"],
              "memory_peak_bytes": record["memory_peak_bytes"]}
    out = {"correct": correct,
           "attempted": int(done.get("calls", 0)),
           "failed": 0 if correct else 1,
           "metrics": read_metrics(
               ctx, metrics["per_layer" if trace else "end_to_end"]),
           "device": device}
    if trace:
        s = ctx.summary()
        device["busy_s"] = s.busy_s
        device["window_s"] = s.window_s
        out["breakdown"] = tracing.breakdown(s)
    out["checks"] = checked
    return out
