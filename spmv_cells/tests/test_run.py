"""run.py without a card, the modules a run may load, and every cell's
run end to end at a small size on the CPU (the harness's look for a card
skipped, the program's plain versions in place of its kernels)."""

import json
import os
import subprocess
import sys
import time

import pytest

from spmv_cells.lib import drive, result, spec
from spmv_cells.tests.conftest import ROOT

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "spmv_cells/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def loaded(code: str) -> set:
    p = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json; print(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = loaded("import spmv_cells.run, spmv_cells.calibrate\n"
                  "from spmv_cells.lib import drive, result, tracing\n"
                  "import uspmv_tpu_torch")
    assert not mods & {"jax", "jaxlib", "flax", "uspmv_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = loaded("from spmv_cells.lib import reference\n"
                  "from spmv_cells.inputs import hpcg")
    assert not mods & {"jax", "jaxlib", "flax", "uspmv_tpu",
                       "uspmv_tpu_torch", "torch"}


def test_forbidden_modules_by_whole_name():
    sys.modules.setdefault("uspmv_tpu_torchlike", sys)
    try:
        assert drive.forbidden_modules() == [
            m for m in ("jax", "jaxlib", "uspmv_tpu") if m in sys.modules]
    finally:
        del sys.modules["uspmv_tpu_torchlike"]


def run_small(cell, trace, seed=2**31 + 11, seconds=0.2):
    bench = spec.benchmark()
    record = drive.run_record(
        cell, [dict(seed=seed, seconds=seconds, trace=trace)], "cpu",
        time.time())
    return result.assemble(cell, spec.metrics_for(bench, cell["name"]),
                           record, trace)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_small(name, trace, small):
    out = run_small(small(name), trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    want = spec.metrics_for(spec.benchmark(), name)[
        "per_layer" if trace else "end_to_end"]
    # a CPU run reads no device metric: no trace of a card, no roofline
    device = {m["name"] for m in want if m["source"] == "device_trace"}
    assert set(out["metrics"]) <= {m["name"] for m in want}
    assert not set(out["metrics"]) & device - {
        n for n in device if n.startswith("device_idle")}
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in want}
    else:
        assert "breakdown" in out and out["device"]["window_s"] > 0
