"""A configuration and its cell join the benchmark as new files and new
entries in BENCHMARK.json alone: in a copy of the harness, a throwaway
configuration (HPCG's generator at 12^3, "small" 6^3) and a dp block-vector
cell on it are added without editing any file that was there, and the
harness's own tests of the files, the control and the run pass for it."""

import copy
import json
import os
import re
import shutil
import subprocess
import sys

from spmv_cells.tests.conftest import ROOT

CONFIG = "hpcg_12"
CELL = f"{CONFIG}.spmmv_dp_bs8"
GRID = {"nx": 12, "ny": 12, "nz": 12}


def new_config(source: str) -> dict:
    n = GRID["nx"] * GRID["ny"] * GRID["nz"]
    return {
        "source": source,
        "deployment": "A throwaway HPCG grid of 12^3 for the harness's "
                      "tests of a configuration added by files alone.",
        "generator": "hpcg",
        "params": dict(GRID),
        "small": {"nx": 6, "ny": 6, "nz": 6},
        "n_rows": n,
        "nnz": (3 * GRID["nx"] - 2) ** 3,
        "program": {"kernel_format": "scs", "chunk_size": 32, "sigma": 1,
                    "n_shards": 1, "seg_method": "seg-rows"},
        "assumed": {"chunk_size": "32: a small grid's chunk"},
        "reduced": ["nx", "ny", "nz"],
    }


NEW_CELL = {
    "config": CONFIG,
    "operation": "spmv",
    "value_type": "dp",
    "block_vec_size": 8,
    "vector_layout": "colwise",
    "x": {"low": -1.0, "high": 1.0},
    "control_value_type": "sp",
    "limits": {"max_err": 1e-10},
}


def files(top: str) -> dict:
    """Every file under ``top`` but bytecode, by its path relative to
    ``top``, with its bytes."""
    out = {}
    for d, dirs, names in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in names:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = fh.read()
    return out


def add(bench: dict) -> dict:
    """BENCHMARK.json with the throwaway configuration and cell appended:
    its entries, and its name at the end of each cell list it needs."""
    bench = copy.deepcopy(bench)
    entry = bench["configs"][0]
    bench["configs"].append({
        "name": CONFIG, "source": entry["source"],
        "file": f"spmv_cells/configs/{CONFIG}.json",
        "reduced": ["nx", "ny", "nz"],
        "why": "a second configuration added by files and entries alone"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "spmmv_dp_bs8",
        "chips": 1, "why": "dp, 8 colwise block vectors on HPCG rows"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    return bench


def without_addition(bench: dict) -> dict:
    """``bench`` with the throwaway configuration's entries and names
    taken out again."""
    bench = copy.deepcopy(bench)
    bench["configs"] = [c for c in bench["configs"] if c["name"] != CONFIG]
    bench["workloads"] = [w for w in bench["workloads"]
                          if w["name"] != CELL]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    return bench


def test_a_configuration_is_added_by_files_and_entries(tmp_path):
    shutil.copytree(os.path.join(ROOT, "spmv_cells"),
                    tmp_path / "spmv_cells",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = files(tmp_path / "spmv_cells")

    source = bench["configs"][0]["source"]
    for rel, obj in ((f"configs/{CONFIG}.json", new_config(source)),
                     (f"cells/{CELL}.json", NEW_CELL)):
        with open(tmp_path / "spmv_cells" / rel, "x") as f:
            json.dump(obj, f, indent=2)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(add(bench), f, indent=1)

    env = dict(os.environ, PYTHONPATH=ROOT)  # the program, for its import
    tests = [f"spmv_cells/tests/{t}.py"
             for t in ("test_files", "test_control", "test_run")]
    p = subprocess.run(
        [sys.executable, "-m", "pytest", *tests, "-v", "-p",
         "no:cacheprovider", "-k", f"test_files or {CONFIG}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]
    passed = re.findall(r"^(\S+) PASSED", p.stdout, re.M)
    ran = [t for t in passed if CONFIG in t]
    # the new configuration's file check, its control, its runs traced
    # and untraced, and its cell's files
    assert any("test_config_small" in t for t in ran), p.stdout[-4000:]
    assert any("test_control_fails" in t for t in ran), p.stdout[-4000:]
    assert sum("test_cell_runs_small" in t for t in ran) == 2, \
        p.stdout[-4000:]
    assert any("test_cell_files_exist" in t for t in ran), p.stdout[-4000:]

    after = files(tmp_path / "spmv_cells")
    assert {k: after.get(k) for k in before} == before
    assert set(after) - set(before) == {f"configs/{CONFIG}.json",
                                        f"cells/{CELL}.json"}
    with open(tmp_path / "BENCHMARK.json") as f:
        assert without_addition(json.load(f)) == bench
