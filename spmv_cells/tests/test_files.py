"""BENCHMARK.json and the files it names: every cell has its traffic file,
configuration, generator and readers, and the entries keep to the
benchmark contract's forms."""

import json
import re

import numpy as np
import pytest

from spmv_cells.lib import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
SMALL_ROWS = 10**5  # the most rows a configuration's "small" may give


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["spmv_cells"]
    assert BENCH["command"] == ["python3", "spmv_cells/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_exist(name):
    w = spec.workload(BENCH, name)
    cell = spec.cell(name)
    assert cell["config"]["name"] == w["config"]
    assert w["chips"] == 1
    gen = spec.generator(cell["config"]["generator"])
    assert callable(gen.generate)
    got = spec.metrics_for(BENCH, name)
    assert any(m["name"] == "setup_s" for m in got["end_to_end"])
    assert len(got["end_to_end"]) >= 2 and got["per_layer"]
    for m in got["end_to_end"] + got["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
    assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_entries(entry):
    assert NAME.match(entry["name"])
    conf = spec.config(entry["name"])
    assert entry["file"] == f"spmv_cells/configs/{entry['name']}.json"
    assert entry["source"] == conf["source"]
    assert entry["reduced"] == conf["reduced"]
    described = set(conf["params"]) | set(conf["program"]) \
        | set(conf.get("assumed", {}))
    assert set(entry["reduced"]) <= described
    assert len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    assert 1 <= len(entry["source"]) <= 200 and 1 <= len(entry["why"]) <= 200
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CONFIGS)
def test_config_small(name):
    """The configuration's own CPU test size: its generator's parameters
    under "small", the same keys as "params", at most SMALL_ROWS rows,
    sorted."""
    conf = spec.config(name)
    assert set(conf["small"]) == set(conf["params"])
    n_rows, n_cols, I, J, V = spec.generator(conf["generator"]).generate(
        conf["small"])
    assert 0 < n_rows <= SMALL_ROWS and 0 < n_cols
    assert I.size == J.size == V.size > 0
    assert np.all(np.diff(I) >= 0)
    assert 0 <= I.min() and I.max() < n_rows


def test_metrics_for_the_accepted_cell():
    """Every name a run of hpcg_256.spmv_dp printed before the metrics'
    cell lists grew, it still prints: a cell added by files and entries
    takes none away. (A metric that a later PR adds to this cell may join
    them, so the test asks for these names, not for these alone.) Each
    but setup_s, which every cell reports, reaches the cell through its
    own list, so a new cell gets no metric it does not name."""
    cell = "hpcg_256.spmv_dp"
    got = spec.metrics_for(BENCH, cell)
    assert {m["name"] for m in got["end_to_end"]} >= {
        "spmv_gflops", "setup_s"}
    assert {m["name"] for m in got["per_layer"]} >= {
        "build_s", "slots_per_nnz", "host_us_per_spmv", "spmv_roofline_pct",
        "hbm_copy_gbs", "device_idle_pct.spmv", "launches_per_spmv",
        "resident_bytes_per_nnz"}
    for m in got["end_to_end"] + got["per_layer"]:
        assert m["name"] == "setup_s" or cell in m.get("workloads", ())


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entries(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200


def test_workload_entries():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(CELLS)
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
