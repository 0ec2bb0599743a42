"""The readers of the program's own counters (lib/program.py) on a
synthetic record: a program that books them, one that keeps no such
counters (an older version of the program) and one never loaded."""

import sys
import types

import pytest

from spmv_cells.lib import drive, program, result, spec

COUNTED = ("launches_per_spmv", "resident_bytes_per_nnz")


def fake_program(monkeypatch, counters=None):
    """The program's profiling module in this process: with ``snapshot()``
    returning ``counters``, or, with None, a module without it."""
    mod = types.ModuleType(program.PROFILING)
    if counters is not None:
        mod.snapshot = lambda: {"spans": {}, "counters": dict(counters)}
    monkeypatch.setitem(sys.modules, program.PROFILING, mod)


def ctx(runs=1):
    run = {"traced": {"calls": 976}, "host_burst": {"calls": 1024}}
    rec = {"matrix": {"n_rows": 1000, "n_cols": 1000, "nnz": 27000},
           "device_name": "NVIDIA H100 80GB HBM3", "n_cards": 1,
           "runs": [run] * runs}
    return result.Ctx(spec.cell("hpcg_256.spmv_dp"), rec)


def read(name, c):
    return spec.reader(name).read(c)


def test_readers_of_the_program_counters(monkeypatch):
    calls = drive.WARM_CALLS + drive.RATE_CALLS + 1024 + 976
    fake_program(monkeypatch, {"launches": 2 * calls,
                               "upload_bytes": 27000 * 16})
    assert read("launches_per_spmv", ctx()) == 2.0
    assert read("resident_bytes_per_nnz", ctx()) == 16.0
    # several runs on one build share the process's counter: no reading
    assert read("launches_per_spmv", ctx(runs=2)) is None


@pytest.mark.parametrize("counters", [None, {}], ids=["parent", "no_card"])
def test_no_counter_reads_nothing(monkeypatch, counters):
    """A program without the counters (the parent), or one that launched
    and uploaded nothing: no reading, never 0 or an error."""
    fake_program(monkeypatch, counters)
    for name in COUNTED:
        assert read(name, ctx()) is None


def test_program_never_loaded_reads_nothing(monkeypatch):
    monkeypatch.delitem(sys.modules, program.PROFILING, raising=False)
    assert program.counter("launches") is None
    for name in COUNTED:
        assert read(name, ctx()) is None
