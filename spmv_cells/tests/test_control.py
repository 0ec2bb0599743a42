"""The control of each cell comes out as not correct: the program with its
next lower precision switched on (the cell's ``control_value_type``). At a
small size on the CPU; calibrate.py reads the same at the cells' own sizes
on the card."""

import pytest

from spmv_cells import calibrate
from spmv_cells.lib import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEEDS = [5, 2**31 + 3, 2**33 + 1]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, small):
    cell = small(name)
    got = calibrate.calibrate(cell, SEEDS, SEEDS, 0.05, backend="cpu")
    limit = cell["limits"]["max_err"]
    assert all(err <= limit for _, err in got["program"])
    assert all(not err <= limit for _, err in got["control"])
