"""The harness catches a broken timed path: each fault a cell can have,
planted under the program, makes ``correct`` come out false, on a run
driven as the benchmark drives it (at a small size, on the CPU, its look
for a card skipped).

  an answer altered where it is produced    y of every SpMV off in one row
  a step that returns its state unchanged   y = x, no product taken
"""

import time

import pytest

from spmv_cells.lib import drive, result, spec
from uspmv_tpu_torch.runtime.operator import SpmvOperator

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
ORIGINAL = SpmvOperator.spmv


def altered(self, x, out=None):
    y = ORIGINAL(self, x, out=out)
    y.view(-1)[7] += 1.0
    return y


def unchanged(self, x, out=None):
    return out.copy_(x) if out is not None else x.clone()


def correct(cell) -> bool:
    rec = drive.run_record(cell, [dict(seed=2**32 + 9, seconds=0.05,
                                       trace=False)], "cpu", time.time())
    return result.is_correct(result.checks(cell, rec))


@pytest.mark.parametrize("fault", [altered, unchanged])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault, small, monkeypatch):
    cell = small(name)
    assert correct(cell)
    monkeypatch.setattr(SpmvOperator, "spmv", fault)
    assert not correct(cell)
