"""The benchmark's own tests: on the CPU, at small sizes, through the plain
PyTorch versions of the program's kernels (backend "cpu")."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from spmv_cells.lib import spec  # noqa: E402


def small_cell(name: str) -> dict:
    """The cell's files with its configuration's generator at the size a
    test run holds: the configuration file's "small" in place of its
    "params"."""
    cell = copy.deepcopy(spec.cell(name))
    cell["config"]["params"] = dict(cell["config"]["small"])
    return cell


@pytest.fixture
def small():
    return small_cell
