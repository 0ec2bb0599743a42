"""The Hubbard configuration's generator (inputs/hubbard.py) on its own,
and the reader of the program's pass counter
(metrics/matrix_passes_per_spmv.py): the generator loads nothing of the
program, its matrix has the closed-form size, ascending rows and columns,
a stored diagonal in every row and is symmetric; the reader reads the
counter over the run's calls, and nothing where the program keeps no such
counter."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest

from spmv_cells.lib import drive, reference, spec
from spmv_cells.tests.conftest import ROOT
from spmv_cells.tests.test_program_readers import ctx, fake_program

CONFIG = "hubbard_15_7"


def test_generator_loads_nothing_of_the_program():
    code = ("from spmv_cells.inputs import hubbard\n"
            "import sys, json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    mods = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "uspmv_tpu",
                       "uspmv_tpu_torch", "torch"}


@pytest.mark.parametrize("params", [
    "small",
    dict(n_sites=9, n_fermions=2, t=0.5, U=3.0, pbc=1),
    dict(n_sites=5, n_fermions=0, t=1.0, U=1.3, pbc=0),
], ids=["small", "9_2_periodic", "empty_species"])
def test_generator_matrix(params):
    if params == "small":
        params = spec.config(CONFIG)["small"]
    gen = spec.generator("hubbard")
    L, n = params["n_sites"], params["n_fermions"]
    D = math.comb(L, n)
    n_rows, n_cols, I, J, V = gen.generate(params)
    assert n_rows == n_cols == D * D and V.size == gen.nnz(params)
    assert I.dtype == J.dtype == np.int32 and V.dtype == np.float64
    assert np.all(np.diff(I) >= 0)
    new_row = np.diff(I) != 0
    assert np.all((np.diff(J) > 0) | new_row)
    diag = I == J
    assert np.bincount(I[diag], minlength=n_rows).min() == 1
    # the rows where no site holds both spins: the down set among the
    # L - n sites the up set leaves empty
    assert np.sum(V[diag] == 0) == D * math.comb(L - n, n)
    A = reference.csr(n_rows, n_cols, I, J, V)
    assert (A != A.T).nnz == 0


def test_matrix_passes_reader(monkeypatch):
    calls = drive.WARM_CALLS + drive.RATE_CALLS + 1024 + 976
    fake_program(monkeypatch, {"launches": calls, "matrix_passes": 2 * calls})
    read = spec.reader("matrix_passes_per_spmv").read
    assert read(ctx()) == 2.0
    # several runs on one build share the process's counter: no reading
    assert read(ctx(runs=2)) is None


@pytest.mark.parametrize("counters", [None, {}, {"launches": 7}],
                         ids=["no_snapshot", "no_card", "parent"])
def test_matrix_passes_reader_without_the_counter(monkeypatch, counters):
    """A program without ``snapshot``, one that launched nothing, and one
    that counts launches but no passes (the parent): no reading."""
    fake_program(monkeypatch, counters)
    assert spec.reader("matrix_passes_per_spmv").read(ctx()) is None
