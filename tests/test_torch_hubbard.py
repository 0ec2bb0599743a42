"""The port's Hubbard chain (``io/scamac.hubbard``), built one block of
up-spin states at a time, on the CPU: bit-equal to the JAX package's
wherever the JAX package accepts the spec, also with blocks of a few
nonzeros; the same triplets as the benchmark's own generator
(``spmv_cells/inputs/hubbard.py``); the benchmark configuration's size in
closed form; the span ``scamac.generate`` in a CLI trace; the counter
``matrix_passes`` of the kernel wrappers; and the operator's sp colwise
SpMMV of the configuration's CPU size against the benchmark's
reference."""

import functools
import glob
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu.io import scamac as jscamac

from uspmv_tpu_torch import cli
from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.io import scamac as tscamac
from uspmv_tpu_torch.ops import scs_spmv
from uspmv_tpu_torch.ops.device_format import vector_pass_count
from uspmv_tpu_torch.runtime import profiling
from uspmv_tpu_torch.runtime.operator import SpmvOperator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from spmv_cells.lib import reference, spec  # noqa: E402

CONFIG = "hubbard_15_7"
CELL = "hubbard_15_7.spmmv_sp_bs8"
_rng = np.random.default_rng(26)
JAX_SPECS = [
    # test_torch_aux's Hubbard cases
    "Hubbard,n_sites=8,n_fermions=4,U=1.3",
    "Hubbard,n_sites=7,n_fermions=3,t=0.5,U=2,ranpot=0.4,seed=5,pbc=1",
    "hubbard,n_sites=6,n_fermions=3,boundary_conditions=periodic",
    "Hubbard,n_sites=12,n_fermions=6,U=1.3",
] + [
    f"Hubbard,n_sites=12,n_fermions=6,U=1.3,ranpot={r:.6f},seed={s}"
    for r, s in zip(_rng.uniform(0.1, 3.0, 2),
                    _rng.integers(0, 2**40, 2))
]
# nonzeros a block builds: one up-spin state a block, a few, the default
BLOCKS = [1, 5000, 200_000, tscamac.HUBBARD_BLOCK_NNZ]


@functools.lru_cache(maxsize=None)
def jax_hubbard(spec_):
    return jscamac.scamac_generate(spec_)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("spec_", JAX_SPECS)
def test_hubbard_bit_equal_to_jax(spec_, block, monkeypatch):
    monkeypatch.setattr(tscamac, "HUBBARD_BLOCK_NNZ", block)
    a, b = jax_hubbard(spec_), tscamac.scamac_generate(spec_)
    assert (a.n_rows, a.n_cols, a.nnz, a.is_sorted, a.is_symmetric) == (
        b.n_rows, b.n_cols, b.nnz, b.is_sorted, b.is_symmetric)
    for f in ("I", "J", "values"):
        u, v = getattr(a, f), getattr(b, f)
        assert u.dtype == v.dtype and u.shape == v.shape
        assert u.tobytes() == v.tobytes(), f


def by_row_col(I, J, V):
    order = np.lexsort((J, I))
    return I[order], J[order], V[order]


@pytest.mark.parametrize("params", [
    "small",
    dict(n_sites=10, n_fermions=5, t=1.0, U=1.3, pbc=0),
    dict(n_sites=10, n_fermions=5, t=0.7, U=2.5, pbc=1),
], ids=["small", "10_5", "10_5_periodic"])
def test_benchmark_generator_same_triplets(params):
    """The benchmark's generator, written from the Hamiltonian's
    definition, and the port's give the same (row, col, value) triplets,
    values bit for bit; the benchmark's rows and columns ascend."""
    if params == "small":
        params = spec.config(CONFIG)["small"]
    n_rows, n_cols, I, J, V = spec.generator("hubbard").generate(params)
    m = tscamac.hubbard(n_sites=params["n_sites"],
                        n_fermions=params["n_fermions"], t=params["t"],
                        U=params["U"], pbc=params["pbc"])
    assert (n_rows, n_cols, V.size) == (m.n_rows, m.n_cols, m.nnz)
    assert I.dtype == J.dtype == np.int32 and V.dtype == np.float64
    assert np.array_equal(by_row_col(I, J, V)[0], I)  # already in order
    for u, v in zip(by_row_col(I, J, V), by_row_col(m.I, m.J, m.values)):
        assert u.tobytes() == v.tobytes()


@pytest.mark.parametrize("size", ["params", "small"])
def test_config_size_in_closed_form(size):
    """n_rows and nnz of the configuration (and of its CPU size) from one
    species' basis and hops: D^2 rows, D^2 + 2 H D nonzeros, both within
    int32; rows of 1 + 2 min(hops) to 1 + 2 max(hops) entries."""
    conf = spec.config(CONFIG)
    p = conf[size]
    states = tscamac._sector_states(p["n_sites"], p["n_fermions"])
    hi, _, _ = tscamac._sector_hops(states, p["n_sites"], p["t"], p["pbc"])
    d = states.size
    hops = np.bincount(hi, minlength=d)
    nnz = d * d + 2 * hi.size * d
    assert spec.generator("hubbard").nnz(p) == nnz
    assert max(d * d, nnz) <= tscamac.INT32_MAX
    if size == "params":
        assert (conf["n_rows"], conf["nnz"]) == (d * d, nnz)
        assert (d, hi.size) == (6435, 48048)
        assert (1 + 2 * hops.min(), 1 + 2 * hops.max()) == (3, 29)
    else:
        m = tscamac.hubbard(n_sites=p["n_sites"], n_fermions=p["n_fermions"],
                            t=p["t"], U=p["U"], pbc=p["pbc"])
        assert (m.n_rows, m.nnz) == (d * d, nnz)
        lens = np.bincount(m.I, minlength=m.n_rows)
        assert (lens.min(), lens.max()) == (1 + 2 * hops.min(),
                                            1 + 2 * hops.max())


def test_cli_trace_holds_the_generation(tmp_path, capsys):
    """-log_prof's trace runs from the generation through the build to
    the bench: it holds ``scamac.generate``, ``from_mtx`` and the bench's
    region."""
    rc = cli.main(["Hubbard,n_sites=6,n_fermions=3,U=1.3", "scs", "-c", "8",
                   "-sp", "-mode", "b", "-bench_time", "0.001", "-backend",
                   "cpu", "-log_prof", str(tmp_path / "prof"), "-mtx_out",
                   str(tmp_path)])
    assert rc == 0 and "[log_prof] trace ->" in capsys.readouterr().out
    (trace,) = glob.glob(str(tmp_path / "prof" / "*.json"))
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"scamac.generate", "from_mtx", "spmv_scs_benchmark"} <= names
    assert not profiling.enabled()


class _Lib:
    """A kernel library whose every entry point returns 0 (launched)."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.mark.parametrize("bs", [1, 8, 16])
def test_matrix_passes_booked_per_launch(bs):
    """A SELL-C-sigma launch of bs colwise vectors books
    ``vector_pass_count(bs)`` passes beside its one launch; a rowwise
    block makes a launch of one pass per pass of at most 8 columns, the
    same total; a launch inside a graph capture books neither."""
    m = tscamac.hubbard(n_sites=6, n_fermions=3, U=1.3)
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=32, sigma=1,
               value_type="sp", backend="cpu", mixed_tiles=False,
               split_rows_threshold=-1), m)
    (dev,) = op.devs.values()
    name = next(iter(scs_spmv._launches))
    saved = dict(scs_spmv._launches)
    profiling.reset()
    try:
        scs_spmv._launch(_Lib(), name, dev, 0, 1, 0, 0, 1, 0, 1, bs, False,
                         0)
        assert profiling.snapshot()["counters"] == {
            profiling.LAUNCHES: 1,
            profiling.MATRIX_PASSES: vector_pass_count(bs)}
        profiling.reset()
        for _, ncols in scs_spmv.vector_passes(bs):
            scs_spmv._launch(_Lib(), name, dev, 0, bs, 0, 0, bs, 0, ncols,
                             1, False, 0)
        assert profiling.snapshot()["counters"] == {
            profiling.LAUNCHES: vector_pass_count(bs),
            profiling.MATRIX_PASSES: vector_pass_count(bs)}
        profiling.reset()
        with scs_spmv.record_captured_launches() as nodes:
            scs_spmv._launch(_Lib(), name, dev, 0, 1, 0, 0, 1, 0, 1, bs,
                             False, 0)
        assert nodes == {name: 1}
        assert profiling.snapshot()["counters"] == {}
    finally:
        profiling.reset()
        scs_spmv._launches.clear()
        scs_spmv._launches.update(saved)


@pytest.mark.parametrize("mixed_tiles", [False, None],
                         ids=["sell", "default_tiers"])
def test_spmmv_sp_colwise_bs8_against_the_reference(mixed_tiles):
    """The cell's traffic on the configuration's CPU size, with a random
    site potential from a seed: the operator's sp SpMMV of 8 colwise
    vectors against the benchmark's float64 reference, within the cell's
    limit."""
    cell = spec.cell(CELL)
    p = cell["config"]["small"]
    m = tscamac.hubbard(n_sites=p["n_sites"], n_fermions=p["n_fermions"],
                        t=p["t"], U=p["U"], pbc=p["pbc"], ranpot=0.8,
                        seed=2**33 + 7)
    op = SpmvOperator.from_mtx(
        Config(backend="cpu", value_type=cell["value_type"],
               block_vec_size=cell["block_vec_size"],
               vector_layout=cell["vector_layout"], mixed_tiles=mixed_tiles,
               **cell["config"]["program"]), m)
    x = np.random.default_rng(2**31 + 1).uniform(
        cell["x"]["low"], cell["x"]["high"],
        (m.n_rows, cell["block_vec_size"])).astype(np.float32)
    y = np.asarray(op.to_host(op.spmv(op.make_x(x))))
    A = reference.csr(m.n_rows, m.n_cols, m.I, m.J, m.values)
    err = reference.max_err(y, reference.spmv(A, x))
    assert 0 < err <= cell["limits"]["max_err"]
