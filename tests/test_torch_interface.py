"""The library surface of uspmv_tpu_torch (interface.py and the CG example)
against the JAX package's on the CPU: the same matrices and vectors, made
with numpy from a seed, go through both."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import uspmv_tpu.interface as jui
from uspmv_tpu.io import generators as jgen

import uspmv_tpu_torch.interface as tui
from uspmv_tpu_torch.formats.coo import MtxData
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.runtime.operator import SpmvOperator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# relative to max|y|: f32 sums in another order than the JAX package's lane
# tiles; f64 sums differ in order only
TOL = {"sp": 1e-5, "dp": 1e-12, "ap[dp_sp]": 1e-12}


def rel_err(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def banded(gen):
    m = gen.random_banded(2000, 30, 9, seed=5)
    m.values[:] = m.values * (0.05 / np.abs(m.values).max())
    return m


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["MtxData", "scipy", "dense"])
def test_prepare_takes_three_matrix_kinds(kind):
    m = tgen.laplace2d(12)
    ref = m.to_scipy().tocsr()
    arg = {"MtxData": m, "scipy": ref, "dense": ref.toarray()}[kind]
    h = tui.prepare(arg, C=32, sigma=8, value_type="dp", backend="cpu")
    assert isinstance(h, SpmvOperator) and h.config.kernel_format == "scs"
    assert (h.n_rows, h.nnz) == (m.n_rows, m.nnz)
    x = np.random.default_rng(0).standard_normal(m.n_rows)
    assert rel_err(tui.execute_uspmv(h, x), ref @ x) <= 1e-13


def test_prepare_defaults_to_crs_and_to_the_card():
    m = tgen.tridiag(30)
    h = tui.prepare(m, backend="cpu")
    assert h.config.kernel_format == "crs" and h.config.value_type == "dp"
    if not torch.cuda.is_available():
        from uspmv_tpu_torch.runtime.operator import DeviceUnavailableError

        with pytest.raises(DeviceUnavailableError):
            tui.prepare(m)  # backend="cuda" is the default


CASES = {
    "sp": dict(value_type="sp"),
    "dp": dict(value_type="dp"),
    "ap[dp_sp]": dict(value_type="ap[dp_sp]", ap_threshold_1=0.02),
    "sp-bs4-rowwise": dict(value_type="sp", block_vec_size=4,
                           vector_layout="rowwise"),
    "sp-rev3": dict(value_type="sp"),
    "dp-rev3": dict(value_type="dp"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_execute_uspmv_matches_jax_interface(case):
    kw = CASES[case]
    n_rep = 3 if case.endswith("rev3") else 1
    jh = jui.prepare(banded(jgen), C=1024, sigma=1, backend="cpu", **kw)
    th = tui.prepare(banded(tgen), C=1024, sigma=1, backend="cpu", **kw)
    if kw["value_type"].startswith("ap"):
        assert th.nnz_per_precision() == jh.nnz_per_precision()
        assert min(th.nnz_per_precision().values()) > 0
    bs = kw.get("block_vec_size", 1)
    x = np.random.default_rng(11).standard_normal(
        (th.n_rows, bs) if bs > 1 else th.n_rows)
    y_jax = jui.execute_uspmv(jh, x, n_repetitions=n_rep)
    y = tui.execute_uspmv(th, x, n_repetitions=n_rep)
    assert isinstance(y, np.ndarray) and y.shape == y_jax.shape == x.shape
    assert y.dtype == y_jax.dtype
    assert rel_err(y, y_jax) <= TOL[kw["value_type"]]


def test_device_resident_round_trip():
    m = banded(tgen)
    h = tui.prepare(m, C=32, sigma=64, value_type="dp", backend="cpu")
    x = np.random.default_rng(2).standard_normal(m.n_rows)
    xd = tui.upload_x(h, x)
    assert isinstance(xd, torch.Tensor) and xd.shape == (h.n_rows_padded,)
    assert tui._is_device_vector(xd) and not tui._is_device_vector(x)
    assert np.array_equal(tui.download_y(h, xd), x)
    for _ in range(3):
        xd = tui.execute_uspmv(h, xd, device_resident=True)
        assert isinstance(xd, torch.Tensor)
    A = m.to_scipy().tocsr()
    assert rel_err(tui.download_y(h, xd), A @ (A @ (A @ x))) <= 1e-12
    # the same three products as one repeated-SpMV call from the host
    y = tui.execute_uspmv(h, x, n_repetitions=3)
    assert np.array_equal(y, tui.download_y(h, xd))


@pytest.mark.parametrize("C,sigma", [(1, 1), (32, 8), (1024, 1)])
def test_spmv_reference_host_equals_jax(C, sigma):
    x = np.random.default_rng(4).standard_normal(2000)
    j = jui.spmv_reference_host(jui.convert_to_scs(banded(jgen), C, sigma), x)
    t = tui.spmv_reference_host(tui.convert_to_scs(banded(tgen), C, sigma), x)
    assert np.array_equal(j, t)
    assert rel_err(t, banded(tgen).to_scipy().tocsr() @ x) <= 1e-13


def test_reexports():
    for name in ("convert_to_scs", "partition_precisions",
                 "apply_permutation", "permute_scs_cols", "MtxData"):
        assert hasattr(tui, name), name
    assert tui.MtxData is MtxData


def test_cg_example_matches_jax_example():
    jcg = load_example("cg_solver").cg
    tcg = load_example("cg_solver_torch").cg
    jm, tm = jgen.laplace3d(12), tgen.laplace3d(12)
    x_true = np.random.default_rng(0).standard_normal(tm.n_rows)
    b = tm.to_scipy().tocsr() @ x_true
    jh = jui.prepare(jm, C=1024, sigma=1, value_type="sp", backend="cpu")
    th = tui.prepare(tm, C=1024, sigma=1, value_type="sp", backend="cpu")
    _, j_it, j_res = jcg(jh, b, tol=1e-6, maxiter=500)
    x, it, res = tcg(th, b, tol=1e-6, maxiter=500)
    batch = load_example("cg_solver_torch").BATCH
    assert abs(it - j_it) <= batch and it < 500
    assert res <= 1e-6 and j_res <= 1e-6
    assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-4


def test_cg_example_main_on_the_cpu(monkeypatch, capsys):
    mod = load_example("cg_solver_torch")
    monkeypatch.setattr("sys.argv", ["cg_solver_torch.py", "Laplace3D,12",
                                     "--backend", "cpu"])
    assert mod.main() == 0
    out = capsys.readouterr().out
    assert out.startswith("CG: ") and "torch-plain-scs-sp" in out
