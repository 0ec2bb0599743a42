"""The dp streams: -dp_emu and the adaptive-precision splits ap[dp_sp],
ap[dp_hp], ap[dp_sp_hp] through uspmv_tpu_torch's SpmvOperator on the CPU.

The port runs -dp_emu as native f64 and accumulates every stream of an
ap[dp_*] split in f64. Each case is held against
  (a) the JAX operator without -dp_emu (its XLA path, f64 sums):
      1e-12 x max|y|, the same f64 arithmetic in another order;
  (b) the JAX operator with -dp_emu (the df64 lane-tile kernel in Pallas
      interpret mode): 1e-6 x max|y|, because the JAX package sums the
      sp/hp partials in f32 against the hi part of x;
  (c) scipy in f64 on the partitioned, rounded sub-matrices summed:
      1e-12 x max|y|.
"""

import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.runtime.operator import SpmvOperator as JOperator

from uspmv_tpu_torch import cli
from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.formats.coo import MtxData
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops.vectors import init_x_host
from uspmv_tpu_torch.runtime.operator import SpmvOperator
from uspmv_tpu_torch.runtime.validate import validate_solve

# name -> (generator, args, config fields)
CASES = {
    "dp-laplace3d(12)": ("laplace3d", (12,), dict(value_type="dp")),
    "ap[dp_sp]-laplace3d(12)": ("laplace3d", (12,), dict(
        value_type="ap[dp_sp]", ap_threshold_1=2.44)),
    "ap[dp_hp]-laplace3d(12)": ("laplace3d", (12,), dict(
        value_type="ap[dp_hp]", ap_threshold_1=2.44)),
    "dp-wide_spectrum(6)": ("wide_spectrum", (6,), dict(value_type="dp")),
    "ap[dp_sp]-wide_spectrum(6)": ("wide_spectrum", (6,), dict(
        value_type="ap[dp_sp]", ap_threshold_1=1e-2)),
    "ap[dp_hp]-wide_spectrum(6)": ("wide_spectrum", (6,), dict(
        value_type="ap[dp_hp]", ap_threshold_1=1e-2)),
    "ap[dp_sp_hp]-wide_spectrum(6)": ("wide_spectrum", (6,), dict(
        value_type="ap[dp_sp_hp]", ap_threshold_1=1e-2,
        ap_threshold_2=1e-5)),
}
TOL = {"jax-xla": 1e-12, "jax-df64": 1e-6, "scipy": 1e-12}


def config(cls, **kw):
    return cls(**{"kernel_format": "scs", "chunk_size": 1024, "sigma": 1,
                  "backend": "cpu", **kw})


def jax_operator(gen, args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JOperator.from_mtx(config(JConfig, **kw),
                                  getattr(jgen, gen)(*args))


@pytest.fixture(scope="module")
def port():
    cache = {}

    def get(name):
        if name not in cache:
            gen, args, kw = CASES[name]
            cache[name] = SpmvOperator.from_mtx(
                config(Config, dp_emulation=True, **kw),
                getattr(tgen, gen)(*args))
        return cache[name]

    return get


def x_host(n):
    return np.random.default_rng(5).standard_normal(n)


def rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("against", sorted(TOL))
@pytest.mark.parametrize("name", sorted(CASES))
def test_dp_streams_match(port, name, against):
    op = port(name)
    gen, args, kw = CASES[name]
    x = x_host(op.n_rows)
    xd = op.make_x(x)
    assert str(xd.dtype) == "torch.float64" and xd.shape == (op.n_rows_padded,)
    y = op.to_host(op.spmv(xd))
    assert y.dtype == np.float64
    assert op.impl_name() == f"torch-plain-scs-{kw['value_type']}"
    if against == "scipy":
        A = None
        for s in op.scs.values():
            # the sub-matrix in original indices, values as rounded
            rows = s.new_to_old_idx[s.flat_row_idx()]
            cols = s.new_to_old_idx[s.col_idxs]
            keep = rows >= 0
            sub = MtxData.from_arrays(rows[keep], cols[keep],
                                      s.values[keep].astype(np.float64),
                                      op.n_rows, op.n_rows).to_scipy()
            A = sub if A is None else A + sub
        ref = A.tocsr() @ x
    else:
        jop = jax_operator(gen, args, dp_emulation=(against == "jax-df64"),
                           **kw)
        ref = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
        assert ref.dtype == np.float64
    assert rel(y, ref) <= TOL[against]


def test_ap_dp_streams_are_all_nonempty(port):
    npp = port("ap[dp_sp_hp]-wide_spectrum(6)").nnz_per_precision()
    assert list(npp) == ["dp", "sp", "hp"] and min(npp.values()) > 0
    npp = port("ap[dp_sp]-laplace3d(12)").nnz_per_precision()
    # the 6.0 diagonal goes to dp, the -1 off-diagonals to sp
    assert npp == {"dp": 12**3, "sp": 11232 - 12**3}


SCALINGS = {
    "equilibrate": dict(equilibrate=True),
    "jacobi_scale": dict(jacobi_scale=True),
    "both": dict(equilibrate=True, jacobi_scale=True),
}


@pytest.mark.parametrize("scaling", sorted(SCALINGS))
def test_scalings_match_jax(scaling):
    kw = dict(value_type="ap[dp_sp]", ap_threshold_1=0.3, **SCALINGS[scaling])
    jop = jax_operator("wide_spectrum", (6,), **kw)
    op = SpmvOperator.from_mtx(config(Config, **kw), tgen.wide_spectrum(6))
    assert op.nnz_per_precision() == jop.nnz_per_precision()
    assert (op.jacobi_diag is None) == (jop.jacobi_diag is None)
    if op.jacobi_diag is not None:
        assert np.array_equal(op.jacobi_diag, jop.jacobi_diag)
    assert (op.equilib is None) == (jop.equilib is None)
    if op.equilib is not None:
        for a, b in zip(op.equilib, jop.equilib):
            assert np.array_equal(a, b)
    x = x_host(op.n_rows)
    y = op.to_host(op.spmv(op.make_x(x)))
    ref = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
    assert rel(y, ref) <= 1e-12


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("value_type",
                         ["ap[dp_sp]", "ap[dp_hp]", "ap[sp_hp]",
                          "ap[dp_sp_hp]"])
def test_ap_metrics_match_jax(value_type, dropout):
    kw = dict(value_type=value_type, ap_threshold_1=1e-2,
              ap_threshold_2=1e-5, dropout=dropout, dropout_threshold=1e-6)
    jop = jax_operator("wide_spectrum", (5,), **kw)
    op = SpmvOperator.from_mtx(config(Config, **kw), tgen.wide_spectrum(5))
    assert op.nnz == jop.nnz
    assert op.flops_per_spmv() == jop.flops_per_spmv()
    assert op.nnz_per_precision() == jop.nnz_per_precision()
    assert op.n_dropped == jop.n_dropped and (op.n_dropped > 0) == dropout
    assert op.beta() == jop.beta()


@pytest.mark.parametrize("value_type",
                         ["ap[dp_sp]", "ap[dp_hp]", "ap[sp_hp]",
                          "ap[dp_sp_hp]"])
def test_ap_validate_solve_ok(value_type):
    mtx = tgen.wide_spectrum(6)
    op = SpmvOperator.from_mtx(
        config(Config, value_type=value_type, ap_threshold_1=1e-2,
               ap_threshold_2=1e-5), mtx)
    x0 = init_x_host(op.config, op.n_rows, op.matrix_stats)
    _, y = op.solve(op.make_x(x0), 5)
    rep = validate_solve(mtx, x0, op.to_host(y), 5, value_type=value_type,
                         hp_nnz_fraction=op.hp_nnz_fraction())
    assert rep.flag == "OK", rep.summary()


CLI_RUNS = {
    "ap-solve": (["Laplace3D,12", "scs", "-c", "32", "-s", "8",
                  "-ap_value_type", "ap[dp_sp]", "-apt1", "2.44", "-mode",
                  "s", "-rev", "3"], "[OK]"),
    "ap-ref-spelling-dp_emu-solve": (
        ["Laplace3D,12", "scs", "-c", "1024", "-s", "1", "-ap[dp_sp]",
         "-apt1", "2.44", "-dp_emu", "1", "-mode", "s", "-rev", "5"], "[OK]"),
    "equilibrate-solve": (["WideSpectrum,5", "crs", "-ap[dp_sp_hp]",
                           "-apt1", "0.01", "-apt2", "0.00001",
                           "-equilibrate", "1", "-mode", "s"], "[OK]"),
    "jacobi-solve": (["FemTet3D,5", "scs", "-c", "32", "-s", "32", "-dp",
                      "-jacobi_scale", "1", "-mode", "s", "-rev", "3"],
                     "[OK]"),
    "dropout-bench": (["WideSpectrum,4", "scs", "-c", "32", "-ap[dp_hp]",
                       "-apt1", "0.01", "-do", "1", "-dt", "1e-7", "-mode",
                       "b", "-bench_time", "0.001"], "n_dropped="),
}


@pytest.mark.parametrize("run", sorted(CLI_RUNS))
def test_cli_ap_runs(run, tmp_path, capsys):
    argv, expect = CLI_RUNS[run]
    rc = cli.main(argv + ["-backend", "cpu", "-mtx_out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert expect in out


def test_cli_equilibrate_validates_against_scaled_oracle(tmp_path, capsys):
    """Without scaling the oracle, an equilibrated result fails
    validation: the CLI must hold it against the scaled matrix."""
    argv = ["WideSpectrum,5", "scs", "-c", "32", "-s", "1", "-dp",
            "-equilibrate", "1", "-mode", "s", "-rev", "2", "-backend",
            "cpu", "-mtx_out", str(tmp_path), "-json"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert '"flag": "OK"' in out
    cfg = config(Config, value_type="dp", equilibrate=True)
    mtx = tgen.wide_spectrum(5)
    op = SpmvOperator.from_mtx(cfg, mtx)
    x0 = init_x_host(cfg, op.n_rows, op.matrix_stats)
    _, y = op.solve(op.make_x(x0), 2)
    assert validate_solve(mtx, x0, op.to_host(y), 2).flag == "ERROR"
