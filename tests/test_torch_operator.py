"""The ported main path as a whole: uspmv_tpu_torch's SpmvOperator, harness
and CLI against the JAX package's SpmvOperator on the CPU (the port runs
its plain PyTorch version there; the JAX package runs its lane-tile kernel
in Pallas interpret mode for sp and its XLA path for dp)."""

import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.runtime.operator import SpmvOperator as JOperator

from uspmv_tpu_torch import cli
from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.formats.scs import scs_from_reference
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops.device_format import GROUP_ROWS, group_table
from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator
from uspmv_tpu_torch.runtime.bench import bench_spmv
from uspmv_tpu_torch.runtime.operator import (
    DeviceUnavailableError,
    SpmvOperator,
)
from uspmv_tpu_torch.runtime.validate import validate_solve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATRICES = {
    "laplace3d(12)": ("laplace3d", (12,)),
    "random_banded(3000,40,9)": ("random_banded", (3000, 40, 9)),
}
# relative to max|y|: sp accumulates in f32 in another order than the
# lane tiles; dp runs the same f64 sums up to order
TOL = {"sp": 1e-5, "dp": 1e-12}


def headline_config(cls, value_type):
    return cls(kernel_format="scs", chunk_size=1024, sigma=1,
               value_type=value_type, backend="cpu")


@pytest.fixture(scope="module")
def operators():
    """(JAX operator, port operator, JAX matrix, port matrix) per case."""
    cache = {}

    def get(name, value_type):
        key = (name, value_type)
        if key not in cache:
            gen, args = MATRICES[name]
            jm = getattr(jgen, gen)(*args)
            tm = getattr(tgen, gen)(*args)
            cache[key] = (
                JOperator.from_mtx(headline_config(JConfig, value_type), jm),
                SpmvOperator.from_mtx(headline_config(Config, value_type), tm),
                jm, tm,
            )
        return cache[key]

    return get


def rel_err(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def x_host(n):
    return np.random.default_rng(7).standard_normal(n)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("value_type", ["sp", "dp"])
def test_spmv_matches_jax_operator(operators, name, value_type):
    jop, op, jm, _ = operators(name, value_type)
    x = x_host(jm.n_rows)
    y_jax = jop.to_host(jop.spmv(jop.make_x(x)))
    y = op.to_host(op.spmv(op.make_x(x)))
    assert y.dtype == y_jax.dtype and y.shape == (jm.n_rows,)
    assert rel_err(y, y_jax) <= TOL[value_type]


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("value_type", ["sp", "dp"])
def test_solve_matches_jax_operator(operators, name, value_type):
    jop, op, jm, _ = operators(name, value_type)
    x = x_host(jm.n_rows)
    jx, jy = jop.solve(jop.make_x(x), 3)
    tx, ty = op.solve(op.make_x(x), 3)
    assert rel_err(op.to_host(tx), jop.to_host(jx)) <= TOL[value_type]
    assert rel_err(op.to_host(ty), jop.to_host(jy)) <= TOL[value_type]


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_beta_and_metrics_match_jax(operators, name):
    jop, op, _, _ = operators(name, "sp")
    assert op.beta() == jop.beta()
    assert op.nnz == jop.nnz
    assert op.flops_per_spmv() == jop.flops_per_spmv()
    assert op.nnz_per_precision() == jop.nnz_per_precision()
    (scs,), (dev,) = op.scs.values(), op.devs.values()
    # the kernel reads each group of GROUP_ROWS rows up to its longest row:
    # the table and the slots read from the JAX operator's row counts
    table, read = group_table(jop.scs["sp"])
    assert np.array_equal(dev.group_lengths.numpy(), table)
    assert op.device_beta() == {"sp": scs.nnz / read}
    xy = 4 * 2 * scs.n_rows_padded
    if not table.size:
        # the chunk form: values + int32 columns of every slot and
        # chunk_ptrs/lengths are streamed
        assert read == scs.n_elements
        assert op.bytes_per_spmv() == 4 * (2 * scs.n_elements
                                           + 2 * scs.n_chunks + 1) + xy
    else:
        # values + int32 columns of the slots read, chunk_ptrs, a uint8
        # length per group of GROUP_ROWS rows, x + y, all f32/int32
        assert read < scs.n_elements and table.dtype == np.uint8
        assert table.size == scs.n_rows_padded // GROUP_ROWS
        assert op.bytes_per_spmv() == 4 * (2 * read + scs.n_chunks + 1) + (
            table.size) + xy
    assert op.impl_name() == "torch-plain-scs-sp"


def test_from_scs_runs_jax_arrays(operators):
    from uspmv_tpu.formats.scs import convert_to_scs, permute_scs_cols

    jop, op, jm, _ = operators("random_banded(3000,40,9)", "sp")
    jscs = convert_to_scs(jm.astype(np.float32), 1024, 1, native=False)
    perm = np.arange(jscs.n_rows_padded, dtype=np.int32)
    perm[: jscs.n_rows] = jscs.old_to_new_idx
    permute_scs_cols(jscs, perm)
    op2 = SpmvOperator.from_scs(
        headline_config(Config, "sp"),
        scs_from_reference(dataclasses.asdict(jscs)),
        op.matrix_stats, jm.nnz, torch.device("cpu"),
    )
    x = x_host(jm.n_rows)
    assert np.array_equal(op2.to_host(op2.spmv(op2.make_x(x))),
                          op.to_host(op.spmv(op.make_x(x))))


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("value_type", ["sp", "dp"])
def test_validate_solve_ok(operators, name, value_type):
    from uspmv_tpu_torch.ops.vectors import init_x_host

    _, op, _, tm = operators(name, value_type)
    # the CLI's solve-mode x (DefaultValues.x): the per-element flags
    # would trip on near-cancelling rows of a random x in sp
    x0 = init_x_host(op.config, op.n_rows, op.matrix_stats)
    _, y = op.solve(op.make_x(x0), 3)
    rep = validate_solve(tm, x0, op.to_host(y), 3, value_type=value_type)
    assert rep.flag == "OK", rep.summary()


def test_bench_spmv_reports_finite_rate(operators):
    _, op, _, _ = operators("laplace3d(12)", "sp")
    res = bench_spmv(op, bench_time=1e-3, warmup=1, start_iters=2,
                     timing_reps=2)
    assert np.isfinite(res.perf_gflops) and res.perf_gflops > 0
    assert np.isfinite(res.effective_gbps) and res.effective_gbps > 0
    assert res.platform == "cpu" and res.impl == "torch-plain-scs-sp"
    assert len(res.timing_samples_s) == 2


def test_cli_solve_validates(tmp_path, capsys):
    rc = cli.main(["Laplace3D,8", "scs", "-c", "32", "-s", "8", "-sp",
                   "-backend", "cpu", "-mode", "s", "-rev", "3",
                   "-validate", "1", "-mtx_out", str(tmp_path)])
    assert rc == 0
    assert "[OK]" in capsys.readouterr().out
    assert (tmp_path / "spmv_scipy_compare_sp.txt").exists()


def test_cli_bench_reads_mtx(tmp_path, capsys):
    from uspmv_tpu_torch.io.mmio import write_mtx

    path = tmp_path / "m.mtx"
    write_mtx(str(path), tgen.laplace2d(12))
    rc = cli.main([str(path), "crs", "-dp", "-backend", "cpu", "-mode", "b",
                   "-bench_time", "0.001", "-mtx_out", str(tmp_path)])
    assert rc == 0
    assert "GFLOP/s" in capsys.readouterr().out
    assert (tmp_path / "spmv_bench.jsonl").exists()


def test_cuda_backend_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="no CUDA device"):
        SpmvOperator.from_mtx(Config(kernel_format="crs", value_type="sp"),
                              tgen.tridiag(10))


def test_cli_cuda_backend_without_a_card_exits_3(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["Tridiag,10", "crs", "-sp"]) == 3
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("ERROR:")


def test_one_device_operator_refuses_shards():
    cfg = Config(value_type="dp", backend="cpu", n_shards=2)
    with pytest.raises(ValueError, match="DistributedSpmvOperator"):
        SpmvOperator.from_mtx(cfg, tgen.tridiag(10))


# configurations of slices 2, 5, 9 and 10 that raised before they were
# ported (n_shards > 1 through the sharded operator; impl='bcoo', 'xla' and
# use_pallas=False through the plain route on this operator, as in JAX)
PORTED = {
    "bcoo": dict(impl="bcoo"),
    "xla": dict(impl="xla"),
    "no_pallas": dict(use_pallas=False),
    "shards": dict(n_shards=2),
    "split": dict(split_rows_threshold=16),
    "mixed_tiles": dict(mixed_tiles=True),
    "ap": dict(value_type="ap[dp_sp]", ap_threshold_1=1.5),
    "hp": dict(value_type="hp"),
    "spmmv": dict(block_vec_size=4),
    "dp_emu": dict(dp_emulation=True),
    "equilibrate": dict(equilibrate=True),
    "jacobi_scale": dict(jacobi_scale=True),
}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_configs_run(name):
    cfg = Config(**{"value_type": "dp", "backend": "cpu", **PORTED[name]})
    mtx = tgen.tridiag(10)
    op = (DistributedSpmvOperator if cfg.n_shards > 1
          else SpmvOperator).from_mtx(cfg, mtx)
    x = np.arange(1.0, 11.0)
    if cfg.block_vec_size > 1:
        x = np.repeat(x[:, None], cfg.block_vec_size, axis=1)
    y = op.to_host(op.spmv(op.make_x(x)))
    A = mtx.to_scipy().tocsr()
    if cfg.jacobi_scale:
        A = A / 2.0  # the diagonal of tridiag(10)
    if cfg.equilibrate:
        from uspmv_tpu_torch.formats.coo import equilibrate_matrix

        m = mtx.copy()
        equilibrate_matrix(m)
        A = m.to_scipy().tocsr()
    ref = A @ x
    assert y.shape == ref.shape
    assert np.abs(y - ref).max() <= 1e-6 * np.abs(ref).max()


def heavy_row_coo(heavy: bool):
    """30,000 rows of 3 nnz; with ``heavy``, row 12,345 holds 20,000."""
    rng = np.random.default_rng(11)
    n = 30_000
    rows = np.repeat(np.arange(n), 3)
    cols = rng.integers(0, n, rows.size)
    if heavy:
        rows = np.concatenate([rows, np.full(20_000, 12_345)])
        cols = np.concatenate([cols, rng.permutation(n)[:20_000]])
    key, first = np.unique(rows.astype(np.int64) * n + cols,
                           return_index=True)
    return rows[first], cols[first], rng.standard_normal(first.size), n


@pytest.mark.parametrize("heavy", [True, False])
def test_scs_explosion_guard_matches_jax(heavy):
    """One 20,000-nnz row at C=1024 would pad its chunk 20M elements: both
    packages fall back to CRS with the same warning (both with the
    heavy-row split off, which would bound that row); without it both keep
    the user's (C, sigma)."""
    from uspmv_tpu.formats.coo import MtxData as JMtxData

    from uspmv_tpu_torch.formats.coo import MtxData

    I, J, V, n = heavy_row_coo(heavy)
    kw = dict(kernel_format="scs", chunk_size=1024, sigma=1, value_type="dp",
              backend="cpu", split_rows_threshold=-1, mixed_tiles=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jop = JOperator.from_mtx(JConfig(**kw),
                                 JMtxData.from_arrays(I, J, V, n, n))
        op = SpmvOperator.from_mtx(Config(**kw),
                                   MtxData.from_arrays(I, J, V, n, n))
    guard = [str(w.message) for w in caught
             if "falling back to CRS" in str(w.message)]
    assert len(guard) == (2 if heavy else 0)
    assert len(set(guard)) <= 1  # the same message
    for p, js in jop.scs.items():
        ts = op.scs[p]
        assert (ts.C, ts.sigma) == (js.C, js.sigma)
        assert (ts.C, ts.sigma) == ((1, 1) if heavy else (1024, 1))
        assert ts.n_elements == js.n_elements
    x = np.random.default_rng(2).standard_normal(n)
    y = op.to_host(op.spmv(op.make_x(x)))
    ref = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
    assert np.abs(y - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("flags", [
    ["-n_processes", "2"], ["-coordinator", "localhost:1234"],
    ["-process_id", "0"], ["-local_devices", "2"]])
def test_cli_unported_flags_raise(flags, monkeypatch, tmp_path):
    """The multi-host flags are ported (slice 11). Without their partners
    they raise the JAX package's ValueError before any process group
    starts (a process count or id needs a coordinator, a coordinator
    needs both); -local_devices alone runs the one process."""
    import torch.distributed as dist

    for var in ("USPMV_COORDINATOR", "USPMV_N_PROCESSES", "USPMV_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    argv = ["Tridiag,10", "crs", "-backend", "cpu", "-mode", "s",
            "-mtx_out", str(tmp_path), *flags]
    if flags[0] == "-local_devices":
        assert cli.main(argv) == 0
    else:
        with pytest.raises(ValueError, match="-coordinator"):
            cli.main(argv)
    assert not dist.is_initialized()


# CLI flags of slice 10 that raised before they were ported
PORTED_FLAGS = {
    "-matrix_stats": (["-matrix_stats"], "matrix: 10 x 10, nnz 28"),
    "-output_sparsity": (["-output_sparsity"], "dp_local_scs.mtx"),
    "-debug": (["-debug", "1", "-mode", "s"], "[debug] sanity dumps"),
    "-log_prof": (["-log_prof", "PROF", "-bench_time", "0.001"],
                  "[log_prof] trace ->"),
    "-impl bcoo": (["-impl", "bcoo", "-mode", "s"], "torch-csr-dp"),
    "-impl xla": (["-impl", "xla", "-mode", "s"], "torch-plain-scs-dp"),
}


@pytest.mark.parametrize("name", sorted(PORTED_FLAGS))
def test_cli_ported_flags_run(name, tmp_path, capsys):
    flags, expect = PORTED_FLAGS[name]
    flags = [str(tmp_path / "prof") if f == "PROF" else f for f in flags]
    assert cli.main(["Tridiag,10", "crs", "-backend", "cpu", "-mtx_out",
                     str(tmp_path), *flags]) == 0
    assert expect in capsys.readouterr().out


def test_package_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import uspmv_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'uspmv_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('bench_torch',"
        " 'bench_torch.py')\n"
        "bt = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(bt)\n"
        "assert bt.run(bt.CASES, emit=lambda rec: None) == 3\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(k.split('.')[0] == 'uspmv_tpu' for k in sys.modules)\n"
        "print('ok', len([k for k in sys.modules if k.startswith('uspmv_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")
