"""The vendor comparison path (-impl bcoo) and the plain path (-impl xla,
use_pallas=False) of uspmv_tpu_torch against the JAX package, on the CPU.

``BcooSpmvOperator`` runs PyTorch's CSR product (cuSPARSE on the card)
against the JAX ``BcooSpmvOperator`` (jax.experimental.sparse BCOO) and
scipy in f64; the plain route of ``SpmvOperator`` and
``DistributedSpmvOperator`` against the JAX operators' XLA path. Same
matrix, same x (numpy, from a seed), compared through ``to_host``.

Tolerances, max|y - ref| / max|ref|, the reference's unit tolerances
(runtime/validate.py:20-24): 1e-13 dp, 1e-5 sp, 1e-2 hp; against the JAX
operator hp is held at sp's 1e-5 (both multiply the same bf16-rounded
values in f32).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.ops.spmv_bcoo import BcooSpmvOperator as JBcoo
from uspmv_tpu.parallel.distributed import (
    DistributedSpmvOperator as JDistributed,
)
from uspmv_tpu.runtime.operator import SpmvOperator as JOperator

from uspmv_tpu_torch import cli
from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.io.mmio import read_mtx
from uspmv_tpu_torch.ops.spmv_bcoo import BcooSpmvOperator
from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator
from uspmv_tpu_torch.runtime import operator as top
from uspmv_tpu_torch.runtime.bench import bench_spmv
from uspmv_tpu_torch.runtime.operator import SpmvOperator

TOL = {"dp": 1e-13, "sp": 1e-5, "hp": 1e-2}
JAX_TOL = {"dp": 1e-13, "sp": 1e-5, "hp": 1e-5}


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def matrices():
    return (jgen.random_imbalanced(900, 7, seed=4),
            tgen.random_imbalanced(900, 7, seed=4))


SHAPES = [("rowwise", 1), ("rowwise", 4), ("colwise", 4)]


@pytest.mark.parametrize("layout,bs", SHAPES)
@pytest.mark.parametrize("value_type", ["dp", "sp", "hp"])
def test_bcoo_matches_jax_bcoo_and_scipy(value_type, layout, bs):
    jm, tm = matrices()
    kw = dict(value_type=value_type, block_vec_size=bs, vector_layout=layout,
              impl="bcoo", backend="cpu")
    jop = JBcoo.from_mtx(JConfig(**kw), jm)
    op = BcooSpmvOperator.from_mtx(Config(**kw), tm)
    assert op.impl_name() == f"torch-csr-{value_type}"
    x = np.random.default_rng(1).standard_normal(
        (tm.n_rows, bs) if bs > 1 else tm.n_rows)
    xd = op.make_x(x)
    assert xd.dtype == op.working_dtype
    assert xd.shape == ((bs, tm.n_rows) if layout == "colwise" and bs > 1
                        else x.shape)
    y = op.to_host(op.spmv(xd))
    y_jax = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
    assert y.shape == y_jax.shape == x.shape
    assert y.dtype == y_jax.dtype
    assert rel(y, y_jax) <= JAX_TOL[value_type]
    ref = tm.to_scipy().tocsr() @ x
    assert rel(y, ref) <= TOL[value_type]
    # with out: the same product written into the caller's buffer
    out = torch.empty_like(xd)
    assert op.spmv(xd, out=out) is out
    assert np.array_equal(op.to_host(out), y)


@pytest.mark.parametrize("value_type", ["dp", "sp", "hp"])
def test_bcoo_accounting_equals_jax(value_type):
    jm, tm = matrices()
    for bs, layout in ((1, "colwise"), (4, "rowwise")):
        kw = dict(value_type=value_type, block_vec_size=bs,
                  vector_layout=layout, impl="bcoo", backend="cpu")
        jop = JBcoo.from_mtx(JConfig(**kw), jm)
        op = BcooSpmvOperator.from_mtx(Config(**kw), tm)
        assert op.flops_per_spmv() == jop.flops_per_spmv()
        assert op.bytes_per_spmv() == jop.bytes_per_spmv()
        assert op.beta() == jop.beta() == {value_type: 1.0}
        assert op.device_beta() == jop.device_beta()
        assert op.nnz_per_precision() == jop.nnz_per_precision()
        assert op.hp_nnz_fraction() == 1.0
        assert op.matrix_stats == jop.matrix_stats


@pytest.mark.parametrize("value_type", ["dp", "sp", "hp"])
def test_bcoo_solve_matches_jax_and_is_a_loop(value_type):
    jm, tm = matrices()
    tm.values[:] *= 0.2  # keep the iterates bounded
    jm.values[:] *= 0.2
    kw = dict(value_type=value_type, impl="bcoo", backend="cpu")
    jop = JBcoo.from_mtx(JConfig(**kw), jm)
    op = BcooSpmvOperator.from_mtx(Config(**kw), tm)
    x = np.random.default_rng(2).standard_normal(tm.n_rows)
    assert op.solve_impl_name(5) == "loop"
    prev, y = op.solve(op.make_x(x), 5)
    jprev, jy = jop.solve(jop.make_x(x), 5)
    assert rel(op.to_host(y), np.asarray(jy)) <= JAX_TOL[value_type]
    assert rel(op.to_host(prev), np.asarray(jprev)) <= JAX_TOL[value_type]
    with pytest.raises(ValueError, match="loop"):
        op.solve(op.make_x(x), 2, impl="graph")


@pytest.mark.parametrize("kw", [
    dict(value_type="ap[dp_sp]", ap_threshold_1=1.0),
    dict(value_type="sp", n_shards=2),
])
def test_bcoo_refusals_alike(kw):
    jm, tm = matrices()
    kw = dict(kw, impl="bcoo", backend="cpu")
    with pytest.raises(ValueError) as jerr:
        JBcoo.from_mtx(JConfig(**kw), jm)
    with pytest.raises(ValueError) as terr:
        BcooSpmvOperator.from_mtx(Config(**kw), tm)
    assert str(terr.value) == str(jerr.value)


def test_bcoo_through_the_cli(tmp_path, capsys):
    base = ["RandomBanded,400,20,7", "crs", "-impl", "bcoo", "-backend",
            "cpu", "-mtx_out", str(tmp_path)]
    assert cli.main(base + ["-sp", "-mode", "s", "-rev", "3"]) == 0
    out = capsys.readouterr().out
    assert "solve-loop[torch-csr-sp]" in out and "[OK]" in out
    assert cli.main(base + ["-hp", "-mode", "b", "-bench_time", "0.001",
                            "-json"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["impl"] == "torch-csr-hp" and res["per_shard"] is None
    assert res["perf_gflops"] > 0 and res["comm_volume_elems"] == 0
    # -output_sparsity: the matrix as stored, in its value type
    assert cli.main(base + ["-dp", "-output_sparsity"]) == 0
    m = read_mtx(str(tmp_path / "dp_local_scs.mtx"), native=False)
    ref = tgen.generate_matrix("RandomBanded,400,20,7")
    assert np.array_equal(m.I, ref.I) and np.array_equal(m.J, ref.J)
    # 16 significant digits, as the reference writes them
    assert (np.abs(m.values - ref.values) <= 1e-15 * np.abs(ref.values)).all()


def test_bcoo_bench_result(tmp_path):
    _, tm = matrices()
    op = BcooSpmvOperator.from_mtx(
        Config(value_type="sp", impl="bcoo", backend="cpu"), tm)
    res = bench_spmv(op, bench_time=0.001, warmup=2)
    assert res.impl == "torch-csr-sp" and res.nnz == tm.nnz
    assert res.memory_footprint_bytes == op.bytes_per_spmv()
    assert res.n_pieces == 0 and res.split_rows_threshold == 0
    assert res.comm_volume_elems == 0 and res.per_shard is None


# --------------------------------------------------------- the plain route

PLAIN = {
    "xla-sp-scs": dict(impl="xla", value_type="sp", chunk_size=8, sigma=16),
    "xla-dp-crs": dict(impl="xla", value_type="dp", kernel_format="crs"),
    "no_pallas-hp": dict(use_pallas=False, value_type="hp", chunk_size=32),
    "xla-ap": dict(impl="xla", value_type="ap[dp_sp]", ap_threshold_1=1.0,
                   chunk_size=8),
    "xla-split": dict(impl="xla", value_type="sp", chunk_size=32,
                      split_rows_threshold=8),
    "xla-rowwise": dict(impl="xla", value_type="sp", chunk_size=8,
                        block_vec_size=4, vector_layout="rowwise"),
    "xla-colwise": dict(impl="xla", value_type="dp", chunk_size=8,
                        block_vec_size=4, vector_layout="colwise"),
}


@pytest.mark.parametrize("case", sorted(PLAIN))
def test_plain_route_matches_jax_xla_operator(case):
    jm, tm = matrices()
    kw = dict(kernel_format="scs", backend="cpu")
    kw.update(PLAIN[case])
    cfg = Config(**kw)
    assert not top.uses_kernels(cfg)
    op = SpmvOperator.from_mtx(cfg, tm)
    jop = JOperator.from_mtx(JConfig(**kw), jm)
    assert op.plain and op.impl_name().startswith("torch-plain-")
    assert op.solve_impl_name(3) == "loop"
    assert not op.fused_solve_eligible()
    bs = cfg.block_vec_size
    x = np.random.default_rng(3).standard_normal(
        (tm.n_rows, bs) if bs > 1 else tm.n_rows)
    y = op.to_host(op.spmv(op.make_x(x)))
    y_jax = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
    low = cfg.ap_precisions[-1]
    assert rel(y, y_jax) <= (1e-12 if low == "dp" else 1e-5)
    assert rel(y, tm.to_scipy().tocsr() @ x) <= (
        1e-12 if low == "dp" else TOL[low] if low == "hp" else 1e-5)
    # the same result as the default route on the CPU, bit for bit: both
    # run the plain versions there
    auto = SpmvOperator.from_mtx(
        dataclasses.replace(cfg, impl="auto", use_pallas=True), tm)
    assert np.array_equal(auto.to_host(auto.spmv(auto.make_x(x))), y)


@pytest.mark.parametrize("impl", ["xla", "bcoo"])
def test_sharded_plain_route_matches_jax(impl):
    jm, tm = jgen.laplace2d(20), tgen.laplace2d(20)
    kw = dict(kernel_format="scs", chunk_size=8, value_type="sp",
              backend="cpu", n_shards=4, impl=impl)
    op = DistributedSpmvOperator.from_mtx(Config(**kw), tm)
    jop = JDistributed.from_mtx(JConfig(use_pallas=False, **kw), jm)
    assert op.plain and op.impl_name().startswith("torch-plain-dist4-")
    x = np.random.default_rng(5).standard_normal(tm.n_rows)
    y = op.to_host(op.spmv(op.make_x(x)))
    y_jax = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
    assert rel(y, y_jax) <= 1e-5


def test_cli_xla_route(tmp_path, capsys):
    rc = cli.main(["Laplace2D,16", "scs", "-c", "8", "-sp", "-impl", "xla",
                   "-mode", "s", "-rev", "3", "-backend", "cpu",
                   "-mtx_out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "solve-loop[torch-plain-scs-sp]" in out
    assert "[OK]" in out
