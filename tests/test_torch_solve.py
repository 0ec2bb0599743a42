"""Solve mode of uspmv_tpu_torch against the JAX package on the CPU.

The port's fused solve wrapper ``solve_scs`` runs its plain version here (k
plain SpMVs with a swap); it must agree with the TPU kernel
``solve_lane_tiles`` (Pallas interpret mode) on the very same SCS arrays,
and ``SpmvOperator.solve`` with the JAX operator's ``solve`` with and
without its ``USPMV_FUSED_SOLVE`` opt-in. The CUDA kernel and the CUDA-graph
path are checked on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.formats.scs import convert_to_scs as j_convert
from uspmv_tpu.formats.scs import permute_scs_cols as j_permute
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.ops.pallas_scs import (
    build_device_lane_tiles,
    solve_lane_tiles,
    solve_tiles_fit,
)
from uspmv_tpu.runtime.operator import SpmvOperator as JOperator

from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.formats.scs import scs_from_reference
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops import _build, scs_solve
from uspmv_tpu_torch.ops.device_format import build_device_scs
from uspmv_tpu_torch.ops.scs_solve import solve_fits, solve_scs, solve_scs_plain
from uspmv_tpu_torch.ops.scs_spmv import spmv_scs
from uspmv_tpu_torch.runtime.bench import bench_solve
from uspmv_tpu_torch.runtime.operator import SpmvOperator
from uspmv_tpu_torch.runtime.validate import validate_solve

CPU = torch.device("cpu")
# relative to max|y|: f32 sums in another order than the lane tiles, over k
# steps; f64 sums differ in order only
TOL = {"sp": 1e-5, "dp": 1e-12}


def scaled(mtx, factor):
    mtx.values[:] = mtx.values * factor
    return mtx


def banded(gen):
    """random_banded(1500, 40, 7, seed=11) scaled so A^k x stays in f32
    range (the case of tests/test_pallas.py)."""
    m = gen.random_banded(1500, 40, 7, seed=11)
    return scaled(m, 0.05 / np.abs(m.values).max())


def jax_scs(mtx, dtype=np.float32):
    """The JAX package's SCS at C=1024, sigma=1 with the symmetric column
    permutation applied, as its operator builds it."""
    scs = j_convert(mtx.astype(dtype), 1024, 1, native=False)
    perm = np.arange(scs.n_rows_padded, dtype=np.int32)
    perm[: scs.n_rows] = scs.old_to_new_idx
    j_permute(scs, perm)
    return scs


def rel_err(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


# ------------------------------------------------ the wrapper vs the kernel


@pytest.mark.parametrize("k", [1, 2, 5])
def test_plain_matches_solve_lane_tiles(k):
    jscs = jax_scs(banded(jgen))
    jdev = build_device_lane_tiles(jscs)
    assert solve_tiles_fit(jdev, 1)
    x0 = np.random.default_rng(0).standard_normal(
        jscs.n_rows_padded).astype(np.float32)
    j_prev, j_fin = solve_lane_tiles(jdev, jnp.asarray(x0), k, interpret=True)
    dev = build_device_scs(scs_from_reference(dataclasses.asdict(jscs)), CPU)
    prev, fin = solve_scs(dev, torch.from_numpy(x0), k)
    assert fin.dtype == torch.float32 and fin.shape == (jscs.n_rows_padded,)
    rows = jscs.old_to_new_idx
    assert rel_err(fin.numpy()[rows], np.asarray(j_fin)[rows]) <= TOL["sp"]
    assert rel_err(prev.numpy()[rows], np.asarray(j_prev)[rows]) <= TOL["sp"]
    if k == 1:
        assert np.array_equal(prev.numpy(), x0)


def test_plain_block_vectors_match_solve_lane_tiles():
    jscs = jax_scs(scaled(jgen.laplace2d(40), 0.1))
    jdev = build_device_lane_tiles(jscs, block_vec_size=3)
    xb = np.random.default_rng(1).standard_normal(
        (jscs.n_rows_padded, 3)).astype(np.float32)
    j_prev, j_fin = solve_lane_tiles(jdev, jnp.asarray(xb), 3, interpret=True)
    dev = build_device_scs(scs_from_reference(dataclasses.asdict(jscs)), CPU)
    prev, fin = solve_scs(dev, torch.from_numpy(xb), 3)
    assert fin.shape == xb.shape
    rows = jscs.old_to_new_idx
    assert rel_err(fin.numpy()[rows], np.asarray(j_fin)[rows]) <= TOL["sp"]
    assert rel_err(prev.numpy()[rows], np.asarray(j_prev)[rows]) <= TOL["sp"]


@pytest.mark.parametrize("k", [1, 4])
def test_plain_is_k_spmvs_with_a_swap(k):
    dev = build_device_scs(
        scs_from_reference(dataclasses.asdict(jax_scs(banded(jgen)))), CPU)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        dev.n_rows_padded).astype(np.float32))
    want_prev, want = x, x
    for _ in range(k):
        want_prev, want = want, spmv_scs(dev, want)
    prev, fin = solve_scs_plain(dev, x, k)
    assert torch.equal(fin, want) and torch.equal(prev, want_prev)


@pytest.fixture
def small_dev():
    scs = scs_from_reference(dataclasses.asdict(jax_scs(jgen.tridiag(100))))
    return build_device_scs(scs, CPU)


def test_solve_fits_shapes(small_dev):
    n = small_dev.n_rows_padded
    assert solve_fits(small_dev, (n,), torch.float32)
    assert solve_fits(small_dev, (n, 8), torch.float32, "rowwise")
    assert not solve_fits(small_dev, (n, 9), torch.float32, "rowwise")
    assert not solve_fits(small_dev, (4, n), torch.float32, "colwise")
    assert not solve_fits(small_dev, (n - 1,), torch.float32)
    assert not solve_fits(small_dev, (n,), torch.float64)  # f32 values


@pytest.mark.parametrize("shape,layout,err", [
    (lambda n: (n, 9), "rowwise", ValueError),
    (lambda n: (4, n), "colwise", ValueError),
    (lambda n: (n + 5,), "rowwise", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(small_dev, shape,
                                                       layout, err):
    x = torch.zeros(shape(small_dev.n_rows_padded))
    with pytest.raises(err, match="fused solve kernel takes"):
        solve_scs(small_dev, x, 2, layout)


def test_wrapper_rejects_bad_k_and_dtype(small_dev):
    x = torch.zeros(small_dev.n_rows_padded)
    with pytest.raises(ValueError, match="k >= 1"):
        solve_scs(small_dev, x, 0)
    with pytest.raises(TypeError, match="no fused solve kernel"):
        solve_scs(small_dev, x.double(), 2)


def test_cpu_tensors_never_count_as_launches(small_dev):
    n0 = scs_solve.launch_count()
    solve_scs(small_dev, torch.ones(small_dev.n_rows_padded), 3)
    assert scs_solve.launch_count() == n0
    assert set(scs_solve.launch_counts()) == set(
        scs_solve._ENTRY_POINTS.values())


def test_cuda_source_exports_the_bound_entry_points():
    src = (_build.CSRC_DIR / "scs_solve.cu").read_text()
    body = src.split('extern "C" {', 1)[1]
    for name in scs_solve._ENTRY_POINTS.values():
        assert f"{name}(" in body
    # the row sum is the SpMV kernel's own code, and a header edit rebuilds
    assert '#include "scs_row.cuh"' in src
    assert '#include "scs_row.cuh"' in (
        _build.CSRC_DIR / "scs_spmv.cu").read_text()
    assert "cudaLaunchCooperativeKernel" in src and "grid.sync()" in src


def test_build_digest_covers_shared_headers(monkeypatch, tmp_path):
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build._digest(_build._sources())
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._digest(_build._sources()) != before


# ------------------------------------------------------- the operator's solve

MATRICES = {
    "laplace2d(40)*0.1": lambda g: scaled(g.laplace2d(40), 0.1),
    "random_banded(1500,40,7)": banded,
}


def config(cls, value_type, **kw):
    return cls(kernel_format="scs", chunk_size=1024, sigma=1,
               value_type=value_type, backend="cpu", **kw)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("value_type", ["sp", "dp"])
@pytest.mark.parametrize("jax_fused", [False, True])
@pytest.mark.parametrize("impl", ["loop", "fused"])
def test_solve_matches_jax_operator(monkeypatch, name, value_type, jax_fused,
                                    impl):
    if jax_fused:
        monkeypatch.setenv("USPMV_FUSED_SOLVE", "1")
    else:
        monkeypatch.delenv("USPMV_FUSED_SOLVE", raising=False)
    jm, tm = MATRICES[name](jgen), MATRICES[name](tgen)
    jop = JOperator.from_mtx(config(JConfig, value_type), jm)
    if value_type == "sp":
        assert jop._fused_solve_eligible() == jax_fused
    op = SpmvOperator.from_mtx(config(Config, value_type), tm)
    x = np.random.default_rng(7).standard_normal(jm.n_rows)
    jx, jy = jop.solve(jop.make_x(x), 4)
    tx, ty = op.solve(op.make_x(x), 4, impl=impl)
    assert rel_err(op.to_host(ty), jop.to_host(jy)) <= TOL[value_type]
    assert rel_err(op.to_host(tx), jop.to_host(jx)) <= TOL[value_type]


@pytest.mark.parametrize("impl", ["loop", "fused", None])
@pytest.mark.parametrize("value_type", ["sp", "dp", "hp"])
def test_solve_validates_ok(impl, value_type):
    from uspmv_tpu_torch.ops.vectors import init_x_host

    tm = MATRICES["laplace2d(40)*0.1"](tgen)
    op = SpmvOperator.from_mtx(config(Config, value_type), tm)
    x0 = init_x_host(op.config, op.n_rows, op.matrix_stats)
    _, y = op.solve(op.make_x(x0), 4, impl=impl)
    rep = validate_solve(tm, x0, op.to_host(y), 4, value_type=value_type)
    assert rep.flag == "OK", rep.summary()


@pytest.mark.parametrize("bs", [1, 3, 8])
def test_fused_equals_loop_on_the_cpu(bs):
    tm = MATRICES["random_banded(1500,40,7)"](tgen)
    op = SpmvOperator.from_mtx(
        config(Config, "sp", block_vec_size=bs, vector_layout="rowwise"), tm)
    assert op.fused_solve_eligible()
    x = op.make_x(np.random.default_rng(3).standard_normal(
        (tm.n_rows, bs) if bs > 1 else tm.n_rows))
    for k in (0, 1, 2, 5):
        a_prev, a = op.solve(x, k, impl="loop")
        b_prev, b = op.solve(x, k, impl="fused")
        assert torch.equal(a, b) and torch.equal(a_prev, b_prev)


INELIGIBLE = {
    "ap": dict(value_type="ap[sp_hp]", ap_threshold_1=0.3),
    "colwise": dict(value_type="sp", block_vec_size=4,
                    vector_layout="colwise"),
    "bs>8": dict(value_type="sp", block_vec_size=9, vector_layout="rowwise"),
}


@pytest.mark.parametrize("case", sorted(INELIGIBLE))
def test_ineligible_operators_refuse_the_fused_kernel(monkeypatch, case):
    fields = dict(INELIGIBLE[case])
    tm = MATRICES["laplace2d(40)*0.1"](tgen)
    op = SpmvOperator.from_mtx(
        config(Config, fields.pop("value_type"), **fields), tm)
    if case == "ap":
        assert len(op.devs) == 2
    assert not op.fused_solve_eligible()
    bs = op.config.block_vec_size
    x = op.make_x(np.ones((tm.n_rows, bs) if bs > 1 else tm.n_rows))
    with pytest.raises(ValueError, match="fused solve kernel takes"):
        op.solve(x, 3, impl="fused")
    # the opt-in never forces it on them: the default stays the loop here
    monkeypatch.setenv("USPMV_FUSED_SOLVE", "1")
    assert op.solve_impl_name(3) == "loop"
    _, y = op.solve(x, 3)
    _, want = op.solve(x, 3, impl="loop")
    assert torch.equal(y, want)


def test_default_impl_rule(monkeypatch):
    tm = MATRICES["laplace2d(40)*0.1"](tgen)
    op = SpmvOperator.from_mtx(config(Config, "sp"), tm)
    monkeypatch.delenv("USPMV_FUSED_SOLVE", raising=False)
    assert op.fused_solve_eligible()
    assert op.solve_impl_name(512) == "loop"  # the CPU never captures a graph
    monkeypatch.setenv("USPMV_FUSED_SOLVE", "1")
    assert op.solve_impl_name(512) == "fused"
    assert op.solve_impl_name(512, "loop") == "loop"
    with pytest.raises(ValueError, match="solve impl must be one of"):
        op.solve_impl_name(2, "scan")


def test_graph_impl_on_the_cpu_raises():
    tm = MATRICES["laplace2d(40)*0.1"](tgen)
    op = SpmvOperator.from_mtx(config(Config, "sp"), tm)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        op.solve(op.make_x(), 3, impl="graph")


def test_replayed_graph_nodes_are_counted_apart_from_launches():
    """Only a graph replay adds to ``graph_nodes_replayed``, and nothing but
    the SpMV wrapper's own launches adds to its launch count."""
    from uspmv_tpu_torch.ops import scs_spmv
    from uspmv_tpu_torch.runtime import operator

    tm = MATRICES["laplace2d(40)*0.1"](tgen)
    op = SpmvOperator.from_mtx(config(Config, "sp"), tm)
    before = operator.graph_nodes_replayed()
    op.solve(op.make_x(), 3, impl="loop")
    op.solve(op.make_x(), 3, impl="fused")
    assert operator.graph_nodes_replayed() == before
    assert not hasattr(scs_spmv, "count_graph_replay")
    assert set(before) <= set(scs_spmv.launch_counts())


def test_spmv_writes_into_out():
    tm = MATRICES["laplace2d(40)*0.1"](tgen)
    for value_type, kw in (("sp", {}),
                           ("ap[sp_hp]", dict(ap_threshold_1=0.3))):
        op = SpmvOperator.from_mtx(config(Config, value_type, **kw), tm)
        x = op.make_x(np.random.default_rng(5).standard_normal(tm.n_rows))
        out = torch.full_like(x, 7.0)
        y = op.spmv(x, out=out)
        assert y is out and torch.equal(out, op.spmv(x))
        with pytest.raises(ValueError, match="out must not be x"):
            op.spmv(x, out=x)


# ---------------------------------------------------------------- bench_solve


@pytest.mark.parametrize("impl,name", [("loop", "solve-loop"),
                                       ("fused", "solve-fused"),
                                       (None, "solve-loop")])
def test_bench_solve_on_the_cpu(monkeypatch, impl, name):
    monkeypatch.delenv("USPMV_FUSED_SOLVE", raising=False)
    tm = MATRICES["laplace2d(40)*0.1"](tgen)
    op = SpmvOperator.from_mtx(config(Config, "sp"), tm)
    res = bench_solve(op, 8, bench_time=0.01, warmup=1, impl=impl)
    assert res.impl == f"{name}[torch-plain-scs-sp]"
    m = res.n_iterations // 8
    assert res.n_iterations == 8 * m and m >= 1 and m & (m - 1) == 0
    assert np.isfinite(res.perf_gflops) and res.perf_gflops > 0
    assert np.isfinite(res.effective_gbps) and res.effective_gbps > 0
    assert len(res.timing_samples_s) == 3 and res.platform == "cpu"
    assert res.perf_gflops == pytest.approx(
        2.0 * op.nnz * res.n_iterations / res.duration_kernel_s / 1e9)


def test_cli_solve_mode_prints_the_impl(monkeypatch, capsys, tmp_path):
    from uspmv_tpu_torch import cli

    argv = ["Laplace2D,20", "scs", "-c", "32", "-s", "4", "-sp", "-mode", "s",
            "-rev", "4", "-backend", "cpu", "-mtx_out", str(tmp_path)]
    monkeypatch.delenv("USPMV_FUSED_SOLVE", raising=False)
    assert cli.main(argv) == 0
    assert "impl: solve-loop[torch-plain-scs-sp]" in capsys.readouterr().out
    monkeypatch.setenv("USPMV_FUSED_SOLVE", "1")
    assert cli.main(argv) == 0
    assert "impl: solve-fused[torch-plain-scs-sp]" in capsys.readouterr().out
