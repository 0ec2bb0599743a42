"""The benchmark harness of uspmv_tpu_torch against the JAX package's, on
the CPU: how a batch is timed (``timing_for``: replays of a captured CUDA
graph on a card, a loop of calls on the CPU and over gloo), the doubling
of the batch from ``start_iters``, the fields of ``BenchResult`` against
the JAX harness's for the same operator, the sharded operator's refusals,
and the CG example's batches against the JAX example's.

The graphs themselves run only on a card: ``tests/test_torch_cuda.py``
holds them against the eager SpMV, bit for bit.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import uspmv_tpu.interface as jui
from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.runtime.bench import bench_spmv as jbench_spmv
from uspmv_tpu.runtime.operator import SpmvOperator as JOperator

import uspmv_tpu_torch.interface as tui
from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops.spmv_bcoo import BcooSpmvOperator
from uspmv_tpu_torch.parallel import multihost
from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator
from uspmv_tpu_torch.runtime.bench import (
    bench_solve,
    bench_spmv,
    timing_for,
    timing_of,
)
from uspmv_tpu_torch.runtime.operator import SpmvOperator


@pytest.mark.parametrize("device_type,transport,want", [
    ("cpu", None, "loop"),
    ("cpu", "gloo", "loop"),
    ("cuda", None, "graph"),
    ("cuda", "nccl", "graph"),
    ("cuda", "gloo", "loop"),
    ("cuda", "gloo-staged", "loop"),
])
def test_timing_rule(device_type, transport, want):
    assert timing_for(device_type, transport) == want


def small_operators():
    m = tgen.laplace2d(12)
    kw = dict(kernel_format="scs", chunk_size=8, sigma=4, value_type="sp",
              backend="cpu")
    return {
        "spmv": SpmvOperator.from_mtx(Config(**kw), m),
        "sharded": DistributedSpmvOperator.from_mtx(
            Config(n_shards=4, **kw), m),
        "bcoo": BcooSpmvOperator.from_mtx(Config(impl="bcoo", **kw), m),
    }


@pytest.mark.parametrize("kind", ["spmv", "sharded", "bcoo"])
def test_cpu_operators_time_by_loop(kind):
    op = small_operators()[kind]
    assert timing_of(op) == "loop"
    res = bench_spmv(op, bench_time=1e-4, warmup=1, start_iters=2,
                     timing_reps=1)
    assert res.timing == "loop" and res.to_dict()["timing"] == "loop"
    x = op.make_x()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        op.batch_graph(x, 4)


def test_sharded_timing_follows_the_transport(monkeypatch):
    op = small_operators()["sharded"]
    assert op.transport() is None
    # the same operator as if spread over two processes
    op.owner = np.array([0, 0, 1, 1])
    for transport, want in (("gloo", "loop"), ("gloo-staged", "loop"),
                            ("nccl", "loop")):  # the CPU never captures
        monkeypatch.setattr(multihost, "transport", lambda t=transport: t)
        assert op.transport() == transport
        assert timing_of(op) == want
    monkeypatch.setattr(op, "device", torch.device("cuda"))
    for transport, want in (("gloo", "loop"), ("gloo-staged", "loop"),
                            ("nccl", "graph")):
        monkeypatch.setattr(multihost, "transport", lambda t=transport: t)
        assert timing_of(op) == want


@pytest.mark.parametrize("transport", ["gloo", "gloo-staged"])
def test_solve_refusal_over_gloo_keeps_its_message(monkeypatch, transport):
    op = small_operators()["sharded"]
    op.owner = np.array([0, 0, 1, 1])
    monkeypatch.setattr(multihost, "transport", lambda: transport)
    with pytest.raises(ValueError, match="spread over processes solves by "
                       "impl='loop': its transfer cannot be captured"):
        op.solve_impl_name(4, "graph")
    assert op.solve_impl_name(4) == "loop"
    with pytest.raises(ValueError, match="fused solve kernel takes one"):
        op.solve_impl_name(4, "fused")


def test_solve_over_nccl_takes_the_graph(monkeypatch):
    op = small_operators()["sharded"]
    op.owner = np.array([0, 0, 1, 1])
    monkeypatch.setattr(multihost, "transport", lambda: "nccl")
    assert op.solve_impl_name(4, "graph") == "graph"
    assert op.solve_impl_name(4) == "loop"  # on the CPU
    monkeypatch.setattr(op, "device", torch.device("cuda"))
    assert op.solve_impl_name(4) == "graph"
    assert op.solve_impl_name(1) == "loop"


@pytest.mark.parametrize("start_iters", [1, 2, 3, 10])
def test_cpu_bench_doubles_from_start_iters(start_iters):
    op = small_operators()["spmv"]
    res = bench_spmv(op, bench_time=2e-3, warmup=1, start_iters=start_iters,
                     timing_reps=2)
    ratio = res.n_iterations // start_iters
    assert res.n_iterations == start_iters * ratio
    assert ratio & (ratio - 1) == 0  # a power of two
    assert res.timing == "loop" and len(res.timing_samples_s) == 2


@pytest.mark.parametrize("impl", ["loop", "fused"])
def test_cpu_bench_solve_times_by_loop(impl):
    op = small_operators()["spmv"]
    res = bench_solve(op, 4, bench_time=1e-3, warmup=1, timing_reps=1,
                      impl=impl)
    assert res.timing == "loop" and res.n_iterations % 4 == 0
    with pytest.raises(ValueError, match="needs a CUDA device"):
        op.solve_graph(op.make_x(), 4)


# the keys only one harness has: the port's counts of split rows and dropped
# elements, its card name, and (new) how a batch was timed; the JAX
# package's lane-tile re-tiling, which the port does not do
PORT_ONLY = {"device_name", "n_dropped", "n_pieces", "nnz_in_pieces",
             "split_rows_threshold", "timing"}
JAX_ONLY = {"retiled"}
SAME = ("nnz", "n_rows", "block_vec_size", "value_type", "kernel_format",
        "C", "sigma", "beta", "nnz_per_precision", "platform",
        "n_processes", "comm_volume_elems", "per_shard",
        "comm_volume_per_host")
FIELD_CASES = {
    "sp-scs": dict(kernel_format="scs", chunk_size=32, sigma=8,
                   value_type="sp"),
    "dp-crs": dict(kernel_format="crs", value_type="dp"),
    "sp-rowwise-4": dict(kernel_format="scs", chunk_size=8, sigma=1,
                         value_type="sp", block_vec_size=4,
                         vector_layout="rowwise"),
    "ap[dp_sp]": dict(kernel_format="scs", chunk_size=8, sigma=1,
                      value_type="ap[dp_sp]", ap_threshold_1=3.0),
}


@pytest.mark.parametrize("case", sorted(FIELD_CASES))
def test_bench_result_fields_equal_jax(case):
    kw = FIELD_CASES[case]
    jop = JOperator.from_mtx(JConfig(backend="cpu", use_pallas=False, **kw),
                             jgen.laplace3d(8))
    op = SpmvOperator.from_mtx(
        Config(backend="cpu", split_rows_threshold=-1, mixed_tiles=False,
               **kw), tgen.laplace3d(8))
    args = dict(bench_time=1e-3, warmup=1, start_iters=2, timing_reps=1)
    j = jbench_spmv(jop, **args).to_dict()
    t = bench_spmv(op, **args).to_dict()
    assert set(t) - set(j) == PORT_ONLY and set(j) - set(t) == JAX_ONLY
    for key in SAME:
        assert t[key] == j[key], key
    # flops per SpMV: 2 nnz bs in both; bytes: each operator's own count
    # (the JAX one streams its lane tiles, PERF.md section 2)
    for r, o in ((t, op), (j, jop)):
        flops = r["perf_gflops"] * 1e9 * r["duration_kernel_s"] \
            / r["n_iterations"]
        assert flops == pytest.approx(2 * o.nnz * kw.get("block_vec_size", 1),
                                      rel=1e-9)
    assert t["memory_footprint_bytes"] == op.bytes_per_spmv()
    assert t["timing"] == "loop" and t["n_iterations"] % 2 == 0


def load_example(name):
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(here, "..", "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("maxiter", [30, 60])
def test_cg_batches_match_the_jax_example(maxiter):
    """A short last batch (maxiter not a multiple of BATCH) runs as many
    steps as in the JAX example; the eager runner is the CPU's default."""
    jcg = load_example("cg_solver").cg
    ex = load_example("cg_solver_torch")
    jm, tm = jgen.laplace3d(10), tgen.laplace3d(10)
    b = tm.to_scipy().tocsr() @ np.random.default_rng(1).standard_normal(
        tm.n_rows)
    jh = jui.prepare(jm, C=1024, sigma=1, value_type="sp", backend="cpu")
    th = tui.prepare(tm, C=1024, sigma=1, value_type="sp", backend="cpu")
    jx, j_it, j_res = jcg(jh, b, tol=1e-30, maxiter=maxiter)
    x, it, res = ex.cg(th, b, tol=1e-30, maxiter=maxiter)
    x2, it2, res2 = ex.cg(th, b, tol=1e-30, maxiter=maxiter,
                          batches=ex.eager_batches)
    assert it == j_it == it2 == maxiter
    assert np.array_equal(x, x2) and res == res2
    scale = np.abs(np.asarray(jx)).max()
    assert np.abs(x - np.asarray(jx)).max() <= 1e-4 * scale
    assert res == pytest.approx(j_res, rel=1e-2)


@pytest.mark.parametrize("layout,bs", [("rowwise", 1), ("rowwise", 4),
                                       ("colwise", 4)])
def test_bcoo_writes_its_products_into_out(layout, bs):
    """The vendor path's spmv(x, out=...), which the bench's graphs call,
    writes the same products into the caller's buffer (no copy)."""
    m = tgen.random_imbalanced(900, 7, seed=4)
    op = BcooSpmvOperator.from_mtx(Config(
        impl="bcoo", value_type="sp", backend="cpu", block_vec_size=bs,
        vector_layout=layout), m)
    x = op.make_x(np.random.default_rng(0).standard_normal(
        (m.n_rows, bs) if bs > 1 else m.n_rows))
    out = torch.full_like(x, 7.0)
    assert op.spmv(x, out=out) is out
    assert torch.equal(out, op.spmv(x))


def test_shutdown_resets_the_graphs_of_the_run():
    """A communicator is not destroyed while a live CUDA graph holds its
    collectives: ``multihost.shutdown`` resets every graph captured in the
    run (``hold_graph``) first, once."""
    class Graph:
        resets = 0

        def reset(self):
            self.resets += 1

    g = Graph()
    multihost.hold_graph(g)
    multihost.shutdown()
    assert g.resets == 1
    multihost.shutdown()
    assert g.resets == 1
