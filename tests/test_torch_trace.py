"""The port's spans and counters (runtime/profiling.py) on the CPU: off, a
span records nothing and opens no profiler range; on, self time is total
less the children's; ``from_mtx`` and the sharded ``spmv`` emit their
phases under their own span; the launch total that a span records is the
wrappers' launches; ``device_bytes`` counts every device tensor; and a
``trace(logdir)`` holds the ``spmv`` span."""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops import (
    halo_exchange,
    scs_packed,
    scs_pieces,
    scs_spmv,
    x_access,
)
from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator
from uspmv_tpu_torch.runtime import profiling
from uspmv_tpu_torch.runtime.operator import SpmvOperator

CPU = torch.device("cpu")
BUILD = ("from_mtx.prepare", "from_mtx.convert", "from_mtx.permute",
         "from_scs.upload")
# the wrappers that book their launches through scs_spmv.book_launch
WRAPPERS = (scs_spmv, scs_packed, scs_pieces, halo_exchange, x_access)


@pytest.fixture(autouse=True)
def clean():
    """Each test starts with spans off and empty tables, and leaves them
    so."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def busy(seconds: float) -> None:
    t = time.perf_counter() + seconds
    while time.perf_counter() < t:
        pass


def spans():
    return profiling.snapshot()["spans"]


def op_of(mtx, **kw):
    cfg = Config(**{"kernel_format": "scs", "chunk_size": 32, "sigma": 1,
                    "value_type": "dp", "backend": "cpu", **kw})
    return SpmvOperator.from_mtx(cfg, mtx)


def test_off_span_records_nothing_and_opens_no_range(monkeypatch):
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b")  # one shared object
    assert profiling.spans()("a") is profiling.span("a")

    def refuse(*a, **k):
        raise AssertionError("record_function opened while spans are off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("off.outer"):
            with profiling.span("off.inner"):
                torch.arange(10.0).sum()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    assert not {"off.outer", "off.inner"} & {
        e.key for e in prof.key_averages()}


def test_nested_spans_self_is_total_less_children():
    profiling.enable()
    for _ in range(2):
        with profiling.span("outer"):
            busy(0.002)
            with profiling.span("outer.a"):
                busy(0.003)
            with profiling.span("outer.b"):
                busy(0.001)
                with profiling.span("outer.b.c"):
                    busy(0.001)
    s = spans()
    assert s["outer"]["count"] == 2 and s["outer.b.c"]["count"] == 2
    assert s["outer"]["parent"] is None
    assert s["outer.a"]["parent"] == "outer"
    assert s["outer.b.c"]["parent"] == "outer.b"
    children = s["outer.a"]["total_s"] + s["outer.b"]["total_s"]
    assert s["outer"]["self_s"] == pytest.approx(
        s["outer"]["total_s"] - children, abs=1e-9)
    assert s["outer.b"]["self_s"] == pytest.approx(
        s["outer.b"]["total_s"] - s["outer.b.c"]["total_s"], abs=1e-9)
    assert s["outer.b.c"]["self_s"] == s["outer.b.c"]["total_s"]
    assert s["outer"]["self_s"] >= 2 * 0.002
    json.dumps(profiling.snapshot())  # plain JSON-able dicts


@pytest.mark.parametrize("gen", ["Laplace3D,40", "RandomImbalanced,60000,12"])
def test_from_mtx_phases_sum_to_the_build(gen):
    mtx = tgen.generate_matrix(gen)
    profiling.enable()
    op_of(mtx, split_rows_threshold=16)
    s = spans()
    assert s["from_mtx"]["count"] == 1 and s["from_mtx"]["parent"] is None
    for name in BUILD:
        assert s[name]["count"] == 1
        assert s[name]["parent"] == "from_mtx"
    parts = sum(s[name]["total_s"] for name in BUILD)
    assert parts == pytest.approx(s["from_mtx"]["total_s"], rel=0.05)


@pytest.mark.parametrize("kw", [
    dict(split_rows_threshold=-1, mixed_tiles=False),
    dict(split_rows_threshold=16, mixed_tiles=False),
    dict(split_rows_threshold=16, mixed_tiles=True),
    dict(value_type="ap[dp_sp]", ap_threshold_1=1.5,
         split_rows_threshold=16),
], ids=["scs", "pieces", "packed+pieces", "ap+pieces"])
def test_device_bytes_counts_every_device_tensor(kw):
    op = op_of(tgen.random_imbalanced(4000, 10), **kw)
    assert bool(op.pieces) == (kw["split_rows_threshold"] > 0)
    assert op.is_packed() == bool(kw.get("mixed_tiles"))
    got = op.device_bytes()
    tensors = [t for s in [*op.devs.values(), *op.pieces.values()]
               for t in vars(s).values() if isinstance(t, torch.Tensor)]
    assert sum(got.values()) == sum(t.nbytes for t in tensors)
    assert len(got) == len(tensors)
    # the build books them, spans off as on
    assert profiling.snapshot()["counters"] == {
        profiling.UPLOAD_BYTES: sum(got.values())}
    p = op.config.ap_precisions[0]
    assert got[f"{p}.values"] == op.devs[p].values.nbytes
    # a packed stream holds its row index from the build, a SELL-C-sigma
    # stream from its first read on, and is counted from then on
    assert (f"{p}.row_idxs" in got) == op.is_packed()
    rows = op.devs[p].row_idxs
    got = op.device_bytes()
    assert got[f"{p}.row_idxs"] == rows.nbytes
    assert profiling.snapshot()["counters"].get(
        profiling.ROW_INDEX_BUILDS, 0) == (0 if op.is_packed() else 1)
    if op.pieces:
        assert got[f"{p}.pieces.values"] == op.pieces[p].values.nbytes


def wrapper_launches() -> int:
    return sum(sum(w.launch_counts().values()) for w in WRAPPERS)


def test_span_launches_are_the_wrappers_launches():
    """A launch booked by any wrapper (here by book_launch itself, as after
    an entry point returned 0) adds to the launch total and to every span
    open around it; none is booked while a graph is captured."""
    saved = [dict(w._launches) for w in WRAPPERS]
    try:
        profiling.enable()
        before = wrapper_launches()
        with profiling.span("spmv"):
            for w in WRAPPERS:
                name = next(iter(w._launches))
                scs_spmv.book_launch(None, 0, name, w._launches)
            with profiling.span("spmv.inner"):
                scs_spmv.book_launch(None, 0, name, w._launches)
            with scs_spmv.record_captured_launches() as nodes:
                scs_spmv.book_launch(None, 0, name, w._launches, nodes=3)
        assert nodes == {name: 3}
        added = wrapper_launches() - before
        assert added == len(WRAPPERS) + 1
        snap = profiling.snapshot()
        assert snap["spans"]["spmv"]["launches"] == added
        assert snap["spans"]["spmv.inner"]["launches"] == 1
        assert snap["counters"][profiling.LAUNCHES] == added
    finally:
        for w, d in zip(WRAPPERS, saved):
            w._launches.clear()
            w._launches.update(d)


def test_spmv_span_counts_calls_and_plain_launches():
    op = op_of(tgen.laplace3d(12))
    x = op.make_x()
    y = torch.zeros_like(x)
    profiling.enable()
    for _ in range(5):
        op.spmv(x, out=y)
    s = spans()["spmv"]
    assert s["count"] == 5 and s["launches"] == 0  # plain: no kernel


def test_trace_holds_the_spmv_span(tmp_path):
    op = op_of(tgen.laplace3d(12))
    x = op.make_x()
    with profiling.trace(str(tmp_path / "prof")):
        op.spmv(x)
        op.spmv(x)
    assert not profiling.enabled()
    assert spans()["spmv"]["count"] == 2
    with open(profiling.last_trace_path()) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "spmv" for e in events) == 2


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_spmv_phases_nest_under_dist_spmv(overlap):
    mtx = tgen.laplace3d(10)
    cfg = Config(kernel_format="scs", chunk_size=8, sigma=1, value_type="dp",
                 backend="cpu", n_shards=2, overlap_comm=overlap,
                 split_rows_threshold=-1)
    profiling.enable()
    op = DistributedSpmvOperator.from_mtx(cfg, mtx, devices=[CPU, CPU])
    s = spans()
    assert s["dist.from_mtx.shard"]["count"] == 2
    for name in ("dist.from_mtx.shard", "dist.from_mtx.plan",
                 "dist.from_mtx.upload"):
        assert s[name]["parent"] == "dist.from_mtx"
    profiling.reset()
    x = op.make_x(np.arange(1.0, mtx.n_rows + 1.0))
    y = op.spmv(x)
    s = spans()
    assert s["dist.spmv"]["count"] == 1 and s["dist.spmv"]["parent"] is None
    phases = ["dist.send", "dist.exchange", "dist.rows.main",
              "dist.receive", "dist.rows.pieces"]
    if op.overlap:
        phases.append("dist.rows.halo")
    for name in phases:
        assert s[name]["parent"] == "dist.spmv", name
    inner = sum(s[n]["total_s"] for n in s if n != "dist.spmv")
    assert s["dist.spmv"]["self_s"] == pytest.approx(
        s["dist.spmv"]["total_s"] - inner, abs=1e-9)
    ref = mtx.to_scipy().tocsr() @ np.arange(1.0, mtx.n_rows + 1.0)
    np.testing.assert_allclose(op.to_host(y), ref, rtol=1e-12)
    # spans off: the same call records nothing
    profiling.disable()
    profiling.reset()
    op.spmv(x)
    assert spans() == {}
