"""One process over several card groups, on the CPU.

``DistributedSpmvOperator.from_mtx(..., devices=[cpu] * G)`` spreads the R
shards over G groups as it spreads them over G cards: shard r to group
r // ceil(R / G), each group with its own stacked x, its in-group exchange
and a transfer of the rows that cross groups (pack, copy, unpack). The
groups share the CPU here, the counterpart of the JAX tests' virtual CPU
mesh. For every case y must be bit-equal to the same operator with one
group (the exchange only moves values, and each shard's launches are the
same), and agree with the JAX mesh operator (``use_pallas=False`` on the
8-device CPU mesh) within the tolerance of tests/test_torch_distributed.py:
max|y - ref| / max|ref| <= 1e-12 in f64 and 1e-5 in f32, bit for bit with
integer x on the integer-valued Laplacian where an exchange is skipped or
unpacked on purpose.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.parallel.distributed import (
    DistributedSpmvOperator as JDistributed,
)

from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops.halo_exchange import peer_plan
from uspmv_tpu_torch.parallel.distributed import (
    DistributedSpmvOperator,
    shard_cards,
)
from uspmv_tpu_torch.runtime.bench import bench_solve, bench_spmv, timing_of
from uspmv_tpu_torch.runtime.report import format_bench_block
from uspmv_tpu_torch.runtime.validate import validate_solve

JAX_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
CPU = torch.device("cpu")

BASE = dict(kernel_format="scs", chunk_size=4, sigma=8, value_type="sp")
CASES = {
    "sp": dict(),
    "sp-no-overlap": dict(overlap_comm=False),
    "dp": dict(value_type="dp"),
    "ap[dp_sp]": dict(value_type="ap[dp_sp]", ap_threshold_1=2.0),
    "ap[dp_sp]-no-overlap": dict(value_type="ap[dp_sp]", ap_threshold_1=2.0,
                                 overlap_comm=False),
    "rowwise-4": dict(block_vec_size=4, vector_layout="rowwise"),
    "colwise-4": dict(block_vec_size=4, vector_layout="colwise"),
    "colwise-4-no-overlap": dict(block_vec_size=4, vector_layout="colwise",
                                 overlap_comm=False),
    "allgather": dict(comm_mode="allgather"),
    "allgather-colwise-4": dict(comm_mode="allgather", block_vec_size=4,
                                vector_layout="colwise"),
    "allgather-dp": dict(comm_mode="allgather", value_type="dp"),
    "seg-nnz-pieces": dict(seg_method="seg-nnz", split_rows_threshold=4,
                           chunk_size=8, sigma=1, matrix="imbalanced"),
    "seg-metis": dict(seg_method="seg-metis"),
}
# wrong on purpose: held to the JAX operator bit for bit on integer x
WRONG = {
    "no-pack": dict(value_type="dp", no_pack=True),
    "no-pack-no-overlap": dict(value_type="dp", no_pack=True,
                               overlap_comm=False),
    "comm-halos-0": dict(value_type="dp", comm_halos=False),
}


def matrix(gen, name):
    if name == "imbalanced":
        return gen.random_imbalanced(600, 6, seed=21)
    return gen.laplace2d(16)


def split_kw(case, R):
    kw = dict(BASE, n_shards=R, **dict(CASES, **WRONG)[case])
    return kw.pop("matrix", "laplace2d"), kw


def host_x(n, bs, integer):
    rng = np.random.default_rng(7)
    shape = (n, bs) if bs > 1 else n
    if integer:
        return rng.integers(-4, 5, shape).astype(np.float64)
    return rng.standard_normal(shape)


@functools.lru_cache(maxsize=None)
def jax_y(case, R):
    """The JAX mesh operator's y of the case (one SpMV)."""
    name, kw = split_kw(case, R)
    jop = JDistributed.from_mtx(JConfig(backend="cpu", use_pallas=False,
                                        **kw), matrix(jgen, name))
    x = host_x(jop.n_rows, kw.get("block_vec_size", 1), case in WRONG)
    return np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))


@functools.lru_cache(maxsize=None)
def one_group(case, R):
    """(operator, y) of the case with one group."""
    name, kw = split_kw(case, R)
    op = DistributedSpmvOperator.from_mtx(Config(backend="cpu", **kw),
                                          matrix(tgen, name))
    x = host_x(op.n_rows, kw.get("block_vec_size", 1), case in WRONG)
    return op, op.to_host(op.spmv(op.make_x(x)))


def groups_op(case, R, G):
    name, kw = split_kw(case, R)
    return DistributedSpmvOperator.from_mtx(
        Config(backend="cpu", **kw), matrix(tgen, name), devices=[CPU] * G)


def rel(a, b):
    b = np.asarray(b, dtype=np.float64)
    return np.abs(np.asarray(a, dtype=np.float64) - b).max() / np.abs(b).max()


@pytest.mark.parametrize("case", sorted(CASES) + sorted(WRONG))
@pytest.mark.parametrize("R,G", [(4, 2), (4, 4), (8, 2), (8, 4)])
def test_groups_bit_equal_to_one_group_and_agree_with_jax(R, G, case):
    one, want = one_group(case, R)
    op = groups_op(case, R, G)
    bs = op.config.block_vec_size
    x = op.make_x(host_x(op.n_rows, bs, case in WRONG))
    assert isinstance(x, tuple) and len(x) == len(op.groups) == G
    assert tuple(t.shape for t in x) == op.x_shape()
    y = op.spmv(x)
    got = op.to_host(y)
    assert np.array_equal(got, want)
    assert op.impl_name() == one.impl_name().replace(
        f"dist{R}-", f"dist{R}-{G}cards-")
    jy = jax_y(case, R)
    if case in WRONG:
        assert np.array_equal(got, jy)  # exact sums: the same wrong y
    else:
        assert rel(got, jy) <= JAX_TOL[op.working_dtype], rel(got, jy)
    # the same bits again: the second SpMV reads the halo rows the first
    # filled and fills them anew
    assert np.array_equal(op.to_host(op.spmv(x, out=y)), want)
    assert op.comm_volume_per_spmv() == one.comm_volume_per_spmv()
    assert op.comm_volume_per_host() == one.comm_volume_per_host()
    assert op.bytes_per_spmv() == one.bytes_per_spmv()


PLACEMENT = {
    # (R, G): the card of each shard
    (2, 1): [0, 0], (2, 2): [0, 1], (2, 4): [0, 1],
    (4, 1): [0] * 4, (4, 2): [0, 0, 1, 1], (4, 4): [0, 1, 2, 3],
    (6, 1): [0] * 6, (6, 2): [0, 0, 0, 1, 1, 1],
    (6, 4): [0, 0, 1, 1, 2, 2],  # D = 2: card 3 idle
    (8, 1): [0] * 8, (8, 2): [0] * 4 + [1] * 4,
    (8, 4): [0, 0, 1, 1, 2, 2, 3, 3],
}


@pytest.mark.parametrize("R,G", sorted(PLACEMENT))
def test_placement_rule(R, G):
    want = PLACEMENT[(R, G)]
    assert shard_cards(R, G).tolist() == want
    op = DistributedSpmvOperator.from_mtx(
        Config(backend="cpu", n_shards=R, **BASE), tgen.laplace2d(16),
        devices=[CPU] * G)
    assert op.card.tolist() == want
    assert [list(g.shards) for g in op.groups] == [
        [r for r in range(R) if want[r] == c] for c in range(max(want) + 1)]
    assert op.n_cards == max(want) + 1 and op.n_local == R
    assert (op.transport() is None) == (op.n_cards == 1)


@pytest.mark.parametrize("R,G", [(4, 2), (8, 4)])
def test_solve_validates_and_equals_one_group(R, G):
    m = tgen.fem_tet3d(4)
    kw = dict(kernel_format="scs", chunk_size=8, sigma=4, value_type="dp",
              n_shards=R, mode="s")
    one = DistributedSpmvOperator.from_mtx(Config(backend="cpu", **kw), m)
    op = DistributedSpmvOperator.from_mtx(Config(backend="cpu", **kw), m,
                                          devices=[CPU] * G)
    x0 = np.random.default_rng(2).standard_normal(m.n_rows)
    assert op.solve_impl_name(4) == "loop"
    prev, y = op.solve(op.make_x(x0), 4)
    oprev, oy = one.solve(one.make_x(x0), 4)
    assert np.array_equal(op.to_host(y), one.to_host(oy))
    assert np.array_equal(op.to_host(prev), one.to_host(oprev))
    rep = validate_solve(m, x0, op.to_host(y), 4)
    assert rep.flag == "OK", rep.summary()


@pytest.mark.parametrize("layout,bs", [("rowwise", 1), ("rowwise", 3),
                                       ("colwise", 3)])
def test_to_host_reads_back_make_x(layout, bs):
    m = tgen.laplace2d(16)
    op = DistributedSpmvOperator.from_mtx(
        Config(backend="cpu", n_shards=8, block_vec_size=bs,
               vector_layout=layout, **dict(BASE, value_type="dp")), m,
        devices=[CPU] * 4)
    x = host_x(m.n_rows, bs, False)
    parts = op.make_x(x)
    assert np.array_equal(op.to_host(parts), x)
    for grp, t in zip(op.groups, parts):
        assert t.device == grp.device and t.is_contiguous()
        assert t.shape[1 if layout == "colwise" and bs > 1 else 0] == 2


@pytest.mark.parametrize("G", [2, 4])
def test_per_card_comm_volume(G):
    op = groups_op("sp", 8, G)
    per_card = op.comm_volume_per_card()["sp"]
    halo = op.comm_volume_per_spmv()["sp"]["per_shard"]
    assert per_card == {c: sum(h for r, h in enumerate(halo)
                               if op.card[r] == c) for c in range(G)}
    assert sum(per_card.values()) == op.comm_volume_per_spmv()["sp"]["real"]
    # the rows that cross cards: what the transfers receive, and every
    # group's rows for the others are what the others expect
    tr = [grp.transfers["sp"] for grp in op.groups]
    moved = sum(t.n_recv for t in tr)
    assert moved == sum(t.n_send for t in tr) > 0
    assert moved + sum(grp.exchanges["sp"].n for grp in op.groups) == \
        sum(per_card.values())
    plan = peer_plan(tr)
    assert sum(m.n for m in plan) == moved
    assert all(m.src != m.dst for m in plan)
    assert op.peer["sp"] == plan


def test_bench_and_report_name_the_card():
    op = groups_op("sp", 4, 2)
    op.config.print_comm_vol = True
    assert timing_of(op) == "loop"  # the CPU
    # kernels and peer copies fit one graph on cards; the plain versions
    # over several cards allocate on each, so they run a loop
    assert op.graph_capturable()
    xla = dataclasses.replace(op, config=dataclasses.replace(
        op.config, impl="xla", use_pallas=False))
    assert not xla.graph_capturable()
    with pytest.raises(ValueError, match="allocates on every card"):
        xla.solve_impl_name(4, "graph")
    res = bench_spmv(op, bench_time=0.01, warmup=1, start_iters=1,
                     timing_reps=1)
    assert res.timing == "loop"
    assert res.impl == "torch-plain-dist4-2cards-scs-sp"
    assert [s["card"] for s in res.per_shard] == [0, 0, 1, 1]
    text = format_bench_block(op.config, res)
    assert "shard 3: nnz=" in text and text.count(" card=1") == 2
    res = bench_solve(op, 3, warmup=1, timing_reps=1)
    assert res.impl == "solve-loop[torch-plain-dist4-2cards-scs-sp]"


def test_vectors_are_checked_per_group():
    op = groups_op("sp", 4, 2)
    x = op.make_x()
    with pytest.raises(ValueError, match="make_x"):
        op.spmv(x[0])
    with pytest.raises(ValueError, match="make_x"):
        op.spmv((x[0], x[1].double()))
    with pytest.raises(ValueError, match="must not be x"):
        op.spmv(x, out=(torch.zeros_like(x[0]), x[1]))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        op.solve(x, 3, impl="graph")
    out = tuple(torch.full_like(t, 7.0) for t in x)
    assert op.spmv(x, out=out) is out


def test_one_card_keeps_one_tensor():
    """With one group the operator is the one of one device: a plain
    tensor, the same name, no transport."""
    op = groups_op("sp", 4, 1)
    assert isinstance(op.make_x(), torch.Tensor)
    assert op.impl_name() == "torch-plain-dist4-scs-sp"
    assert op.transport() is None and op.peer == {}
    assert op.groups[0].exchanges["sp"].n_shards == 4
    assert op.groups[0].transfers["sp"] is None


def test_devices_name_the_groups_of_a_process_in_a_run(monkeypatch):
    """In a run of processes ``devices=`` lists this process's groups (two
    may name one device): process 1 of 2 at R=4 holds shards 2 and 3 on
    groups 2 and 3 of the run, its rows for process 0 staged through the
    first of them."""
    from uspmv_tpu_torch.parallel import multihost

    full = {p: dict(enumerate(sm))
            for p, sm in one_group("sp", 4)[0].summaries.items()}
    monkeypatch.setattr(multihost, "_state", dict(
        process_id=1, n_processes=2, n_local_devices=2, transport="gloo"))
    monkeypatch.setattr(multihost, "gather_object",
                        lambda obj: [full] * 2 if isinstance(obj, dict)
                        else [2, 2])
    op = groups_op("sp", 4, 2)
    assert op.card.tolist() == [0, 1, 2, 3]
    assert [g.index for g in op.groups] == [2, 3]
    assert [list(g.shards) for g in op.groups] == [[2], [3]]
    assert op.devices() == [CPU, CPU] and op.transport() == "gloo+peer"
    st = op.stage["sp"]
    assert st.send_counts[1] == st.recv_counts[1] == 0
    assert st.n_send == st.n_recv > 0  # shard 2's rows for shard 1, back
    assert op.lead["sp"]["send"].shape == (st.n_send,)
    with pytest.raises(ValueError, match="at least one device"):
        groups_op("sp", 4, 0)


@pytest.mark.parametrize("n_cards", [1, 2, 4])
def test_replay_orders_every_card_around_the_graph(monkeypatch, n_cards):
    """A graph over several cards replays on the first card's current
    stream: that stream waits for every other card's current stream first
    (the copies into x_in there), and theirs wait for it after (what reads
    bufs there). Over one card no stream waits for another."""
    from uspmv_tpu_torch.runtime import operator

    log = []

    class Stream:
        def __init__(self, i):
            self.i = i

        def wait_stream(self, other):
            log.append(("wait", self.i, other.i))

    class Graph:
        def replay(self):
            log.append(("replay",))

    streams = {i: Stream(i) for i in range(n_cards)}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: streams[d.index])
    devices = [torch.device("cuda", i) for i in range(n_cards)]
    g = operator.CapturedGraph(graph=Graph(), x_in=None, bufs=(), nodes={},
                               devices=devices)
    operator.OperatorBase.replay(g, 2)
    others = range(1, n_cards)
    assert log == ([("wait", 0, i) for i in others] + [("replay",)] * 2
                   + [("wait", i, 0) for i in others])
