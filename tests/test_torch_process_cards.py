"""Several card groups per process in a run of processes, on the CPU.

A run of 2 processes over gloo where each process passes ``devices=[cpu,
cpu]``: its D = R / 2 shards spread over two groups as they would over two
cards (shard r in process r // D, slot i of a process on group i // ceil(D /
2)), the rows between its groups moved by pack, peer copy and unpack, the
rows between processes staged through its first group (the lead card) for
one all-to-all. Each run starts the processes once (this file as a worker,
``python tests/test_torch_process_cards.py worker ...``) and drives every
case in them; process 0 saves what the tests read. For every case y must be
bit-equal to the one-process operator with four groups and with one (the
moves only carry values, and each shard's launches are the same), and agree
with the JAX mesh operator (``use_pallas=False`` on the 8-device CPU mesh)
within the tolerance of tests/test_torch_cards.py: max|y - ref| / max|ref|
<= 1e-12 in f64 and 1e-5 in f32. One group per process (the default
placement on the CPU) must stay as it was: no copy between groups, the
group's own buffers as the all-to-all's, one pack and one unpack per
SpMV, no "cards" in the name.

In-process: the placement rule over the run (``local_cards``,
``run_cards``), and the staging plan against plain indexing on random
plans.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
JAX_TOL = {"dp": 1e-12, "sp": 1e-5}

BASE = dict(kernel_format="scs", chunk_size=4, sigma=8, value_type="sp")
CASES = {
    "sp": dict(),
    "sp-no-overlap": dict(overlap_comm=False),
    "dp": dict(value_type="dp"),
    "ap[dp_sp]": dict(value_type="ap[dp_sp]", ap_threshold_1=2.0),
    "rowwise-4": dict(block_vec_size=4, vector_layout="rowwise"),
    "colwise-4": dict(block_vec_size=4, vector_layout="colwise"),
    "allgather": dict(comm_mode="allgather"),
}
# the bench whose per-host lines tests/test_torch_multihost.py holds
# against the JAX package's
BENCH = dict(kernel_format="scs", chunk_size=4, sigma=8, value_type="sp",
             n_shards=4, print_comm_vol=True, verbose=True)


def config(case, R, backend="cpu"):
    from uspmv_tpu_torch.config import Config

    return Config(backend=backend, n_shards=R, **dict(BASE, **CASES[case]))


def host_x(n, bs):
    rng = np.random.default_rng(7)
    return rng.standard_normal((n, bs) if bs > 1 else n)


# ------------------------------------------------------------------ worker


def count_calls() -> dict:
    """Wrap the moves of the sharded operator: the packs, unpacks, copied
    slices and all-to-alls, counted in the returned dict."""
    import torch.distributed as dist

    from uspmv_tpu_torch.parallel import distributed

    calls = {"pack": 0, "unpack": 0, "slices": 0, "all_to_all": 0}

    def wrap(mod, name, key, weight=lambda *a: 1):
        fn = getattr(mod, name)

        def counted(*args, **kw):
            calls[key] += weight(*args)
            return fn(*args, **kw)

        setattr(mod, name, counted)

    wrap(distributed, "halo_pack", "pack")
    wrap(distributed, "halo_unpack", "unpack")
    wrap(distributed, "peer_copy", "slices", lambda plan, *a: len(plan))
    wrap(dist, "all_to_all_single", "all_to_all")
    return calls


def worker(out_dir, R, coordinator, n, pid):
    """One process of a run: every case with ``devices=[cpu, cpu]`` (one
    SpMV, a solve of 3, the metrics and the calls of one SpMV), the
    default placement (one group) with its calls, a validated solve and,
    at R=4, the bench block; process 0 saves them into ``out_dir``."""
    torch.set_num_threads(1)
    from uspmv_tpu_torch.config import Config
    from uspmv_tpu_torch.io.generators import laplace2d
    from uspmv_tpu_torch.ops.vectors import init_x_host
    from uspmv_tpu_torch.parallel import multihost
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator
    from uspmv_tpu_torch.runtime.bench import bench_spmv
    from uspmv_tpu_torch.runtime.report import format_bench_block
    from uspmv_tpu_torch.runtime.validate import validate_solve

    R, pid = int(R), int(pid)
    info = multihost.initialize(coordinator, int(n), pid, R // int(n),
                                backend="cpu")
    calls = count_calls()
    cpu = torch.device("cpu")
    out = {"multihost": info}
    try:
        mtx = laplace2d(16)

        def drive(cfg, devices):
            op = DistributedSpmvOperator.from_mtx(cfg, mtx, devices=devices)
            x = op.make_x(host_x(op.n_rows, cfg.block_vec_size))
            calls.update(dict.fromkeys(calls, 0))
            y = op.spmv(x)
            spmv_calls = dict(calls)
            y = op.to_host(y)
            _, ys = op.solve(op.make_x(host_x(op.n_rows,
                                              cfg.block_vec_size)), 3)
            lead = op.lead.get(op.precisions[0], {})
            rec = dict(
                impl=op.impl_name(), transport=op.transport(),
                solve=op.solve_impl_name(3), calls=spmv_calls,
                groups=[[g.shards.start, g.shards.stop] for g in op.groups],
                card=op.card.tolist(), n_cards=op.n_cards,
                lead_is_own=bool(lead) and lead["send"] is
                op.groups[0].tbufs[op.precisions[0]]["send"],
                stage={p: dict(send=st.send_counts, recv=st.recv_counts,
                               stage=len(st.stage),
                               unstage=len(st.unstage))
                       for p, st in op.stage.items()},
                bytes=op.bytes_per_spmv(),
                per_host={p: {str(k): v for k, v in h.items()}
                          for p, h in op.comm_volume_per_host().items()},
                per_card={p: {str(k): v for k, v in h.items()}
                          for p, h in op.comm_volume_per_card().items()})
            return op, y, op.to_host(ys), rec

        for case in CASES:
            _, y, ys, rec = drive(config(case, R), [cpu, cpu])
            out[case] = rec
            if pid == 0:
                np.savez(os.path.join(out_dir, f"{case}.npz"), y=y, ys=ys)
        _, y, _, out["one-group"] = drive(config("sp", R), None)
        if pid == 0:
            np.save(os.path.join(out_dir, "one-group.npy"), y)
        # a validated solve from the configuration's x
        cfg = config("dp", R)
        op = DistributedSpmvOperator.from_mtx(cfg, mtx, devices=[cpu, cpu])
        x0 = init_x_host(cfg, op.n_rows, op.matrix_stats, dtype=np.float64)
        _, ys = op.solve(op.make_x(x0), 3)
        got = op.to_host(ys)
        out["validation"] = validate_solve(mtx, x0, got, 3).flag
        if R == 4:
            cfg = Config(backend="cpu", **BENCH)
            op = DistributedSpmvOperator.from_mtx(cfg, laplace2d(24),
                                                  devices=[cpu, cpu])
            res = bench_spmv(op, bench_time=0.02, warmup=1, start_iters=1,
                             timing_reps=1)
            out["bench"] = format_bench_block(cfg, res)
    finally:
        multihost.shutdown()
    if pid == 0:
        with open(os.path.join(out_dir, "run.json"), "w") as f:
            json.dump(out, f)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def run(R, out_dir):
    """Start the 2 processes of a run at R and wait for them; returns
    process 0's record."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("USPMV_COORDINATOR", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", out_dir,
         str(R), f"127.0.0.1:{port}", "2", str(pid)], cwd=REPO, env=env,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    with open(os.path.join(out_dir, "run.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    def get(R):
        return run(R, str(tmp_path_factory.getbasetemp() / f"run{R}")), \
            str(tmp_path_factory.getbasetemp() / f"run{R}")

    for R in (4, 8):
        (tmp_path_factory.getbasetemp() / f"run{R}").mkdir(exist_ok=True)
    return get


# ------------------------------------------------------------- references


@functools.lru_cache(maxsize=None)
def one_process(case, R, n_groups):
    """(operator, y, y of a solve of 3) of the one-process operator with
    ``n_groups`` groups on the CPU."""
    from uspmv_tpu_torch.io.generators import laplace2d
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator

    op = DistributedSpmvOperator.from_mtx(
        config(case, R), laplace2d(16),
        devices=[torch.device("cpu")] * n_groups)
    bs = op.config.block_vec_size
    y = op.to_host(op.spmv(op.make_x(host_x(op.n_rows, bs))))
    _, ys = op.solve(op.make_x(host_x(op.n_rows, bs)), 3)
    return op, y, op.to_host(ys)


@functools.lru_cache(maxsize=None)
def jax_y(case, R):
    """The JAX mesh operator's y of the case (one SpMV)."""
    from uspmv_tpu.config import Config as JConfig
    from uspmv_tpu.io import generators as jgen
    from uspmv_tpu.parallel.distributed import (
        DistributedSpmvOperator as JDistributed,
    )

    jop = JDistributed.from_mtx(
        JConfig(backend="cpu", use_pallas=False, n_shards=R,
                **dict(BASE, **CASES[case])), jgen.laplace2d(16))
    x = host_x(jop.n_rows, CASES[case].get("block_vec_size", 1))
    return np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))


def rel(a, b):
    b = np.asarray(b, dtype=np.float64)
    return np.abs(np.asarray(a, dtype=np.float64) - b).max() / np.abs(b).max()


# ------------------------------------------------------------ the two runs


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("R", [4, 8])
def test_two_processes_of_two_groups_bit_equal(runs, R, case):
    rec, out_dir = runs(R)
    got = np.load(os.path.join(out_dir, f"{case}.npz"))
    four, y4, ys4 = one_process(case, R, 4)
    one, y1, ys1 = one_process(case, R, 1)
    assert np.array_equal(got["y"], y4) and np.array_equal(got["y"], y1)
    assert np.array_equal(got["ys"], ys4) and np.array_equal(got["ys"], ys1)
    r = rel(got["y"], jax_y(case, R))
    assert r <= JAX_TOL["sp" if four.config.value_type == "sp" else "dp"], r
    run = rec[case]
    # 2 x 2 groups: the cards of the whole run in the name, both moves in
    # the transport, the loop over gloo
    assert run["impl"] == four.impl_name()
    assert run["transport"] == "gloo+peer" and run["solve"] == "loop"
    assert run["card"] == four.card.tolist()
    assert run["groups"] == [[0, R // 4], [R // 4, R // 2]]
    assert run["bytes"] == one.bytes_per_spmv()
    assert run["per_host"] == {
        p: {str(q): sum(h for s, h in enumerate(plan["per_shard"])
                        if s // (R // 2) == q) for q in range(2)}
        for p, plan in one.comm_volume_per_spmv().items()
        if one.halo_plans[p] is not None}
    assert run["per_card"] == {
        p: {str(k): v for k, v in h.items()}
        for p, h in four.comm_volume_per_card().items()}
    if case != "allgather":
        # per SpMV and precision: each group packs and unpacks once, one
        # all-to-all; a slice per move between the groups and staged
        n_prec = sum(p in four.groups[0].tbufs for p in four.precisions)
        calls = run["calls"]
        assert calls["pack"] == calls["unpack"] == 2 * n_prec
        assert calls["all_to_all"] == n_prec and calls["slices"] > 0
        assert not run["lead_is_own"]


@pytest.mark.parametrize("R", [4, 8])
def test_one_group_per_process_stays_as_it_was(runs, R):
    """The default placement on the CPU: one group a process, the
    operator of one group in a run of processes (no copy between groups,
    the group's own buffers as the all-to-all's, one pack and unpack)."""
    rec, out_dir = runs(R)
    run = rec["one-group"]
    one, y1, _ = one_process("sp", R, 1)
    assert np.array_equal(np.load(os.path.join(out_dir, "one-group.npy")), y1)
    assert run["impl"] == one.impl_name() == f"torch-plain-dist{R}-scs-sp"
    assert run["transport"] == "gloo" and run["n_cards"] == 1
    assert run["card"] == [r // (R // 2) for r in range(R)]
    assert run["calls"] == {"pack": 1, "unpack": 1, "slices": 0,
                            "all_to_all": 1}
    assert run["lead_is_own"]
    st = run["stage"]["sp"]
    assert (st["stage"], st["unstage"]) == (1, 1)  # in place: one slice
    assert rec["multihost"]["devices"] == ["cpu"]
    assert rec["multihost"]["process_devices"] == [["cpu"], ["cpu"]]


@pytest.mark.parametrize("R", [4, 8])
def test_solve_validates(runs, R):
    assert runs(R)[0]["validation"] == "OK"


def per_host_lines(text):
    return [ln.strip() for ln in text.splitlines()
            if "halo elems/SpMV per host" in ln]


def test_bench_per_host_lines_equal_jax(runs):
    """The JAX package's per-host lines of its 2 x 2 run (taken as
    tests/test_torch_multihost.py takes them, from its plan in process),
    and a per-card line of the four groups."""
    from test_torch_multihost import jax_per_host_lines

    from uspmv_tpu_torch.config import Config
    from uspmv_tpu_torch.io.generators import laplace2d
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator

    text = runs(4)[0]["bench"]
    assert per_host_lines(text) == jax_per_host_lines([0, 0, 1, 1])
    four = DistributedSpmvOperator.from_mtx(
        Config(backend="cpu", **BENCH), laplace2d(24),
        devices=[torch.device("cpu")] * 4)
    per = four.comm_volume_per_card()["sp"]
    assert ("halo elems/SpMV per card: " + "  ".join(
        f"card{c}={v}" for c, v in sorted(per.items()))) in text
    assert text.count(" card=3") == 1 and "shard 3:" in text


# -------------------------------------------------------------- in-process

PLACEMENT = {
    # (local rank, local processes, visible cards): the process's cards
    (0, 2, 4): [0, 1], (1, 2, 4): [2, 3],  # c = 2
    (1, 4, 4): [1], (3, 4, 4): [3],  # c = 1
    (1, 2, 5): [2, 3],  # c = 2, card 4 idle
    (0, 2, 1): [0], (1, 2, 1): [0],  # c < 1: shared
    (2, 4, 2): [0], (3, 4, 2): [1],
    (0, 1, 8): list(range(8)),
}


@pytest.mark.parametrize("rank,n_local,count", sorted(PLACEMENT))
def test_local_cards(rank, n_local, count):
    from uspmv_tpu_torch.parallel.multihost import local_cards, transport_for

    assert local_cards(rank, n_local, count) == PLACEMENT[(rank, n_local,
                                                           count)]
    assert transport_for("cuda", n_local, count) == (
        "nccl" if count >= n_local else "gloo-staged")


RUN_PLACEMENT = {
    # (R, P, D, cards of each process): (process, group) of each shard
    (4, 2, 2, (2, 2)): ([0, 0, 1, 1], [0, 1, 2, 3]),  # 2 x 2 cards
    (8, 2, 4, (2, 2)): ([0] * 4 + [1] * 4, [0, 0, 1, 1, 2, 2, 3, 3]),
    (4, 4, 1, (1, 1, 1, 1)): ([0, 1, 2, 3], [0, 1, 2, 3]),  # c = 1
    (4, 2, 2, (1, 1)): ([0, 0, 1, 1], [0, 0, 1, 1]),  # c = 1 or shared
    (6, 2, 3, (2, 2)): ([0] * 3 + [1] * 3, [0, 0, 1, 2, 2, 3]),  # D > c
    (8, 2, 4, (4, 1)): ([0] * 4 + [1] * 4, [0, 1, 2, 3, 4, 4, 4, 4]),
    (5, 2, 3, (2, 2)): ([0, 0, 0, 1, 1], [0, 0, 1, 2, 2]),  # slot rule
    (4, 2, 2, (4, 4)): ([0, 0, 1, 1], [0, 1, 2, 3]),  # cards idle
    (4, 1, 4, (4,)): ([0] * 4, [0, 1, 2, 3]),  # one process
}


@pytest.mark.parametrize("R,P,D,cards", sorted(RUN_PLACEMENT))
def test_run_placement(monkeypatch, R, P, D, cards):
    """Shard r in process r // D, slot i of process p on its group i //
    ceil(D / min(D, cards)), the groups numbered across the run; what
    ``from_mtx`` builds in each process (``devices`` standing for its
    cards, the others' counts from the collective)."""
    from uspmv_tpu_torch.io.generators import laplace2d
    from uspmv_tpu_torch.parallel import multihost
    from uspmv_tpu_torch.parallel.distributed import (
        DistributedSpmvOperator,
        run_cards,
        shard_owners,
        shard_slots,
    )

    owner, card = RUN_PLACEMENT[(R, P, D, cards)]
    # the other processes' stream summaries: those of one process
    whole = DistributedSpmvOperator.from_mtx(config("sp", R), laplace2d(16))
    full = {p: dict(enumerate(sm)) for p, sm in whole.summaries.items()}
    for me in range(P):
        monkeypatch.setattr(multihost, "_state", dict(
            process_id=me, n_processes=P, n_local_devices=D,
            transport="gloo"))
        got_owner, shards = shard_owners(R)
        assert got_owner.tolist() == owner and shard_slots(R) == D
        assert run_cards(got_owner, D, cards).tolist() == card
        monkeypatch.setattr(multihost, "gather_object",
                            lambda obj: [full] * P if isinstance(obj, dict)
                            else list(cards))
        op = DistributedSpmvOperator.from_mtx(
            config("sp", R), laplace2d(16),
            devices=[torch.device("cpu")] * cards[me])
        assert op.card.tolist() == card and op.owner.tolist() == owner
        mine = [c for c, o in zip(card, owner) if o == me]
        assert [g.index for g in op.groups] == sorted(set(mine))
        assert [list(g.shards) for g in op.groups] == [
            [r for r in shards if card[r] == g] for g in sorted(set(mine))]
        spread = max(card) + 1 > P  # a process holds several groups
        assert op.impl_name() == whole.impl_name().replace(
            f"dist{R}-", f"dist{R}-{max(card) + 1}cards-" if spread
            else f"dist{R}-")
        inside = "peer" if len(op.groups) > 1 else None
        between = "gloo" if P > 1 else None
        assert op.transport() == "+".join(
            t for t in (between, inside) if t) or None


def random_plan(seed):
    """A halo plan of R shards of a random sparse matrix, with a random
    assignment of the shards to processes and groups."""
    from uspmv_tpu_torch.formats.coo import MtxData
    from uspmv_tpu_torch.formats.scs import convert_to_scs
    from uspmv_tpu_torch.parallel.halo import build_halo_plan

    rng = np.random.default_rng(seed)
    n, R = 120, int(rng.integers(4, 9))
    rows = rng.integers(0, n, 700)
    cols = rng.integers(0, n, 700)
    key = np.unique(rows * n + cols)
    m = MtxData.from_arrays(key // n, key % n, rng.standard_normal(key.size),
                            n_rows=n, n_cols=n).sort_by_row()
    ws = np.linspace(0, n, R + 1).astype(np.int64)
    scs = [convert_to_scs(m.slice_rows(int(ws[r]), int(ws[r + 1])), 4, 4)
           for r in range(R)]
    plan = build_halo_plan(scs, ws)
    # consecutive groups of shards, consecutive processes of groups
    card = np.cumsum(np.r_[0, rng.random(R - 1) < 0.6]).astype(np.int64)
    n_groups = int(card[-1]) + 1
    gproc = np.cumsum(np.r_[0, rng.random(n_groups - 1) < 0.5]).astype(
        np.int64)
    return plan, card, gproc[card], gproc


@pytest.mark.parametrize("seed", range(12))
def test_staging_moves_rows_as_indexing(seed):
    """pack -> stage -> all-to-all -> unstage -> unpack over every process
    of a random placement equals the one-process exchange on the stacked
    x; each group's rows for another process leave in one copy, and the
    all-to-all's split is the rows between the processes."""
    from uspmv_tpu_torch.ops.halo_exchange import (
        build_device_transfer,
        halo_pack,
        halo_unpack,
        peer_copy,
        peer_plan,
        stage_plan,
    )
    from uspmv_tpu_torch.parallel.halo import (
        exchange_rows,
        group_pair_counts,
        split_exchange_rows,
    )

    plan, card, owner, gproc = random_plan(seed)
    R, L = plan.n_shards, plan.H + 1
    P = int(owner[-1]) + 1
    rng = np.random.default_rng(100 + seed)
    x = rng.standard_normal((R, L))
    want = x.copy().reshape(-1)
    src, dst = exchange_rows(plan, L)
    want[dst] = want[src]
    counts = group_pair_counts(plan, card)
    G = int(card[-1]) + 1
    cpu = torch.device("cpu")
    # per group: its stacked x, its transfer and buffers
    xs, trs, sends, recvs = [], [], [], []
    for g in range(G):
        mine = np.flatnonzero(card == g)
        xg = torch.from_numpy(x[mine].copy())
        s, d, send, recv = split_exchange_rows(plan, L, card, g)
        flat = xg.view(-1)
        flat[torch.from_numpy(d)] = flat[torch.from_numpy(s)]
        tr = build_device_transfer(send, recv, mine.size, L, True, cpu)
        assert tr.send_counts == counts[g].tolist()
        assert tr.recv_counts == counts[:, g].tolist()
        xs.append(xg)
        trs.append(tr)
        sends.append(halo_pack(tr, xg, torch.zeros(tr.n_send,
                                                   dtype=xg.dtype)))
        recvs.append(torch.zeros(tr.n_recv, dtype=xg.dtype))
    # per process: the moves between its groups, its staging
    lead_send, plans = [], []
    for q in range(P):
        gs = np.flatnonzero(gproc == q)
        first = int(gs[0])
        peer_copy(peer_plan([trs[g] for g in gs], first),
                  [sends[g] for g in gs], [recvs[g] for g in gs])
        st = stage_plan(counts, gproc, q)
        plans.append(st)
        buf = torch.zeros(st.n_send, dtype=torch.float64)
        peer_copy(st.stage, [sends[g] for g in gs], [buf])
        lead_send.append(buf)
        # at most one copy per (group, other process) slice it sends, and
        # none out of place where the process holds one group
        assert len(st.stage) <= sum(
            1 for g in gs for t in range(P) if t != q and
            counts[g, gproc == t].sum())
        assert sum(m.n for m in st.stage) == st.n_send
        assert sum(m.n for m in st.unstage) == st.n_recv
        if gs.size == 1:
            for moves, n in ((st.stage, st.n_send),
                             (st.unstage, st.n_recv)):
                assert [(m.send_lo, m.recv_lo, m.n) for m in moves] == (
                    [(0, 0, n)] if n else [])
        assert st.send_counts[q] == st.recv_counts[q] == 0
        assert st.send_counts == [int(counts[np.ix_(gproc == q,
                                                    gproc == t)].sum())
                                  * (t != q) for t in range(P)]
    # the all-to-all: process t receives, in process order, each
    # process's chunk for it
    for q in range(P):
        chunks = [torch.split(lead_send[t], plans[t].send_counts)[q]
                  for t in range(P)]
        assert [c.numel() for c in chunks] == plans[q].recv_counts
        gs = np.flatnonzero(gproc == q)
        peer_copy(plans[q].unstage, [torch.cat(chunks)],
                  [recvs[g] for g in gs])
    for g in range(G):
        halo_unpack(trs[g], recvs[g], xs[g])
    got = torch.cat(xs).numpy().reshape(-1)
    assert np.array_equal(got, want)


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    worker(*sys.argv[2:])
