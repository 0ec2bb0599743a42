"""Multi-process execution of uspmv_tpu_torch on the CPU: real gloo runs of
2 and 4 processes (torch.distributed), against the one-process sharded
operator and the JAX package.

Modelled on tests/test_multihost.py: each run starts n subprocesses of the
same line with ``-coordinator/-n_processes/-process_id`` on a free port,
``OMP_NUM_THREADS=1``, and a ``communicate(timeout=...)`` that kills every
process of the run when one hangs. The CLI cases run
``python -m uspmv_tpu_torch.cli ... -backend cpu``; the bit-equality cases
run this file as a worker (``python tests/test_torch_multihost.py
worker ...``), which builds the sharded operator in each process, runs one
SpMV and a solve of 3 repetitions, and has process 0 save both y. The
one-process sharded operator on the same matrix and x must give the same
bits: the processes hold the same shards' streams, run the same plain
versions on them, and the transfer moves the halo rows as they are. The
bench's per-host report line is held against the JAX package's, which the
test takes in process from the JAX operator's plan (no JAX bench cluster).

In-process: the per-process split of the exchange plan, the pack and
unpack wrappers against indexing, the transport rule, shard ownership,
``initialize``'s refusals (the JAX ValueError) and the parity leftovers
(``apply_strided_permutation`` and the package's re-exports) against the
JAX package. The pack and unpack kernels are checked on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 12).
"""

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


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cluster(argv_of, n, timeout=TIMEOUT):
    """Start ``argv_of(pid, port)`` for pid < n; (return codes, outputs).
    Every process is killed when one outlives ``timeout``."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("USPMV_COORDINATOR", None)  # the command line says it
    procs = [subprocess.Popen(argv_of(pid, port), cwd=REPO, env=env,
                              text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for pid in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def cli_cluster(args, tmp_path, n=2, local_devices=2):
    """The port's CLI line ``args`` on n processes of ``local_devices``
    shards each, on the CPU, its files into ``tmp_path``."""
    tmp_path.mkdir(parents=True, exist_ok=True)

    def argv_of(pid, port):
        return [sys.executable, "-m", "uspmv_tpu_torch.cli", *args,
                "-coordinator", f"localhost:{port}", "-n_processes", str(n),
                "-process_id", str(pid), "-local_devices",
                str(local_devices), "-backend", "cpu",
                "-mtx_out", str(tmp_path)]

    return run_cluster(argv_of, n)


def last_json(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


# ------------------------------------------------------------ CLI clusters


def test_two_process_solve_validates_on_process_0(tmp_path):
    args = ["Laplace2D,24", "scs", "-c", "4", "-s", "8", "-mode", "s",
            "-rev", "3", "-n_shards", "4", "-seg_method", "seg-nnz",
            "-validate", "1", "-verbose", "1"]
    rcs, outs = cli_cluster(args, tmp_path)
    assert rcs == [0, 0], outs
    assert "[OK]" in outs[0], outs[0]
    assert "[OK]" not in outs[1] and "[multihost]" not in outs[1], outs[1]
    assert "impl: solve-loop[torch-plain-dist4-scs-dp]" in outs[0]
    line = [ln for ln in outs[0].splitlines() if ln.startswith("[multihost]")]
    assert line and "'transport': 'gloo'" in line[0], outs[0]
    assert "'n_local_devices': 2" in line[0]
    assert os.path.exists(tmp_path / "spmv_scipy_compare_dp.txt")


def per_host_lines(out):
    return [ln.strip() for ln in out.splitlines()
            if "halo elems/SpMV per host" in ln]


def jax_per_host_lines(owner):
    """The JAX package's per-host lines of the bench below, taken in this
    process: its operator's halo plan for the same matrix, configuration
    and shards, the plan's halo counts rolled up by the process that holds
    each shard (as its ``comm_volume_per_host`` does on a mesh spread over
    processes), written by its own report. A JAX bench cluster is not
    started: its timed doubling reads each process's own clock
    (uspmv_tpu/runtime/bench.py:145-152), so two processes can disagree on
    the batch count and one waits in a collective the other never runs."""
    from uspmv_tpu.config import Config as JConfig
    from uspmv_tpu.io import generators as jgen
    from uspmv_tpu.parallel.distributed import (
        DistributedSpmvOperator as JDistributed,
    )
    from uspmv_tpu.runtime.bench import BenchResult as JBenchResult
    from uspmv_tpu.runtime.report import format_bench_block as jformat

    cfg = JConfig(kernel_format="scs", chunk_size=4, sigma=8,
                  value_type="sp", n_shards=4, print_comm_vol=True,
                  verbose=True, backend="cpu", use_pallas=False)
    jop = JDistributed.from_mtx(cfg, jgen.laplace2d(24))
    per_host = {}
    for p, hp in jop.halo_plans.items():
        if hp is not None:
            acc = {}
            for r, h in enumerate(hp.halo_counts):
                acc[owner[r]] = acc.get(owner[r], 0) + int(h)
            per_host[p] = acc
    res = JBenchResult(
        perf_gflops=0.0, effective_gbps=0.0, duration_total_s=0.0,
        duration_kernel_s=0.0, n_iterations=1, nnz=0, block_vec_size=1,
        value_type="sp", kernel_format="scs", C=4, sigma=8, beta={},
        device_beta={}, nnz_per_precision={}, memory_footprint_bytes=0,
        n_rows=0, platform="cpu", comm_volume_per_host=per_host,
        n_processes=max(owner) + 1)
    return per_host_lines(jformat(cfg, res))


def test_two_process_bench_per_host_lines_equal_jax(tmp_path):
    args = ["Laplace2D,24", "scs", "-c", "4", "-s", "8", "-mode", "b",
            "-bench_time", "0.05", "-n_shards", "4", "-sp",
            "-print_comm_vol", "1", "-verbose", "1"]
    rcs, outs = cli_cluster(args, tmp_path / "port")
    assert rcs == [0, 0], outs
    out = outs[0]
    assert "host0=" in out and "host1=" in out, out
    assert "shard 0:" in out and "shard 3:" in out, out
    assert "comm volume:" in outs[0] and "perf:" not in outs[1], outs[1]
    # shards 0-1 on process 0, 2-3 on process 1 (-local_devices 2)
    jlines = jax_per_host_lines([0, 0, 1, 1])
    assert per_host_lines(out) == jlines, (out, jlines)
    assert per_host_lines(out) == [
        "[sp] halo elems/SpMV per host: host0=72  host1=72"]


def test_four_processes_one_shard_each(tmp_path):
    """Every exchange crosses a process, and seg-nnz makes the process
    boundaries asymmetric."""
    args = ["Laplace2D,20", "scs", "-c", "8", "-s", "16", "-mode", "s",
            "-rev", "2", "-n_shards", "4", "-seg_method", "seg-nnz",
            "-rand_x", "1", "-json"]
    rcs, outs = cli_cluster(args, tmp_path, n=4, local_devices=1)
    assert rcs == [0, 0, 0, 0], outs
    rep = last_json(outs[0])["validation"]
    assert rep["flag"] == "OK"
    assert rep["max_rel_diff"] < 1e-13
    assert all("{" not in o for o in outs[1:]), outs[1:]


def test_two_process_dp_crs_exact_vs_oracle(tmp_path):
    args = ["Laplace2D,16", "crs", "-mode", "s", "-rev", "2",
            "-n_shards", "4", "-rand_x", "1", "-json"]
    rcs, outs = cli_cluster(args, tmp_path)
    assert rcs == [0, 0], outs
    rep = last_json(outs[0])["validation"]
    assert rep["flag"] == "OK"
    assert rep["max_rel_diff"] < 1e-13


def test_validate_campaign_multihost_sweep(tmp_path, monkeypatch):
    """--multihost adds the JAX script's three configurations, each a run
    of two processes through the CLI, validated on process 0."""
    from uspmv_tpu_torch.scripts import validate_campaign

    monkeypatch.setenv("USPMV_CAMPAIGN_DIR", str(tmp_path / "files"))
    monkeypatch.delenv("USPMV_COORDINATOR", raising=False)
    args = validate_campaign.build_parser().parse_args(
        ["--quick", "--multihost", "--backend", "cpu", "--matrices",
         "Laplace2D,8", "--out", str(tmp_path / "rows.jsonl")])
    argvs = validate_campaign.multihost_sweep(args)
    assert [a[1][1:3] for a in argvs] == [["scs", "-c"], ["crs", "-dp"],
                                         ["scs", "-c"]]
    rows = validate_campaign.run(args)
    multi = [r for r in rows if r.get("n_processes") == 2]
    assert len(multi) == 3 and all(r["rc"] == 0 for r in rows), rows
    # (C=1024 packs a matrix of 64 rows: its fill is under 0.5)
    assert [r["impl"] for r in multi] == [
        "solve-loop[torch-plain-dist4-scs-sp]",
        "solve-loop[torch-plain-dist4-scs-dp]",
        "solve-loop[torch-plain-dist4-packed-sp]"]


# ------------------------------------------- y against one process, bit-equal

MATRIX = "Laplace2D,20"
BIT_CASES = {
    "sp-overlap": dict(value_type="sp"),
    "sp-no-overlap": dict(value_type="sp", overlap_comm=False),
    "rowwise-bs4": dict(value_type="sp", block_vec_size=4,
                        vector_layout="rowwise"),
    "colwise-bs4": dict(value_type="sp", block_vec_size=4,
                        vector_layout="colwise"),
    "ap[dp_sp]": dict(value_type="ap[dp_sp]", ap_threshold_1=3.5),
    "allgather": dict(value_type="dp", comm_mode="allgather"),
    "seg-metis": dict(value_type="dp", seg_method="seg-metis"),
    "pieces": dict(value_type="sp", seg_method="seg-nnz",
                   split_rows_threshold=3, matrix="RandomImbalanced,400,6"),
}


def worker_config(kw):
    from uspmv_tpu_torch.config import Config

    kw = {k: v for k, v in kw.items() if k != "matrix"}
    return Config(**dict(dict(kernel_format="scs", chunk_size=8, sigma=4,
                              n_shards=4, backend="cpu"), **kw))


def worker_x(n_rows, bs):
    return np.random.default_rng(3).standard_normal(
        (n_rows, bs) if bs > 1 else n_rows)


def one_process(kw):
    """(y of one SpMV, y of a solve of 3) of the one-process operator."""
    from uspmv_tpu_torch.io.generators import generate_matrix
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator

    cfg = worker_config(kw)
    mtx = generate_matrix(kw.get("matrix", MATRIX))
    op = DistributedSpmvOperator.from_mtx(cfg, mtx)
    x = worker_x(mtx.n_rows, cfg.block_vec_size)
    y = op.to_host(op.spmv(op.make_x(x)))
    _, ys = op.solve(op.make_x(x), 3)
    return y, op.to_host(ys), op


def worker(out_path, kw_json, coordinator, n, pid, local_devices):
    """One process of a bit-equality run: initialize, build, one SpMV and a
    solve of 3 through to_host (collectives: every process calls them);
    process 0 saves y, the solve's y and the operator's metrics."""
    torch.set_num_threads(1)
    from uspmv_tpu_torch.parallel import multihost

    multihost.initialize(coordinator, int(n), int(pid), int(local_devices),
                         backend="cpu")
    try:
        kw = json.loads(kw_json)
        y, ys, op = one_process(kw)
        if int(pid) == 0:
            np.savez(out_path, y=y, ys=ys, meta=json.dumps(dict(
                impl=op.impl_name(), n_local=op.n_local,
                solve=op.solve_impl_name(3),
                per_shard_nnz=op.per_shard_nnz(),
                bytes=op.bytes_per_spmv(),
                per_host={p: {str(k): v for k, v in h.items()}
                          for p, h in op.comm_volume_per_host().items()},
                device_beta=op.device_beta(), n_pieces=op.n_pieces())))
    finally:
        multihost.shutdown()


@pytest.mark.parametrize("case,n,local_devices", [
    *[(case, 2, 2) for case in sorted(BIT_CASES)],
    ("sp-overlap", 4, 1), ("colwise-bs4", 4, 1), ("ap[dp_sp]", 4, 1)])
def test_processes_bit_equal_to_one_process(case, n, local_devices, tmp_path):
    kw = BIT_CASES[case]
    out = tmp_path / "y.npz"

    def argv_of(pid, port):
        return [sys.executable, os.path.abspath(__file__), "worker",
                str(out), json.dumps(kw), f"127.0.0.1:{port}", str(n),
                str(pid), str(local_devices)]

    rcs, outs = run_cluster(argv_of, n)
    assert rcs == [0] * n, outs
    got = np.load(out)
    y, ys, op = one_process(kw)
    assert np.array_equal(got["y"], y)
    assert np.array_equal(got["ys"], ys)
    meta = json.loads(str(got["meta"]))
    assert meta["impl"] == op.impl_name()
    assert meta["n_local"] == 4 // n and meta["solve"] == "loop"
    assert meta["per_shard_nnz"] == op.per_shard_nnz()
    assert meta["bytes"] == op.bytes_per_spmv()
    assert meta["device_beta"] == op.device_beta()
    assert meta["n_pieces"] == op.n_pieces()
    if case == "pieces":
        assert op.n_pieces() > 0
    # the same halo counts, grouped by the process that holds the shard
    want = {p: {str(q): sum(h for r, h in enumerate(plan["per_shard"])
                            if r // local_devices == q) for q in range(n)}
            for p, plan in op.comm_volume_per_spmv().items()
            if op.halo_plans[p] is not None}
    assert meta["per_host"] == want


# ------------------------------------------------------------- in-process


def halo_plan(R=4, seg="seg-nnz", value=None):
    from uspmv_tpu_torch.formats.scs import convert_to_scs
    from uspmv_tpu_torch.io.generators import laplace2d
    from uspmv_tpu_torch.parallel.halo import build_halo_plan
    from uspmv_tpu_torch.parallel.partition import seg_work_sharing

    m = laplace2d(14)
    ws, _ = seg_work_sharing(m, R, seg)
    scs = [convert_to_scs(m.slice_rows(int(ws[r]), int(ws[r + 1])), 4, 4)
           for r in range(R)]
    return build_halo_plan(scs, ws)


@pytest.mark.parametrize("no_pack", [False, True])
@pytest.mark.parametrize("R,owner", [
    (4, [0, 0, 1, 1]), (4, [0, 1, 2, 3]), (4, [0, 0, 0, 1]),
    (5, [0, 0, 0, 1, 1]), (4, [0, 0, 0, 0])])
def test_split_exchange_rows_together_equal_one_process(R, owner, no_pack):
    from uspmv_tpu_torch.parallel.halo import (
        exchange_rows,
        split_exchange_rows,
    )

    plan = halo_plan(R)
    L = plan.H + 1
    owner = np.asarray(owner)
    P = owner.max() + 1
    rng = np.random.default_rng(R)
    x = rng.standard_normal((R, L))
    x[:, max(plan.n_rows_padded):] = 0  # halo rows start empty
    want = x.copy().reshape(-1)
    src, dst = exchange_rows(plan, L, no_pack=no_pack)
    want[dst] = want[src]
    # every process's stack: its shards in order
    stacks = [x[owner == q].copy().reshape(-1) for q in range(P)]
    parts = [split_exchange_rows(plan, L, owner, q, no_pack=no_pack)
             for q in range(P)]
    for q, (s, d, send, recv) in enumerate(parts):
        assert len(send) == len(recv) == P
        assert send[q].size == recv[q].size == 0
        stacks[q][d] = stacks[q][s]
    for q in range(P):  # q sends to t what t receives from q, row for row
        for t in range(P):
            rows = stacks[q][parts[q][2][t]]
            assert parts[t][3][q].size == rows.size
            stacks[t][parts[t][3][q]] = rows
    got = np.concatenate([st.reshape(-1, L) for st in stacks])
    assert np.array_equal(got.reshape(-1), want)
    n_local = sum(s.size for s, *_ in parts)
    n_cross = sum(a.size for p in parts for a in p[2])
    assert n_local + n_cross == src.size
    assert (n_cross == 0) == (P == 1)


def transfer_case(layout, bs, dtype, seed=0):
    """A stacked x of 3 shards of 50 rows and a transfer that sends 20 and
    receives 15 distinct rows."""
    from uspmv_tpu_torch.ops.halo_exchange import build_device_transfer

    rng = np.random.default_rng(seed)
    rows = rng.permutation(150)
    tr = build_device_transfer([rows[:12], rows[12:20]],
                               [rows[20:30], rows[30:35]], 3, 50, True,
                               torch.device("cpu"))
    shape = ((3, 50) if bs == 1 else (bs, 3, 50) if layout == "colwise"
             else (3, 50, bs))
    x = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    return tr, x


def flat_rows(x, layout, bs):
    """x as [rows, values of a row] (numpy)."""
    a = x.numpy()
    if bs == 1:
        return a.reshape(-1, 1)
    if layout == "colwise":
        return np.moveaxis(a, 0, -1).reshape(-1, bs)
    return a.reshape(-1, bs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout,bs", [("rowwise", 1), ("rowwise", 4),
                                       ("colwise", 4)])
def test_pack_and_unpack_match_indexing(layout, bs, dtype):
    from uspmv_tpu_torch.ops import halo_exchange as hx

    tr, x = transfer_case(layout, bs, dtype)
    assert (tr.n_send, tr.n_recv) == (20, 15)
    assert tr.send_counts == [12, 8] and tr.recv_counts == [10, 5]
    buf = torch.zeros(tr.buffer_shape(tr.n_send, bs), dtype=dtype)
    before = hx.launch_counts()
    hx.halo_pack(tr, x, buf, layout)
    want = flat_rows(x, layout, bs)[tr.send.numpy()]
    assert np.array_equal(buf.numpy().reshape(want.shape), want)
    assert np.array_equal(
        hx.halo_pack_plain(tr, x, torch.empty_like(buf), layout), buf)
    # unpack: the received rows land at tr.recv, nothing else moves
    inc = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tr.buffer_shape(tr.n_recv, bs))).to(dtype)
    y = hx.halo_unpack(tr, inc, x.clone(), layout)
    want = flat_rows(x, layout, bs).copy()
    want[tr.recv.numpy()] = inc.numpy().reshape(-1, bs if bs > 1 else 1)
    assert np.array_equal(flat_rows(y, layout, bs), want)
    assert torch.equal(hx.halo_unpack_plain(tr, inc, x.clone(), layout), y)
    # the CPU runs the plain versions: no kernel launch is counted
    assert hx.launch_counts() == before


def test_pack_checks_its_buffer():
    from uspmv_tpu_torch.ops import halo_exchange as hx

    tr, x = transfer_case("rowwise", 1, torch.float32)
    with pytest.raises(ValueError, match="buffer"):
        hx.halo_pack(tr, x, torch.zeros(tr.n_send + 1), "rowwise")
    with pytest.raises(ValueError, match="buffer"):
        hx.halo_pack(tr, x, torch.zeros(tr.n_send, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32 or float64"):
        hx.halo_pack(tr, x.half(), torch.zeros(tr.n_send).half())
    with pytest.raises(ValueError, match="outside"):
        hx.build_device_transfer([np.array([150])], [np.array([0])], 3, 50,
                                 True, torch.device("cpu"))


def test_transport_rule():
    from uspmv_tpu_torch.parallel.multihost import transport_for
    from uspmv_tpu_torch.runtime.operator import DeviceUnavailableError

    assert transport_for("cpu", 4, 0) == "gloo"
    assert transport_for("cuda", 4, 4) == "nccl"
    assert transport_for("cuda", 1, 8) == "nccl"
    assert transport_for("cuda", 2, 1) == "gloo-staged"
    assert transport_for("cuda", 2, 4) == "nccl"  # two cards a process
    assert transport_for("cuda", 3, 2) == "gloo-staged"
    with pytest.raises(DeviceUnavailableError):
        transport_for("cuda", 2, 0)


@pytest.mark.parametrize("R,P,me,D,owner,shards", [
    (4, 2, 0, None, [0, 0, 1, 1], (0, 2)),
    (4, 2, 1, None, [0, 0, 1, 1], (2, 4)),
    (5, 2, 1, None, [0, 0, 0, 1, 1], (3, 5)),
    (4, 2, 1, 3, [0, 0, 0, 1], (3, 4)),
    (4, 4, 3, 1, [0, 1, 2, 3], (3, 4)),
    (4, 1, 0, None, [0, 0, 0, 0], (0, 4)),
])
def test_shard_owners(monkeypatch, R, P, me, D, owner, shards):
    from uspmv_tpu_torch.parallel import multihost
    from uspmv_tpu_torch.parallel.distributed import shard_owners

    monkeypatch.setattr(multihost, "_state", dict(
        process_id=me, n_processes=P, n_local_devices=D, transport="gloo"))
    got_owner, got_shards = shard_owners(R)
    assert got_owner.tolist() == owner
    assert (got_shards.start, got_shards.stop) == shards


@pytest.mark.parametrize("R,P,D,match", [
    (4, 2, 1, "need 4 devices"), (4, 4, 2, "without a shard")])
def test_shard_owners_refusals(monkeypatch, R, P, D, match):
    from uspmv_tpu_torch.parallel import multihost
    from uspmv_tpu_torch.parallel.distributed import shard_owners

    monkeypatch.setattr(multihost, "_state", dict(
        process_id=0, n_processes=P, n_local_devices=D, transport="gloo"))
    with pytest.raises(ValueError, match=match):
        shard_owners(R)


@pytest.mark.parametrize("kw", [dict(n_processes=2), dict(process_id=1),
                                dict(n_processes=2, process_id=0)])
def test_initialize_needs_a_coordinator_as_in_jax(monkeypatch, kw):
    from uspmv_tpu.parallel import multihost as jmh

    from uspmv_tpu_torch.parallel import multihost

    for var in ("USPMV_COORDINATOR", "USPMV_N_PROCESSES", "USPMV_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    text = "-coordinator HOST:PORT is required when -n_processes or"
    with pytest.raises(ValueError, match=text):
        jmh.initialize(**kw)
    with pytest.raises(ValueError, match=text):
        multihost.initialize(**kw, backend="cpu")
    assert multihost.info() is None and not multihost.is_multiprocess()


def test_cli_flags_bootstrap_or_refuse(monkeypatch):
    from uspmv_tpu_torch import cli

    monkeypatch.delenv("USPMV_COORDINATOR", raising=False)
    base = ["Laplace2D,8", "scs", "-c", "4", "-n_shards", "2"]
    with pytest.raises(ValueError, match="-coordinator HOST:PORT"):
        cli.main([*base, "-n_processes", "2", "-backend", "cpu"])
    # -backend cuda without a card: rc 3 before any process group starts
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([*base, "-coordinator", "127.0.0.1:1", "-n_processes",
                     "2", "-process_id", "0", "-backend", "cuda"]) == 3
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_one_process_fetch_global_and_counts():
    from uspmv_tpu_torch.parallel import multihost

    t = torch.arange(6.0).reshape(2, 3)
    assert np.array_equal(multihost.fetch_global(t), t.numpy())
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.agree_max(1.5) == 1.5
    assert multihost.transport() is None


# ------------------------------------------------------- parity leftovers


@pytest.mark.parametrize("stride", [1, 3])
def test_apply_strided_permutation_matches_jax(stride):
    import uspmv_tpu as jax_pkg

    import uspmv_tpu_torch as port

    rng = np.random.default_rng(stride)
    perm = rng.permutation(7)
    vec = rng.standard_normal(7 * stride + 2)  # a tail that stays
    got = port.apply_strided_permutation(vec, perm, stride)
    assert np.array_equal(got, jax_pkg.apply_strided_permutation(
        vec, perm, stride))
    assert np.array_equal(got[7 * stride:], vec[7 * stride:])


REEXPORTS = ("apply_strided_permutation", "equilibrate_matrix",
             "extract_largest_row_elems", "extract_largest_col_elems",
             "ap_threshold_from_norm")


def test_reexports_match_jax():
    import uspmv_tpu as jax_pkg
    from uspmv_tpu.io import generators as jgen

    import uspmv_tpu_torch as port
    from uspmv_tpu_torch.io import generators as tgen

    for name in REEXPORTS:
        assert name in port.__all__ and hasattr(jax_pkg, name)
    jm, tm = jgen.wide_spectrum(4), tgen.wide_spectrum(4)
    for name in ("extract_largest_row_elems", "extract_largest_col_elems"):
        assert np.array_equal(getattr(port, name)(tm),
                              np.asarray(getattr(jax_pkg, name)(jm)))
    assert port.ap_threshold_from_norm(tm, 1e-3) == \
        jax_pkg.ap_threshold_from_norm(jm, 1e-3)
    je, te = jm.copy(), tm.copy()
    for a, b in zip(jax_pkg.equilibrate_matrix(je),
                    port.equilibrate_matrix(te)):
        assert np.array_equal(np.asarray(a), b)
    assert np.array_equal(np.asarray(je.values), te.values)


def test_solve_diag_fits_each_mode(tmp_path):
    """The port of scripts/solve_diag.py: the line fit, and one row per
    (matrix, mode) on the CPU (the loop; graph and fused need the card)."""
    from uspmv_tpu_torch.scripts import solve_diag

    a, b = solve_diag.fit_line([1, 2, 4], [3.0, 5.0, 9.0])
    assert (round(a, 12), round(b, 12)) == (1.0, 2.0)
    out = tmp_path / "rows.jsonl"
    rows = solve_diag.run(solve_diag.build_parser().parse_args(
        ["Laplace3D,6", "FemTet3D,4", "--ks", "1", "2", "4", "--backend",
         "cpu", "--out", str(out)]))
    assert [(r["matrix"], r["mode"]) for r in rows] == [
        ("Laplace3D,6", "loop"), ("FemTet3D,4", "loop")]
    for r in rows:
        assert r["platform"] == "cpu" and r["ks"] == [1, 2, 4]
        assert len(r["total_s"]) == 3 and r["impl"].startswith(
            "solve-loop[torch-plain-scs-sp]")
    assert len(out.read_text().splitlines()) == 2
    with pytest.raises(ValueError, match="two values of k"):
        solve_diag.run(solve_diag.build_parser().parse_args(
            ["Laplace3D,6", "--ks", "8", "--backend", "cpu", "--out",
             str(out)]))


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    worker(*sys.argv[2:])
