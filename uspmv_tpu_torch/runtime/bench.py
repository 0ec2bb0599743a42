"""Benchmark harness.

Port of ``bench_spmv`` and ``bench_solve`` from
``uspmv_tpu/runtime/bench.py``, which follows the reference's methodology (bench_spmv, main.cpp:50-798):

  * warm-up repetitions (reference WARM_UP_REPS = 100, main.cpp:22);
  * a doubling timed loop — run n_iter iterations, double n_iter until the
    elapsed time reaches ``bench_time`` (main.cpp:449-519), then re-run the
    final batch and take the median of ``timing_reps`` batches;
  * perf_gflops = nnz * 2 * block_vec_size * n_iter / t / 1e9 — useful
    flops only, padding excluded (main.cpp:521-526);
  * effective GB/s from the operator's byte count (values + col_idxs +
    chunk metadata + x + y, main.cpp:655-668).

The JAX harness runs a batch of n SpMVs as one jitted ``lax.fori_loop``,
one dispatch per batch. Here, on a CUDA device, a batch is n / G replays
of one CUDA graph of G = ``start_iters`` captured SpMVs
(``OperatorBase.batch_graph``), so n = G * 2^j as in the JAX harness and
no host enqueue sits between two SpMVs; every SpMV of the graph reads the
same x, as the JAX runner's ``x + y_prev[0] * 0`` does. The warm-up is the
capture and replays of at least ``warmup`` SpMVs. On the CPU, and for an
operator spread over processes whose transfer crosses the host (gloo), a
batch is a Python loop of n ``op.spmv`` calls: there is no graph to
replay. ``timing_for`` decides, from the device and the transport alone,
and ``BenchResult.timing`` records it ("graph" or "loop"). A capture that
fails raises. A batch is timed with CUDA events recorded on the current
stream around it on a GPU, with ``time.perf_counter`` on the CPU. Nothing
in a graph is loop-invariant to a compiler, so the JAX harness's epsilon
has no counterpart.

Both take an ``SpmvOperator`` or a sharded ``DistributedSpmvOperator``
(parallel/distributed.py); for the latter the result also carries the halo
elements received per SpMV, in all, per shard and per process. An operator
spread over processes runs a collective in every SpMV, so every process
must run the same number of batches of the same size: each batch's time is
the largest of all processes' (an all-reduce), and the doubling reads that.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..parallel import multihost
from .operator import OperatorBase, join_cards

WARM_UP_REPS = 100  # reference main.cpp:22


@dataclasses.dataclass
class BenchResult:
    """Mirrors the reference Result struct (classes_structs.hpp:1812-1888)."""

    perf_gflops: float
    effective_gbps: float
    duration_total_s: float
    duration_kernel_s: float
    n_iterations: int
    nnz: int
    block_vec_size: int
    value_type: str
    kernel_format: str
    C: int
    sigma: int
    beta: Dict[str, float]
    device_beta: Dict[str, float]
    nnz_per_precision: Dict[str, int]
    n_dropped: int  # elements the AP -dropout removed
    memory_footprint_bytes: int
    n_rows: int
    platform: str  # 'cuda' | 'cpu'
    device_name: str  # torch.cuda.get_device_name, or 'cpu'
    impl: str = ""  # kernel implementation (tier) actually selected
    # heavy-row split: the threshold in effect (0: none), the virtual rows
    # ("pieces") it cut off and the nonzeros they hold
    split_rows_threshold: int = 0
    n_pieces: int = 0
    nnz_in_pieces: int = 0
    # final-batch timing samples (median is duration_kernel_s)
    timing_samples_s: Optional[list] = None
    # sharded operators: halo elements received per SpMV (all precisions),
    # per shard {shard, nnz, gflops, halo_elems_recv}, and per host
    comm_volume_elems: int = 0
    per_shard: Optional[list] = None
    comm_volume_per_host: Optional[dict] = None
    n_processes: int = 1  # processes of the run (parallel/multihost.py)
    # how a batch was timed: "graph" (replays of a captured CUDA graph) or
    # "loop" (a Python loop of calls); timing_for decides
    timing: str = "loop"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def timing_for(device_type: str, transport: Optional[str] = None) -> str:
    """How ``bench_spmv`` times a batch on a device of ``device_type``
    ("cuda" or "cpu") for an operator whose transfer runs over
    ``transport`` (parallel/multihost.py; None for an operator in one
    process): "graph", replays of a captured CUDA graph, on a card where
    the whole SpMV can be captured; else "loop"."""
    if device_type == "cuda" and multihost.graph_capturable(transport):
        return "graph"
    return "loop"


def timing_of(op: OperatorBase) -> str:
    """``timing_for`` of the operator's device and transport; "loop" where
    the operator says a whole SpMV cannot sit in one CUDA graph
    (``op.graph_capturable()``: the plain versions over several cards)."""
    if not op.graph_capturable():
        return "loop"
    return timing_for(op.device.type, op.transport())


def _seconds(op: OperatorBase, run) -> float:
    """Seconds of ``run()`` measured on the device's own clock; for an
    operator spread over processes, the largest of all processes' seconds
    (the all-reduce outside the timed window)."""
    if op.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        devices = op.devices()
        with torch.cuda.device(devices[0]):
            start.record()
            run()
            join_cards(devices)  # a loop over several cards ends on all
            end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        run()
        seconds = time.perf_counter() - t0
    if getattr(op, "n_processes", 1) > 1:
        seconds = multihost.agree_max(seconds)
    return seconds


def _doubling(op: OperatorBase, run, n0: int, limit: int,
              bench_time: float, timing_reps: int) -> tuple:
    """The reference's timed loop: ``run(n)`` batches from n0, doubling n
    until a batch takes ``bench_time`` or n reaches ``limit``, then
    ``timing_reps`` batches of that n in all. Returns (n, samples, total
    seconds)."""
    n = n0
    t_total0 = time.perf_counter()
    while True:
        elapsed = _seconds(op, lambda: run(n))
        if elapsed >= bench_time or n >= limit:
            break
        n *= 2
    samples = [elapsed]
    for _ in range(max(timing_reps, 1) - 1):
        samples.append(_seconds(op, lambda: run(n)))
    return n, samples, time.perf_counter() - t_total0


def bench_spmv(
    op: OperatorBase,
    x: Optional[torch.Tensor] = None,
    bench_time: Optional[float] = None,
    warmup: int = WARM_UP_REPS,
    start_iters: int = 10,
    timing_reps: int = 3,
) -> BenchResult:
    if x is None:
        x = op.make_x()
    bench_time = bench_time if bench_time is not None else op.config.bench_time
    timing = timing_of(op)
    G = max(1, start_iters)
    if timing == "graph":
        g = op.batch_graph(x, G)  # capture: build, caches

        def run(n):
            op.replay(g, -(-n // G))
    else:
        def run(n):
            for _ in range(n):
                op.spmv(x)

    _seconds(op, lambda: run(max(warmup, 1)))  # warm-up: caches, clocks
    n_iter, samples, t_total = _doubling(op, run, G, 1 << 17, bench_time,
                                         timing_reps)
    return _result(op, n_iter, samples, t_total, op.impl_name(), timing)


def bench_solve(
    op: OperatorBase,
    n_repetitions: int,
    x: Optional[torch.Tensor] = None,
    bench_time: Optional[float] = None,
    warmup: int = 2,
    timing_reps: int = 3,
    impl: Optional[str] = None,
) -> BenchResult:
    """Solve-mode benchmark: time y = A^k x with the x<->y swap, the way
    the reference times its solve loop (main.cpp:528-607). A batch is m
    whole solves of k = n_repetitions iterations; m doubles until a batch
    takes ``bench_time`` (or reaches 2^14), and the median of
    ``timing_reps`` batches counts. GFLOP/s = 2 * nnz * bs * k * m / t.
    ``impl`` picks the loop of launches, the CUDA graph or the fused
    kernel (None: the operator's default); the result's ``impl`` reads
    solve-loop[...], solve-graph[...] or solve-fused[...] around
    ``op.impl_name()``. By graph a batch is m back-to-back replays of the
    captured solve, x copied in once before them (the JAX harness chains
    its m solves inside one jit); by loop and fused, m calls of
    ``op.solve(x, k, impl)``."""
    if x is None:
        x = op.make_x()
    bench_time = bench_time if bench_time is not None else op.config.bench_time
    k = int(n_repetitions)
    name = op.solve_impl_name(k, impl)
    timing = "graph" if name == "graph" and k >= 1 else "loop"
    if timing == "graph":
        g = op.solve_graph(x, k)  # capture: build, caches; x copied in

        def run(m):
            op.replay(g, m)
    else:
        def run(m):
            for _ in range(m):
                op.solve(x, k, name)

    _seconds(op, lambda: run(max(warmup, 1)))
    m, samples, t_total = _doubling(op, run, 1, 1 << 14, bench_time,
                                    timing_reps)
    return _result(op, k * m, samples, t_total,
                   f"solve-{name}[{op.impl_name()}]", timing)


def _result(op: OperatorBase, n_iter: int, samples: list, t_total: float,
            impl: str, timing: str) -> BenchResult:
    """The record of n_iter SpMVs whose final batches took ``samples``."""
    elapsed = float(np.median(samples))
    bs = op.config.block_vec_size
    gflops = 2.0 * op.nnz * bs * n_iter / elapsed / 1e9
    gbps = op.bytes_per_spmv() * n_iter / elapsed / 1e9
    if op.device.type == "cuda":
        device_name = torch.cuda.get_device_name(op.device)
    else:
        device_name = "cpu"
    comm_elems, per_shard, per_host = 0, None, None
    if hasattr(op, "comm_volume_per_spmv"):
        comm = op.comm_volume_per_spmv()
        comm_elems = sum(v["real"] for v in comm.values())
        halo = np.sum([v["per_shard"] for v in comm.values()], axis=0)
        spread = int(op.card[-1]) + 1 > op.n_processes
        per_shard = [
            {"shard": r, "nnz": int(nz),
             "gflops": 2.0 * nz * bs * n_iter / elapsed / 1e9,
             "halo_elems_recv": int(halo[r]),
             # the card group that holds it, where a process holds several
             **({"card": int(op.card[r])} if spread else {})}
            for r, nz in enumerate(op.per_shard_nnz())]
        per_host = op.comm_volume_per_host()
    return BenchResult(
        perf_gflops=gflops,
        effective_gbps=gbps,
        duration_total_s=t_total,
        duration_kernel_s=elapsed,
        n_iterations=n_iter,
        nnz=op.nnz,
        block_vec_size=bs,
        value_type=op.config.value_type,
        kernel_format=op.config.kernel_format,
        C=op.config.chunk_size,
        sigma=op.config.sigma,
        beta=op.beta(),
        device_beta=op.device_beta(),
        nnz_per_precision=op.nnz_per_precision(),
        n_dropped=op.n_dropped,
        memory_footprint_bytes=op.bytes_per_spmv(),
        n_rows=op.n_rows,
        platform=op.device.type,
        device_name=device_name,
        impl=impl,
        split_rows_threshold=op.split_threshold,
        n_pieces=op.n_pieces(),
        nnz_in_pieces=op.nnz_in_pieces(),
        timing_samples_s=[float(s) for s in samples],
        comm_volume_elems=comm_elems,
        per_shard=per_shard,
        comm_volume_per_host=per_host,
        n_processes=multihost.process_count(),
        timing=timing,
    )
