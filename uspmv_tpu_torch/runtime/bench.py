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

On a GPU a batch is timed with CUDA events recorded on the current stream
around its launches; on the CPU with ``time.perf_counter``. Eager PyTorch
launches every SpMV it is asked for and cannot hoist a loop-invariant one,
so the JAX harness's loop-carried epsilon (its ``_make_runner``, and the
``eps`` of its ``bench_solve``) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from .operator import SpmvOperator

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

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _time_batch(op: SpmvOperator, x: torch.Tensor, n: int,
                call=None) -> float:
    """Seconds for n calls of ``call(x)`` (default: one SpMV), measured on
    the device's own clock."""
    call = call or op.spmv
    if op.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            call(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        call(x)
    return time.perf_counter() - t0


def bench_spmv(
    op: SpmvOperator,
    x: Optional[torch.Tensor] = None,
    bench_time: Optional[float] = None,
    warmup: int = WARM_UP_REPS,
    start_iters: int = 10,
    timing_reps: int = 3,
) -> BenchResult:
    if x is None:
        x = op.make_x()
    bench_time = bench_time if bench_time is not None else op.config.bench_time
    _time_batch(op, x, max(warmup, 1))  # warm-up: build, caches, clocks

    n_iter = max(1, start_iters)
    max_iters = 1 << 17
    t_total0 = time.perf_counter()
    while True:
        elapsed = _time_batch(op, x, n_iter)
        if elapsed >= bench_time or n_iter >= max_iters:
            break
        n_iter *= 2
    samples = [elapsed]
    for _ in range(max(timing_reps, 1) - 1):
        samples.append(_time_batch(op, x, n_iter))
    t_total = time.perf_counter() - t_total0
    return _result(op, n_iter, samples, t_total, op.impl_name())


def bench_solve(
    op: SpmvOperator,
    n_repetitions: int,
    x: Optional[torch.Tensor] = None,
    bench_time: Optional[float] = None,
    warmup: int = 2,
    timing_reps: int = 3,
    impl: Optional[str] = None,
) -> BenchResult:
    """Solve-mode benchmark: time y = A^k x with the x<->y swap, the way
    the reference times its solve loop (main.cpp:528-607). A batch is m
    whole solves of k = n_repetitions iterations through
    ``op.solve(x, k, impl)``; m doubles until a batch takes ``bench_time``
    (or reaches 2^14), and the median of ``timing_reps`` batches counts.
    GFLOP/s = 2 * nnz * bs * k * m / t. ``impl`` picks the loop of
    launches, the CUDA graph or the fused kernel (None: the operator's
    default); the result's ``impl`` reads solve-loop[...], solve-graph[...]
    or solve-fused[...] around ``op.impl_name()``."""
    if x is None:
        x = op.make_x()
    bench_time = bench_time if bench_time is not None else op.config.bench_time
    k = int(n_repetitions)
    name = op.solve_impl_name(k, impl)

    def solve(xv):
        return op.solve(xv, k, name)

    _time_batch(op, x, max(warmup, 1), solve)  # build, capture, caches

    m = 1
    t_total0 = time.perf_counter()
    while True:
        elapsed = _time_batch(op, x, m, solve)
        if elapsed >= bench_time or m >= (1 << 14):
            break
        m *= 2
    samples = [elapsed]
    for _ in range(max(timing_reps, 1) - 1):
        samples.append(_time_batch(op, x, m, solve))
    t_total = time.perf_counter() - t_total0
    return _result(op, k * m, samples, t_total,
                   f"solve-{name}[{op.impl_name()}]")


def _result(op: SpmvOperator, n_iter: int, samples: list, t_total: float,
            impl: str) -> BenchResult:
    """The record of n_iter SpMVs whose final batches took ``samples``."""
    elapsed = float(np.median(samples))
    bs = op.config.block_vec_size
    gflops = 2.0 * op.nnz * bs * n_iter / elapsed / 1e9
    gbps = op.bytes_per_spmv() * n_iter / elapsed / 1e9
    if op.device.type == "cuda":
        device_name = torch.cuda.get_device_name(op.device)
    else:
        device_name = "cpu"
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
    )
