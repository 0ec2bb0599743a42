"""Profiling hooks — the LIKWID marker analogue.

Port of ``uspmv_tpu/runtime/profiling.py``. The reference brackets each
kernel variant in LIKWID marker regions (register_likwid_markers,
utilities.hpp:2686-2770; markers inside kernels e.g. kernels.hpp:41-61) and
measures bandwidth externally with likwid-perfctr. Here:

  * named regions -> ``torch.profiler.record_function`` (a range in a torch
    trace) plus, on a GPU, an NVTX range (``torch.cuda.nvtx``), which an
    Nsight timeline shows;
  * trace capture -> ``torch.profiler.profile`` over the CPU and, on a GPU,
    CUDA activities (CUPTI), exported as a Chrome trace into ``logdir``.
    CUPTI records every kernel the process runs on the card, the port's
    hand-written kernels too, although they are launched through ctypes
    and not through PyTorch's dispatcher;
  * bandwidth accounting -> the byte model of ``runtime/bench.py``.

The region names are the JAX package's. Every hook is a no-op unless
enabled, so production paths carry zero cost.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

_REGISTERED: Dict[str, int] = {}
_last_trace: Optional[str] = None


def register_marker(name: str) -> None:
    """Pre-register a region name (reference register_likwid_markers runs a
    registration pass before the timed loop so first-touch cost is not
    measured)."""
    _REGISTERED.setdefault(name, 0)


def registered_markers() -> tuple:
    return tuple(_REGISTERED)


@contextlib.contextmanager
def marker(name: str, enabled: bool = True) -> Iterator[None]:
    """Named trace region around device work (LIKWID_MARKER_START/STOP
    analogue): a ``record_function`` range, and an NVTX range when a GPU is
    present; also counts entries."""
    if not enabled:
        yield
        return
    register_marker(name)
    _REGISTERED[name] += 1
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, enabled: bool = True) -> Iterator[None]:
    """Capture a trace to ``logdir`` (likwid-perfctr analogue): the CPU
    and, on a GPU, the card's kernels and copies, written as a Chrome trace
    ``uspmv_trace_<pid>_<ns>.json`` (``last_trace_path()``). With
    logdir=None, times the region on the host and prints a one-line summary
    instead."""
    global _last_trace
    if not enabled:
        yield
        return
    if logdir is not None:
        from torch.profiler import ProfilerActivity, profile

        gpu = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU]
        if gpu:
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=activities, acc_events=True) as prof:
            try:
                yield
            finally:
                if gpu:  # the region's kernels end inside the capture
                    torch.cuda.synchronize()
        path = os.path.join(
            logdir, f"uspmv_trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        _last_trace = path
        return
    t0 = time.perf_counter()
    yield
    print(f"[uspmv profiling] region took {time.perf_counter() - t0:.6f}s")


def last_trace_path() -> Optional[str]:
    """The Chrome trace the last ``trace(logdir)`` of this process wrote."""
    return _last_trace


def kernel_marker_name(config) -> str:
    """Region name per kernel variant, mirroring the reference's names
    (e.g. 'spmv_scs_adv_benchmark', utilities.hpp:2686-2770)."""
    fmt = config.kernel_format
    block = "block_" if config.block_vec_size > 1 else ""
    ap = "_ap" if config.is_ap else ""
    return f"{block}spmv_{fmt}{ap}_benchmark"
