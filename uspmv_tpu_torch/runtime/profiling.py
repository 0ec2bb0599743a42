"""Spans, counters and trace capture: the port's one instrumentation.

Port of ``uspmv_tpu/runtime/profiling.py``. The reference brackets each
kernel variant in LIKWID marker regions (register_likwid_markers,
utilities.hpp:2686-2770; markers inside kernels e.g. kernels.hpp:41-61) and
measures bandwidth externally with likwid-perfctr. Here:

  * ``span(name)``: a named region of host time at a layer boundary,
    dotted by layer (``from_mtx.convert``, ``spmv``, ``dist.send``,
    ``kernels.build``). Spans are off by default (``enable()`` /
    ``disable()``, process-wide); off, a span checks one flag and returns a
    shared null context. On, it adds to an in-memory table keyed by name
    (it grows by name, never by call): entries, total and self seconds
    (total less the time of the spans opened inside it), the kernel
    launches booked inside it, and the name of the span it opened in.
    While a ``torch.profiler`` runs, a span is also a ``record_function``
    range of its name, so it sits on the device trace's clock;
  * counters: ``count(name, n)`` adds to a process-wide table. Every
    kernel wrapper books its launches there as ``LAUNCHES`` (through
    ``ops/scs_spmv.book_launch``), each SELL-C-sigma, packed and pieces
    launch beside it the passes it makes over its matrix stream as
    ``MATRIX_PASSES`` (``vector_pass_count(bs)`` for a SELL or pieces
    launch of bs colwise vectors, else 1: ``SpmvOperator.matrix_passes``),
    each ``SpmvOperator`` build the
    bytes of its device streams as ``UPLOAD_BYTES``, and each SELL-C-sigma
    stream the build of its row index at its first read as
    ``ROW_INDEX_BUILDS`` (ops/device_format.DeviceScs.row_idxs), whether
    spans are on or not; kernel nodes a CUDA graph replays are not launches
    (``runtime/operator.graph_nodes_replayed``);
  * ``snapshot()`` returns both tables as plain JSON-able dicts,
    ``reset()`` empties them;
  * named regions -> ``marker(name)``: a span that also pushes an NVTX
    range on a GPU, which an Nsight timeline shows;
  * trace capture -> ``trace(logdir)``: ``torch.profiler.profile`` over the
    CPU and, on a GPU, CUDA activities (CUPTI), exported as a Chrome trace
    into ``logdir``, spans on inside it. CUPTI records every kernel the
    process runs on the card, the port's hand-written kernels too, although
    they are launched through ctypes and not through PyTorch's dispatcher;
  * bandwidth accounting -> the byte model of ``runtime/bench.py``.

The region names of ``kernel_marker_name`` are the JAX package's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

LAUNCHES = "launches"  # the counter of kernel launches
# the counter of passes that the SpMV kernels' launches made over their
# matrix streams (one per pass of up to 8 block vectors)
MATRIX_PASSES = "matrix_passes"
# the counter of bytes that ``SpmvOperator`` builds placed on the device
# in their matrix streams (their ``device_bytes()``)
UPLOAD_BYTES = "upload_bytes"
# the counter of row indices built on the device at their first read: only
# the plain versions and the probes read one, never a kernel
ROW_INDEX_BUILDS = "row_index_builds"

_on = False
# name -> [entries, total ns, self ns, launches, parent's name or None]
_SPANS: Dict[str, list] = {}
_COUNTERS: Dict[str, int] = {}
_STACK: list = []  # the spans open, innermost last
_last_trace: Optional[str] = None


class _Off:
    """The shared null context of a span while spans are off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    """One entry of a span while spans are on."""

    __slots__ = ("name", "t0", "child_ns", "launches", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        _STACK.append(self)
        self.child_ns = 0
        self.launches = _COUNTERS.get(LAUNCHES, 0)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter_ns() - self.t0
        launches = _COUNTERS.get(LAUNCHES, 0) - self.launches
        _STACK.pop()
        parent = _STACK[-1] if _STACK else None
        if parent is not None:
            parent.child_ns += dt
        row = _SPANS.get(self.name)
        if row is None:
            row = _SPANS[self.name] = [
                0, 0, 0, 0, parent.name if parent is not None else None]
        row[0] += 1
        row[1] += dt
        row[2] += dt - self.child_ns
        row[3] += launches
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that times its block as span ``name`` while spans
    are on (``enable()``); off, one flag check and a shared null
    context."""
    if not _on:
        return _OFF
    return _Span(name)


def _off_span(name: str) -> _Off:
    return _OFF


def spans():
    """The span function for a call with several spans: ``span`` while
    spans are on, else one that returns the null context without looking
    at the flag again. Checks the flag once."""
    return span if _on else _off_span


def enable() -> None:
    """Spans on, process-wide."""
    global _on
    _on = True


def disable() -> None:
    """Spans off (the default): each costs one flag check."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name``."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def snapshot() -> dict:
    """The span table and the counters as plain dicts: {"spans": {name:
    {"count", "total_s", "self_s", "launches", "parent"}}, "counters":
    {name: n}}. A span entered under several parents names the first."""
    return {
        "spans": {name: {"count": c, "total_s": t * 1e-9,
                         "self_s": s * 1e-9, "launches": n, "parent": p}
                  for name, (c, t, s, n, p) in _SPANS.items()},
        "counters": dict(_COUNTERS),
    }


def reset() -> None:
    """Empty the span table and the counters."""
    _SPANS.clear()
    _COUNTERS.clear()


@contextlib.contextmanager
def marker(name: str, enabled: bool = True) -> Iterator[None]:
    """Named trace region around device work (LIKWID_MARKER_START/STOP
    analogue): span ``name``, whose entries the span table counts, and an
    NVTX range when a GPU is present."""
    if not enabled:
        yield
        return
    nvtx = torch.cuda.is_available()
    with span(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True) -> Iterator[None]:
    """Capture a trace to ``logdir`` (likwid-perfctr analogue): the CPU
    and, on a GPU, the card's kernels and copies, with the program's spans
    (on inside the block), written as a Chrome trace
    ``uspmv_trace_<pid>_<ns>.json`` (``last_trace_path()``)."""
    global _last_trace
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    gpu = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if gpu:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was_on = _on
    with profile(activities=activities, acc_events=True) as prof:
        enable()
        try:
            yield
        finally:
            if not was_on:
                disable()
            if gpu:  # the region's kernels end inside the capture
                torch.cuda.synchronize()
    path = os.path.join(
        logdir, f"uspmv_trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _last_trace = path


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
