"""The device trace of a traced window, reduced to what the metrics read.

``capture`` runs a block under ``torch.profiler`` (CPU and CUDA
activities: CUPTI records every kernel and copy on the card, the program's
ctypes-launched kernels too) inside a host span named ``WINDOW``, and
returns the window's events as plain tuples. ``summarize`` reduces them to
a ``Summary``: the window's length, the union of the device's busy
intervals in it, each device operation's count and seconds, and the idle
gaps by what the host was doing when they opened. The metric readers and
the ``breakdown`` read the summary only, so they are testable on a
synthetic trace.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, List, Tuple

WINDOW = "spmv_cells.window"
TOP = 10  # entries of each breakdown list

# (name, start_s, end_s) on the profiler's clock
Event = Tuple[str, float, float]


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    # device operation name -> [count, seconds], in the window
    ops: Dict[str, list]
    # host activity -> [gaps, idle seconds] of the gaps that opened in it
    gaps: Dict[str, list]

    def device_s(self) -> float:
        """Every device operation's seconds, summed."""
        return sum(s for _, s in self.ops.values())

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Summary":
        return cls(**d)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _host_at(host: List[Event], starts: List[float], t: float) -> str:
    """The innermost host event open at time t: of those that started by
    t and end after it, the one that started last."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 200, -1), -1):
        name, a, b = host[j]
        if b > t and name != WINDOW:
            return name
    return "python (between host calls)"


def summarize(device: List[Event], host: List[Event],
              window: Tuple[float, float]) -> Summary:
    """The summary of the device and host events inside ``window``. A
    host span's shadow on the device's timeline (the profiler's
    "gpu_user_annotation", named as the span) is no device operation."""
    w0, w1 = window
    spans = {n for n, _, _ in host}
    dev = [(n, max(a, w0), min(b, w1)) for n, a, b in device
           if b > w0 and a < w1 and n not in spans]
    ops: Dict[str, list] = {}
    for n, a, b in dev:
        rec = ops.setdefault(n, [0, 0.0])
        rec[0] += 1
        rec[1] += b - a
    busy = _union([(a, b) for _, a, b in dev])
    host = sorted((e for e in host if e[2] > w0 and e[1] < w1),
                  key=lambda e: e[1])
    starts = [e[1] for e in host]
    gaps: Dict[str, list] = {}
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            rec = gaps.setdefault(_host_at(host, starts, a), [0, 0.0])
            rec[0] += 1
            rec[1] += b - a
    return Summary(window_s=w1 - w0, busy_s=sum(b - a for a, b in busy),
                   ops=ops, gaps=gaps)


def breakdown(summary: Summary) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time and the idle time by what the host was doing, at most TOP entries
    each."""
    top = lambda d: [[k[:160], v[1]] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1][1])[:TOP]]
    return {"device_ops": top(summary.ops), "idle_gaps": top(summary.gaps)}


def _events(prof) -> Tuple[List[Event], List[Event]]:
    """(device events, host events) of a finished profile, in seconds."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device: List[Event] = []
    host: List[Event] = []
    raw = [(e.name(), e.start_ns(), e.end_ns(), e.device_type() == cuda)
           for e in prof.profiler.kineto_results.events()
           if not (e.device_type() == cuda and e.is_user_annotation())]
    # to seconds after the first event, in integer ns first: a float of ns
    # since the epoch keeps no better than a quarter of a us
    base = min((r[1] for r in raw), default=0)
    for name, a, b, on_card in raw:
        ev = (name, (a - base) * 1e-9, (b - base) * 1e-9)
        (device if on_card else host).append(ev)
    return device, host


@contextlib.contextmanager
def capture(sync):
    """Profile the block inside the host span WINDOW, ``sync()`` (every
    card of the process drained) at its end inside the span; yields a dict
    that holds the ``Summary`` under "summary" after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: dict = {}
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        sync()
        with torch.profiler.record_function(WINDOW):
            yield out
            sync()
    device, host = _events(prof)
    spans = [e for e in host if e[0] == WINDOW]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    out["summary"] = summarize(device, host, (spans[-1][1], spans[-1][2]))
