"""What the port's probe and benchmark entry points share: the backend flag,
the output file, device timing, the check against a plain version and the
byte bound."""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, Iterable

import torch

from ..config import Config
from ..ops._build import BUILD_DIR
from ..ops.scs_spmv import record_captured_launches
from ..runtime import card
from ..runtime.operator import resolve_device

# the H100's L2 cache in bytes (data sheet)
L2_BYTES = 50 * 2**20


def default_out(name: str) -> Path:
    """Where an entry point appends its JSON rows unless --out says
    otherwise: under the build directory, never the repository root, whose
    *.jsonl are the JAX package's records."""
    return BUILD_DIR / f"{name}.jsonl"


def add_common_args(p: argparse.ArgumentParser, name: str) -> None:
    p.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: the kernels on the current GPU (raises "
                        "DeviceUnavailableError without one); cpu: the plain "
                        "PyTorch versions, timings labelled cpu")
    p.add_argument("--out", default=None,
                   help=f"JSON rows are appended here (default "
                        f"{default_out(name)})")


def device_for(backend: str) -> torch.device:
    """The device of ``--backend``; cuda without a GPU raises."""
    return resolve_device(Config(backend=backend))


def platform_of(device: torch.device) -> str:
    """'cuda:<card name>' or 'cpu': the label every timed row carries."""
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return "cpu"


def device_ms(fn: Callable[[], object], reps: int,
              device: torch.device) -> float:
    """Milliseconds per call of ``fn``. On a GPU: ``reps`` calls captured in
    one CUDA graph and replayed, timed by CUDA events, so no host enqueue
    sits between the kernels (a call that launches nothing through this
    package's wrappers, or allocates, is captured as it is). On the CPU:
    the host clock over ``reps`` calls."""
    reps = max(int(reps), 1)
    fn()  # built, loaded and run once first
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with record_captured_launches():
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    graph.replay()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def check_close(got: torch.Tensor, want: torch.Tensor, tol: float,
                what: str) -> dict:
    """max|got - want| and its ratio to max|want|; raises where ``got`` is
    not finite or the ratio exceeds ``tol``."""
    if not torch.isfinite(got).all().item():
        raise RuntimeError(f"{what}: non-finite result")
    max_abs = (got - want).abs().max().item()
    rel = max_abs / (want.abs().max().item() or 1.0)
    if rel > tol:
        raise RuntimeError(f"{what}: max|d|/max|want| = {rel:.3e} > {tol:g}")
    return dict(max_abs_err=max_abs, rel_err=rel)


def bound_ms(nbytes: float, device: torch.device) -> float:
    """The least time for ``nbytes`` of device memory traffic at the HBM
    rate of ``device`` (runtime/card.py; raises for a card whose rate is
    not on record); these probes do about one operation per 4 B, far under
    the card's peak, so bytes bound them."""
    name = card.device_name(device)
    rate = card.hbm_bytes_per_s(name)
    if rate is None:
        raise RuntimeError(f"no HBM rate on record for {name!r}: add it to "
                           "uspmv_tpu_torch/runtime/card.py")
    return nbytes / rate * 1e3


def write_rows(path, rows: Iterable[dict]) -> Path:
    """Append ``rows`` as JSON lines to ``path``, creating its directory."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return path
