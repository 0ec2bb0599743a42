#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port (uspmv_tpu_torch) on one
NVIDIA GPU: the port's counterpart of ``bench.py``, case for case.

    python3 bench_torch.py [--backend cuda|cpu]

Prints ONE JSON line last, {"metric": ..., "value": N, "unit": "GFLOP/s",
"vs_baseline": N, ...}, and appends it with ``_source`` and ``_utc`` to
``spmv_bench_torch.jsonl`` in ``USPMV_OUTPUT_DIR`` (default: the directory
of this file). Progress lines, each with its seconds since the watchdog was
armed, go to standard error.

Benchmark: SELL-C-sigma SpMV (C=1024, sigma=1, sp) on a generated 3-D
Laplacian, Laplace3D-128^3 (2,097,152 rows, 14,581,760 nnz), through
``SpmvOperator.from_mtx`` and ``runtime/bench.bench_spmv``; on the card a
timed batch is replays of a captured CUDA graph (``timing`` "graph").

Metric: SpMV GFLOP/s, 2 nnz / t (the reference's headline,
main.cpp:521-526). ``vs_baseline`` divides it by the GFLOP/s of an ideal
memory-bound CSR SpMV at 80% of the card's HBM roofline, 8 bytes per
nonzero (f32 value, int32 column) plus x and y once (bench.py's
definition). The rate comes from ``runtime/card.py`` by the card's name; a
card the table does not know gets ``vs_baseline`` and ``roofline_gbps``
null, never a guessed rate. ``card`` is nvidia-smi's name and power limit.

Extras, bench.py's matrices and settings: FemTet3D-55, BandedImbalanced-,
PowerLawCols- and RandomImbalanced-500k (sp, 1.5 s each); a solve of
k=512 on bcsstk13 (``bcsstk13.mtx`` in the directory that
``USPMV_REFERENCE_MATRICES`` names, else its generated stand-in
FemTet3D-9, timed as it is: its iterates overflow in sp, and nothing on
the path checks them); ap[sp_hp] on the headline matrix and ap[dp_sp]
-dp_emu on Laplace3D-96.

Exit codes (bench.py exits 0 on every error; this program does not):
  0  every number measured, or skipped for the budget;
  1  the headline failed (its error record is printed), an extra failed
     (its key reads "error: ..."), or the watchdog fired: no number landed
     for ``USPMV_BENCH_PHASE_DEADLINE_S`` seconds (default 600), and the
     partial record is printed;
  3  no CUDA device and no ``--backend cpu``: the record reads
     "cuda-unavailable", as the port's CLI exits 3.
Extras left once ``USPMV_BENCH_BUDGET_S`` seconds (default 1500) have
passed after the headline read "skipped (bench budget)".

It imports torch and uspmv_tpu_torch only; the top level is pure
definitions, so tests load it with importlib.
"""

import argparse
import dataclasses
import functools
import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional, Sequence

SOURCE = "bench_torch.py"
RECORD_FILE = "spmv_bench_torch.jsonl"
# every case: SELL-C-sigma at the C=1024, sigma=1 of bench.py's headline
SCS = dict(kernel_format="scs", chunk_size=1024, sigma=1)
METRIC = "scs_spmv_gflops (C=1024, sp, Laplace3D-128^3"


def _emit(record: dict) -> None:
    """Print the ONE JSON line and append it to ``RECORD_FILE``, so every
    number has a durable machine record (as bench.py does with
    spmv_bench.jsonl, the JAX package's TPU record)."""
    print(json.dumps(record), flush=True)
    rec = dict(record)
    rec["_source"] = SOURCE
    rec["_utc"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    out_dir = os.environ.get("USPMV_OUTPUT_DIR",
                             os.path.dirname(os.path.abspath(__file__)))
    try:
        with open(os.path.join(out_dir, RECORD_FILE), "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError as e:  # a read-only checkout keeps the stdout record
        print(f"[bench_torch] {RECORD_FILE} not written: {e}",
              file=sys.stderr)


class Watchdog:
    """Progress-based guard for a run that hangs mid-way (a kernel that
    never ends inside a graph replay, a wedged card).

    The timer re-arms on every :meth:`progress` call (each landed number),
    so a healthy but slow run never fires, while a hang fires within one
    phase deadline of the last progress. The timer thread cannot un-hang
    the main thread, which may be blocked in a CUDA synchronize, but it
    can print what was measured before the hang (callers update
    ``partial`` in place) and ``os._exit(1)``, so the record is parseable
    and the exit says the run failed."""

    def __init__(self, phase_deadline_s: float, partial: dict, emit,
                 _exit=None):
        self._deadline = phase_deadline_s
        self._partial = partial
        self._emit = emit
        self._exit = os._exit if _exit is None else _exit
        self._timer = None
        self.progress()

    def _fire(self) -> None:
        rec = dict(self._partial)
        rec.setdefault("value", None)
        rec.setdefault("unit", "GFLOP/s")
        rec.setdefault("vs_baseline", None)
        rec["error"] = (
            f"cuda-hung-mid-run: no progress for {self._deadline:g}s "
            "(partial metrics reported)"
        )
        self._emit(rec)
        sys.stdout.flush()
        self._exit(1)

    def progress(self) -> None:
        """A number landed: re-arm the phase timer."""
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(self._deadline, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def cancel(self) -> None:
        if self._timer is not None:
            self._timer.cancel()


@dataclasses.dataclass(frozen=True)
class Case:
    """One timed run of the record. ``key`` names its field
    (``<key>_gflops``; the first case of a run is the headline and fills
    ``value``), ``matrix`` makes the matrix (None: the headline's),
    ``fields`` are its Config fields beyond SCS, and ``solve_k`` > 0 times
    a solve of that many repetitions."""

    key: str
    matrix: Optional[Callable]
    fields: dict = dataclasses.field(default_factory=dict)
    bench_time: float = 1.5
    solve_k: int = 0


def _generated(name: str, *args, **kwargs):
    from uspmv_tpu_torch.io import generators

    return getattr(generators, name)(*args, **kwargs)


def bcsstk13():
    """The reference's bundled bcsstk13 where USPMV_REFERENCE_MATRICES
    names a directory that holds it, else a generated stand-in of the same
    scale (FemTet3D-9: 2,187 rows), as bench.py chooses."""
    ref = os.environ.get("USPMV_REFERENCE_MATRICES")
    if ref and os.path.exists(os.path.join(ref, "bcsstk13.mtx")):
        from uspmv_tpu_torch.io.mmio import read_mtx

        return read_mtx(os.path.join(ref, "bcsstk13.mtx"))
    return _generated("fem_tet3d", 9)


_AP = dict(ap_threshold_1=2.44)  # sqrt(1 * 6): Laplace3D's diagonal -> hi
CASES = (
    Case("headline", functools.partial(_generated, "laplace3d", 128),
         bench_time=3.0),
    Case("fem_tet3d_55", functools.partial(_generated, "fem_tet3d", 55)),
    Case("banded_imbalanced_500k",
         functools.partial(_generated, "banded_imbalanced", 500_000,
                           bandwidth=64, avg_nnz_per_row=8, seed=7)),
    Case("powerlaw_cols_500k",
         functools.partial(_generated, "powerlaw_cols", 500_000, 8)),
    Case("random_imbalanced_500k",
         functools.partial(_generated, "random_imbalanced", 500_000, 8)),
    Case("solve_bcsstk13", bcsstk13, solve_k=512),
    Case("ap_sp_hp", None, dict(value_type="ap[sp_hp]", **_AP)),
    Case("ap_dp_sp_96", functools.partial(_generated, "laplace3d", 96),
         dict(value_type="ap[dp_sp]", dp_emulation=True, **_AP)),
)


def baseline_gflops(nnz: int, n_rows: int, hbm_bytes_per_s: float) -> float:
    """GFLOP/s of an ideal CSR SpMV at 80% of the HBM roofline: 8 B per
    nonzero (f32 value, int32 column), x and y once in f32
    (bench.py:178-182)."""
    t = (8.0 * nnz + 2 * 4.0 * n_rows) / (0.8 * hbm_bytes_per_s)
    return 2.0 * nnz / t / 1e9


def measure(case: Case, mtx, backend: str, log=lambda what: None):
    """``case`` on ``mtx``: its operator through ``SpmvOperator.from_mtx``,
    timed by ``bench_spmv`` (or ``bench_solve``); the operator and its
    graphs go when this returns. ``log`` hears when the operator is
    built."""
    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.runtime.bench import bench_solve, bench_spmv

    cfg = Config(**SCS, **{"value_type": "sp", **case.fields},
                 bench_time=case.bench_time, backend=backend)
    op = SpmvOperator.from_mtx(cfg, mtx)
    log(f"{case.key}: {op.impl_name()} built")
    if case.solve_k:
        return bench_solve(op, case.solve_k)
    return bench_spmv(op, warmup=20, start_iters=64)


def _release(backend: str) -> None:
    if backend == "cuda":
        import torch

        torch.cuda.empty_cache()


def run(cases: Sequence[Case] = CASES, backend: str = "cuda",
        emit=_emit) -> int:
    """Measure ``cases`` (the first is the headline) on ``backend`` and
    emit the record; returns the exit code (see the module's docstring)."""
    from uspmv_tpu_torch import Config
    from uspmv_tpu_torch.runtime import card
    from uspmv_tpu_torch.runtime.operator import (
        DeviceUnavailableError,
        resolve_device,
    )

    head, extras = cases[0], cases[1:]
    partial = {
        "metric": METRIC + ")",
        "value": None,
        "unit": "GFLOP/s",
        "vs_baseline": None,
    }
    try:
        device = resolve_device(Config(backend=backend))
    except DeviceUnavailableError as e:
        emit({**partial, "error": "cuda-unavailable",
              "detail": str(e)[:300]})
        return 3

    t_armed = time.monotonic()

    def log(what: str) -> None:
        print(f"[bench_torch] t={time.monotonic() - t_armed:.3f} s {what}",
              file=sys.stderr, flush=True)

    watchdog = Watchdog(
        float(os.environ.get("USPMV_BENCH_PHASE_DEADLINE_S", 600)),
        partial, emit)
    try:
        try:
            kind = card.device_name(device)
            rate = card.hbm_bytes_per_s(kind)
            partial.update(
                metric=f"{METRIC}, {kind})",
                card=(card.card_name_and_power_limit()
                      if device.type == "cuda" else "cpu"),
                roofline_gbps=None if rate is None else rate / 1e9)
            mtx = head.matrix()
            res = measure(head, mtx, backend, log)
        except Exception as e:
            traceback.print_exc()
            emit({**partial, "error": "headline-bench-failed",
                  "detail": f"{type(e).__name__}: {str(e)[:300]}"})
            return 1
        _release(backend)
        # the headline is in: from here a hang still reports it
        partial.update(
            value=res.perf_gflops,
            vs_baseline=(None if rate is None else res.perf_gflops
                         / baseline_gflops(res.nnz, res.n_rows, rate)),
            effective_gbps=res.effective_gbps,
            n_iterations=res.n_iterations,
            platform=res.platform,
            timing=res.timing,
        )
        log(f"{head.key}: {res.perf_gflops} GFLOP/s landed")
        watchdog.progress()

        t0 = time.monotonic()
        budget_s = float(os.environ.get("USPMV_BENCH_BUDGET_S", 1500))
        failed = False
        for case in extras:
            key = case.key + "_gflops"
            if time.monotonic() - t0 > budget_s:
                partial[key] = "skipped (bench budget)"
                continue
            try:
                r = measure(case, mtx if case.matrix is None
                            else case.matrix(), backend, log)
                partial[key] = r.perf_gflops
                if case.solve_k:
                    partial[case.key + "_impl"] = r.impl
            except Exception as e:
                traceback.print_exc()
                partial[key] = f"error: {str(e)[:120]}"
                failed = True
            _release(backend)
            log(f"{case.key}: {partial[key]} landed")
            watchdog.progress()
    finally:
        watchdog.cancel()
    emit(dict(partial))
    return 1 if failed else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="The port's headline benchmark (bench.py's cases on "
                    "the card); prints one JSON record last.")
    p.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: the kernels on the current GPU (exit 3 "
                        "without one); cpu: the plain PyTorch versions")
    args = p.parse_args(argv)
    return run(CASES, args.backend)


if __name__ == "__main__":
    sys.exit(main())
