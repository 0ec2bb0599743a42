"""The program under test driven through one cell: set-up, the window, the
trace, the check against the reference, and the result line.

A cell's traffic file says what runs (see cells/*.json):

  operation        "spmv": ``spmv(x, out=y)`` back to back on one x, as a
                   solver's inner loop issues it
  value_type, block_vec_size, vector_layout    the program's Config fields
  x                x ~ uniform(low, high) from the seed
  limits           the numbers ``correct`` compares, each with its limit

``work`` generates the matrix with the cell's generator, builds the
program's operator, makes x from the seed, warms up, runs the window (or,
traced, a shorter traced window, then a device copy that reads the card's
sustained bandwidth), reads its counters and its memory peak, brings y to
the host in the original row order, frees the program, and compares y
with the plain reference.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Optional

import numpy as np

from . import reference, spec, tracing

# top-level module names the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "uspmv_tpu")
WARM_CALLS = 20  # SpMVs before the rate is read (kernels load, x is read)
RATE_CALLS = 50  # SpMVs timed to size the window
TRACE_S = 2.0  # the traced window's length at the most
HOST_BURSTS, BURST_CALLS = 8, 128  # host_us_per_spmv, below the launch queue
COPY_BYTES, COPY_REPS = 1 << 30, 20  # the traced device copy


def forbidden_modules() -> list:
    """The names of FORBIDDEN that ``sys.modules`` holds, compared by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def x_host(cell: dict, n: int, seed: int, value_type: str) -> np.ndarray:
    """x from the seed, in the vectors' type of ``value_type`` (f64 for dp,
    f32 otherwise): [n] or [n, bs]."""
    bs = cell["block_vec_size"]
    lo, hi = cell["x"]["low"], cell["x"]["high"]
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, size=(n,) if bs == 1 else (n, bs))
    return x.astype(np.float64 if value_type == "dp" else np.float32)


class Program:
    """The cell in the program: its operator over the benchmark's matrix,
    x and y."""

    def __init__(self, cell: dict, arrays: tuple, value_type: str,
                 backend: str):
        import torch

        import uspmv_tpu_torch as port

        self.torch = torch
        self.cell = cell
        conf = port.Config(
            backend=backend, value_type=value_type,
            block_vec_size=cell["block_vec_size"],
            vector_layout=cell["vector_layout"],
            **cell["config"]["program"])
        n_rows, n_cols, I, J, V = arrays
        # the program gets its own copies: the reference reads the arrays
        mtx = port.MtxData(n_rows=n_rows, n_cols=n_cols, nnz=int(V.size),
                           is_sorted=True, is_symmetric=False, I=I.copy(),
                           J=J.copy(), values=V.copy())
        t0 = time.perf_counter()
        self.op = port.SpmvOperator.from_mtx(conf, mtx)
        del mtx
        self.sync()
        self.build_s = time.perf_counter() - t0
        self.x = self.y = None

    def on_card(self) -> bool:
        return any(d.type == "cuda" for d in self.op.devices())

    def sync(self) -> None:
        if self.on_card():
            self.torch.cuda.synchronize()

    def set_x(self, x: np.ndarray) -> None:
        self.x = self.op.make_x(x)
        self.y = self.torch.zeros_like(self.x)

    def spmv(self, n: int) -> None:
        op, x, y = self.op, self.x, self.y
        for _ in range(n):
            op.spmv(x, out=y)

    def counters(self) -> dict:
        """The program's own counters: nonzeros and device fill per
        precision."""
        return {"nnz_per_precision": self.op.nnz_per_precision(),
                "device_beta": self.op.device_beta()}

    def memory_peak_bytes(self) -> Optional[int]:
        return (self.torch.cuda.max_memory_allocated() if self.on_card()
                else None)

    def device_name(self) -> str:
        return (self.torch.cuda.get_device_name() if self.on_card()
                else "cpu")

    def y_host(self) -> np.ndarray:
        """y in the original row order ([n] or [n, bs])."""
        return np.asarray(self.op.to_host(self.y))

    def free(self) -> None:
        self.op = self.x = self.y = None
        gc.collect()
        if self.torch.cuda.is_available():
            self.torch.cuda.empty_cache()


def spmv_rate(prog: Program) -> float:
    """Seconds per SpMV over RATE_CALLS calls."""
    prog.sync()
    t0 = time.perf_counter()
    prog.spmv(RATE_CALLS)
    prog.sync()
    return (time.perf_counter() - t0) / RATE_CALLS


def spmv_window(prog: Program, n: int) -> dict:
    wall = time.time()
    t0 = time.perf_counter()
    prog.spmv(n)
    prog.sync()
    return {"calls": n, "seconds": time.perf_counter() - t0,
            "start_wall": wall}


def host_burst(prog: Program) -> dict:
    """Host seconds inside ``spmv`` calls, in bursts short enough that the
    launch queue never fills (a full queue would make the host wait for the
    card and read the kernel's time)."""
    total = 0.0
    for _ in range(HOST_BURSTS):
        prog.sync()
        t0 = time.perf_counter()
        prog.spmv(BURST_CALLS)
        total += time.perf_counter() - t0
    prog.sync()
    return {"calls": HOST_BURSTS * BURST_CALLS, "seconds": total}


def copy_probe(prog: Program) -> Optional[dict]:
    """The card's sustained bandwidth, beside the data sheet's: COPY_REPS
    device-to-device copies of COPY_BYTES, traced; each reads and writes
    its bytes. None off the card."""
    torch = prog.torch
    if not prog.on_card():
        return None
    a = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    b = torch.empty_like(a)
    b.copy_(a)
    with tracing.capture(prog.sync) as tr:
        for _ in range(COPY_REPS):
            b.copy_(a)
    del a, b
    torch.cuda.empty_cache()
    return {"bytes": 2 * COPY_BYTES * COPY_REPS,
            "summary": tr["summary"].to_json()}


def run_one(prog: Program, run: dict) -> dict:
    """Warm-up and the (traced) window of one run on the program's x."""
    cell, seconds = prog.cell, float(run["seconds"])
    if cell["operation"] != "spmv":
        raise ValueError(f"unknown operation {cell['operation']!r}")
    out: dict = {}
    t0 = time.perf_counter()
    prog.spmv(WARM_CALLS)
    t_call = spmv_rate(prog)
    out["warm_s"] = time.perf_counter() - t0
    if run["trace"]:
        out["host_burst"] = host_burst(prog)
        n = max(1, math.ceil(min(seconds, TRACE_S) / t_call))
        with tracing.capture(prog.sync) as tr:
            prog.spmv(n)
        out["traced"] = {"calls": n, "summary": tr["summary"].to_json()}
    else:
        out["window"] = spmv_window(prog, max(1, math.ceil(seconds / t_call)))
    return out


def work(job: dict) -> dict:
    """Every run of ``job["runs"]`` (seed, seconds, trace) on one build of
    the program. Returns the record; each run carries "checks" (the
    numbers ``correct`` compares)."""
    cell, backend = job["cell"], job["backend"]
    value_type = job.get("value_type") or cell["value_type"]
    t_start = job["t_start"]
    rec: dict = {"setup": {"start_s": time.time() - t_start}}
    t = time.perf_counter()
    import torch  # noqa: F401

    import uspmv_tpu_torch  # noqa: F401

    rec["setup"]["imports_s"] = time.perf_counter() - t
    t = time.perf_counter()
    conf = cell["config"]
    arrays = spec.generator(conf["generator"]).generate(conf["params"])
    rec["setup"]["generate_s"] = time.perf_counter() - t
    rec["matrix"] = {"n_rows": int(arrays[0]), "n_cols": int(arrays[1]),
                     "nnz": int(arrays[4].size)}
    prog = Program(cell, arrays, value_type, backend)
    rec["setup"]["build_s"] = rec["build_s"] = prog.build_s
    rec["counters"] = prog.counters()
    rec["device_name"] = prog.device_name()
    rec["n_cards"] = 1 if prog.on_card() else 0
    rec["runs"] = []
    kept = []
    for i, run in enumerate(job["runs"]):
        t = time.perf_counter()
        x = x_host(cell, arrays[1], int(run["seed"]), value_type)
        prog.set_x(x)
        r = {"seed": run["seed"], "x_s": time.perf_counter() - t}
        r.update(run_one(prog, run))
        if i == 0:
            rec["setup"]["x_s"] = r["x_s"]
            rec["setup"]["warm_s"] = r["warm_s"]
            rec["setup_s"] = (r.get("window", {}).get("start_wall",
                                                      time.time())
                              - t_start)
        r["memory_peak_bytes"] = prog.memory_peak_bytes()
        kept.append((x, prog.y_host()))
        if run["trace"]:
            r["copy"] = copy_probe(prog)
        rec["runs"].append(r)
    rec["memory_peak_bytes"] = max(
        [r["memory_peak_bytes"] or 0 for r in rec["runs"]])
    prog.free()
    del prog
    A = reference.csr(*arrays)
    del arrays
    for r, (x, y) in zip(rec["runs"], kept):
        t = time.perf_counter()
        r["checks"] = {"max_err": reference.max_err(
            y, reference.spmv(A, x))}
        r["reference_s"] = time.perf_counter() - t
    return rec


def run_record(cell: dict, runs: list, backend: str, t_start: float,
               value_type: Optional[str] = None) -> dict:
    """The record of ``runs`` of the cell on one build of the program."""
    return work(dict(cell=cell, runs=runs, backend=backend,
                     t_start=t_start, value_type=value_type))
