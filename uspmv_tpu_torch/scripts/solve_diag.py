"""Launch cost against per-iteration cost of the three solve modes.

Port of the JAX package's scripts/solve_diag.py. A solve runs k chained
SpMVs (y = A x; x <- y; reference solve loop, main.cpp:528-607) in one of
three ways (``SpmvOperator.solve``):

  loop   a Python loop of k launches
  graph  the k launches captured once into a CUDA graph and replayed
  fused  one launch of the fused solve kernel (ops/scs_solve.py), where
         the operator is eligible

For each mode the script times one sp solve at several k (the median of
five solves after two warm-ups; CUDA events on the card, the host
clock on the CPU) and fits t(k) = a + b*k: a is the fixed cost of a solve
(launch, capture replay, host), b the cost of one iteration. The JAX
script's third mode, its bench harness's loop, has no counterpart: the
port's bench loop is the loop mode.

The operator is SELL-C-sigma at C=1024, sigma=1 with the packed tier and
the row split off, so that one stream carries every row and the fused
kernel can take it. The values are scaled so that every row sum of |A| is
at most 1: the iterates stay finite at any k (the time does not depend on
them).

    python -m uspmv_tpu_torch.scripts.solve_diag [MATRIX ...]
        [--ks K ...] [--backend cuda|cpu] [--out PATH]

One row per (matrix, mode) ({"metric": "solve_diag_<matrix>_<mode>",
"launch_us", "per_iter_us", "gflops_asymptotic", "ks", "total_s", "impl",
"platform", ...}) is appended to --out, by default
build/uspmv_tpu_torch/solve_diag.jsonl.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..cli import load_matrix
from ..config import Config
from ..runtime.operator import SpmvOperator
from . import _common

NAME = "solve_diag"
DEFAULT_KS = (1, 8, 64, 512)
REPS = 5  # timed solves per k, after two warm-ups


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"uspmv_tpu_torch.scripts.{NAME}",
                                description=__doc__.split("\n")[0])
    p.add_argument("matrices", nargs="*", default=["Laplace3D,48"])
    p.add_argument("--ks", type=int, nargs="+", default=list(DEFAULT_KS))
    _common.add_common_args(p, NAME)
    return p


def fit_line(ks, ts) -> tuple:
    """(a, b) of the least-squares line t = a + b * k."""
    b, a = np.polyfit(np.asarray(ks, dtype=np.float64),
                      np.asarray(ts, dtype=np.float64), 1)
    return float(a), float(b)


def time_solve(op: SpmvOperator, x: torch.Tensor, k: int,
               mode: str) -> float:
    """Seconds of one ``op.solve(x, k, mode)``: the median of REPS after
    two warm-ups (which build, load and capture)."""
    for _ in range(2):
        op.solve(x, k, mode)
    samples = []
    for _ in range(REPS):
        if op.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            op.solve(x, k, mode)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            op.solve(x, k, mode)
            samples.append(time.perf_counter() - t0)
    return float(np.median(samples))


def run_matrix(spec: str, args: argparse.Namespace,
               device: torch.device) -> List[dict]:
    """The rows of one matrix: one per mode the operator runs."""
    mtx = load_matrix(spec)
    row_sums = np.bincount(mtx.I, weights=np.abs(mtx.values),
                           minlength=mtx.n_rows)
    mtx.values = mtx.values / max(float(row_sums.max()), 1.0)
    cfg = Config(kernel_format="scs", chunk_size=1024, sigma=1,
                 value_type="sp", backend=args.backend,
                 mixed_tiles=False, split_rows_threshold=-1)
    op = SpmvOperator.from_mtx(cfg, mtx)
    x = op.make_x(np.random.default_rng(0).standard_normal(mtx.n_rows))
    modes = ["loop"]
    if device.type == "cuda":
        modes.append("graph")
        if op.fused_solve_eligible():
            modes.append("fused")
    print(f"== {spec}: {mtx.n_rows} rows, {op.nnz} nnz, impl "
          f"{op.impl_name()}, fused-eligible {op.fused_solve_eligible()}")
    platform = _common.platform_of(device)
    rows = []
    for mode in modes:
        ts = [time_solve(op, x, k, mode) for k in args.ks]
        a, b = fit_line(args.ks, ts)
        gflops = 2.0 * op.nnz / b / 1e9 if b > 0 else None
        print(f"  {mode:6s} launch {a * 1e6:10.2f} us  per-iter "
              f"{b * 1e6:10.3f} us  -> "
              f"{'n/a' if gflops is None else f'{gflops:.2f}'} GFLOP/s "
              "asymptotic")
        rows.append(dict(
            metric=f"solve_diag_{spec}_{mode}", matrix=spec, mode=mode,
            value_type="sp", n_rows=mtx.n_rows, nnz=op.nnz,
            impl=f"solve-{mode}[{op.impl_name()}]",
            launch_us=a * 1e6, per_iter_us=b * 1e6,
            gflops_asymptotic=gflops, ks=list(map(int, args.ks)),
            total_s={int(k): t for k, t in zip(args.ks, ts)},
            platform=platform,
            utc=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())))
    return rows


def run(args: argparse.Namespace) -> List[dict]:
    """Every matrix's rows; also appended to --out."""
    if len(args.ks) < 2:
        raise ValueError("the fit needs at least two values of k")
    device = _common.device_for(args.backend)  # raises without the device
    rows = []
    for spec in args.matrices:
        rows += run_matrix(spec, args, device)
    path = _common.write_rows(args.out or _common.default_out(NAME), rows)
    print(f"appended {len(rows)} rows to {path}")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
