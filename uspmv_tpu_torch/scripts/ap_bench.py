"""Adaptive-precision benchmark: per value type, GFLOP/s, effective GB/s,
the nonzeros and fill of each precision, and the largest relative error of
one SpMV against the scipy f64 oracle from a random x.

Port of the JAX package's scripts/ap_bench.py, with its cases (sp, hp,
-dp_emu, ap[sp_hp], ap[dp_sp], ap[dp_sp_hp]), its thresholds and its row
keys, through the port's ``Config``, ``SpmvOperator`` and ``bench_spmv``.
-dp_emu runs native double here, and ap[dp_*] sums every stream in f64, as
the reference does.

Thresholds follow the reference's scripts/get_buckets.py:
th = tol * ||A||_inf / (0.5 * 2^-23) with tol = 1e-14 (th1) / 1e-16 (th2),
clamped into the value range so the split is non-degenerate on
narrow-spectrum matrices.

    python -m uspmv_tpu_torch.scripts.ap_bench ['Laplace3D,128']
        [--bench_time S] [--tol1 T] [--tol2 T] [--backend cuda|cpu]
        [--out PATH]

Rows are appended to --out, by default build/uspmv_tpu_torch/ap_bench.jsonl
(the ap_bench.jsonl at the repository root is the JAX package's TPU record).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from ..cli import load_matrix
from ..config import Config
from ..runtime.bench import bench_spmv
from ..runtime.operator import SpmvOperator
from . import _common

NAME = "ap_bench"


def get_buckets_threshold(mtx, tol: float) -> float:
    """Reference scripts/get_buckets.py: th = tol * ||A||_inf / (0.5*2^-23)."""
    A = mtx.to_scipy().tocsr()
    inf_norm = float(np.abs(A).sum(axis=1).max())
    return tol * inf_norm / (0.5 * 2.0 ** -23)


def clamp_threshold(mtx, th: float) -> float:
    """Keep the split non-degenerate: where the get_buckets threshold lies
    outside (min|a|, max|a|], take the geometric mean of the range (the
    median can equal the minimum on a two-valued matrix, which would put
    every element in the high-precision partition)."""
    a = np.abs(mtx.values[mtx.values != 0])
    if a.size == 0:
        return th
    if th <= a.min() or th > a.max():
        return float(np.sqrt(a.min() * a.max()))
    return float(th)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"uspmv_tpu_torch.scripts.{NAME}",
                                description=__doc__.split("\n")[0])
    p.add_argument("matrix", nargs="?", default="Laplace3D,128")
    p.add_argument("--bench_time", type=float, default=1.5)
    # get_buckets tolerances; the defaults target f64-level output accuracy
    p.add_argument("--tol1", type=float, default=1e-14)
    p.add_argument("--tol2", type=float, default=1e-16)
    _common.add_common_args(p, NAME)
    return p


def cases(th1: float, th2: float) -> list:
    return [
        ("sp", dict(value_type="sp")),
        ("hp", dict(value_type="hp")),
        ("dp_emu", dict(value_type="dp", dp_emulation=True)),
        ("ap[sp_hp]", dict(value_type="ap[sp_hp]", ap_threshold_1=th1)),
        ("ap[dp_sp]", dict(value_type="ap[dp_sp]", ap_threshold_1=th1,
                           dp_emulation=True)),
        ("ap[dp_sp_hp]", dict(value_type="ap[dp_sp_hp]", ap_threshold_1=th1,
                              ap_threshold_2=th2, dp_emulation=True)),
    ]


def run(args: argparse.Namespace, mtx=None) -> List[dict]:
    """Every case on ``args.matrix`` (or the matrix given, under that
    name); returns its rows, also appended to --out."""
    _common.device_for(args.backend)  # raises early without the device
    if mtx is None:
        mtx = load_matrix(args.matrix)
    A = mtx.to_scipy().tocsr().astype(np.float64)
    rng = np.random.default_rng(7)
    x_in = rng.standard_normal(mtx.n_rows)
    y_ref = A @ x_in
    ref_inf = np.abs(y_ref).max()

    th1 = clamp_threshold(mtx, get_buckets_threshold(mtx, args.tol1))
    th2 = clamp_threshold(mtx, get_buckets_threshold(mtx, args.tol2))
    if th2 >= th1:
        th2 = th1 / 2
    print(f"matrix: {args.matrix}  n={mtx.n_rows}  nnz={mtx.nnz}")
    print(f"thresholds (get_buckets-style): th1={th1:.3e} th2={th2:.3e}")
    hdr = (f"{'value_type':>13} {'GFLOP/s':>8} {'GB/s':>6} "
           f"{'max_rel_err':>11}  nnz% per precision (beta)")
    print(hdr)
    print("-" * len(hdr))
    rows = []
    for name, kw in cases(th1, th2):
        cfg = Config(kernel_format="scs", chunk_size=1024, sigma=1,
                     bench_time=args.bench_time, backend=args.backend, **kw)
        op = SpmvOperator.from_mtx(cfg, mtx)
        # accuracy first (one spmv, random x, vs the f64 oracle)
        y = op.to_host(op.spmv(op.make_x(x_in)))
        err = float(np.abs(y - y_ref).max() / ref_inf)
        res = bench_spmv(op, warmup=20, start_iters=32)
        npp = res.nnz_per_precision
        split = "  ".join(
            f"{p}:{100.0 * npp[p] / max(res.nnz, 1):.1f}%({res.beta[p]:.3f})"
            for p in npp)
        print(f"{name:>13} {res.perf_gflops:8.1f} {res.effective_gbps:6.0f} "
              f"{err:11.2e}  {split}  [{res.impl}]")
        rows.append({
            "matrix": args.matrix, "value_type": name,
            "gflops": round(res.perf_gflops, 2),
            "gbps": round(res.effective_gbps, 1),
            "max_rel_err": err,
            "nnz_per_precision": npp,
            "beta": res.beta, "impl": res.impl,
            "platform": res.platform,
            "device_name": res.device_name,
        })
        del op
    path = _common.write_rows(args.out or _common.default_out(NAME), rows)
    print(f"\n{len(rows)} rows appended to {path}")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
