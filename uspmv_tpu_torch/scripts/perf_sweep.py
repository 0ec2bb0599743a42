"""Node-performance sweep: SpMV/SpMMV over C x sigma x precision x
block_vec_size on one device, as a GFLOP/s / effective-GB/s table and JSON
rows.

Port of the JAX package's scripts/perf_sweep.py (its counterpart of the
reference's scripts/check_perf.sh and SPMMV_bottleneck.sh), with the same
arguments, (C, sigma) sets, precisions, block-vector sizes and row keys,
through the port's ``Config``, ``SpmvOperator`` and ``bench_spmv``:

    python -m uspmv_tpu_torch.scripts.perf_sweep [matrix.mtx | 'Laplace3D,64']
        [--quick | --bs_only] [--bench_time S] [--backend cuda|cpu]
        [--out PATH]

Rows are appended to --out, by default build/uspmv_tpu_torch/perf_sweep.jsonl
(the perf_sweep.jsonl at the repository root is the JAX package's TPU
record). On a GPU ``bench_spmv`` times replays of a CUDA graph of
captured SpMVs, so each row reports the card, not the host's enqueue (on
the CPU a loop of calls; the row's ``timing`` says which). A failed
configuration raises.
"""

from __future__ import annotations

import argparse
import itertools
import sys
from typing import List, Optional

from ..cli import load_matrix
from ..config import Config
from ..runtime.bench import bench_spmv
from ..runtime.operator import SpmvOperator
from . import _common

NAME = "perf_sweep"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"uspmv_tpu_torch.scripts.{NAME}",
                                description=__doc__.split("\n")[0])
    p.add_argument("matrix", nargs="?", default="Laplace3D,64")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--bs_only", action="store_true",
                   help="only the block-vector dimension at C=1024, sigma=1, "
                        "sp: bs 1, 4, 8, 16, 32")
    p.add_argument("--bench_time", type=float, default=1.5)
    _common.add_common_args(p, NAME)
    return p


def sweep_sets(args: argparse.Namespace):
    """((C, sigma) list, precisions, bs list) of the JAX script."""
    if args.bs_only:
        return [(1024, 1)], ["sp"], [1, 4, 8, 16, 32]
    if args.quick:
        return [(1024, 1)], ["sp"], [1, 8]
    return ([(1, 1), (16, 512), (1024, 1), (1024, 1024)], ["sp", "hp"],
            [1, 4, 8, 16, 32])


def run(args: argparse.Namespace, mtx=None) -> List[dict]:
    """The sweep on ``args.matrix`` (or the matrix given, under that
    name); returns its rows, also appended to --out."""
    _common.device_for(args.backend)  # raises early without the device
    if mtx is None:
        mtx = load_matrix(args.matrix)
    print(f"matrix: {args.matrix}  n={mtx.n_rows}  nnz={mtx.nnz}")
    cs, precs, bss = sweep_sets(args)
    rows = []
    header = (f"{'C':>6} {'sigma':>6} {'prec':>5} {'bs':>3} {'GFLOP/s':>9} "
              f"{'GB/s':>7} {'us/iter':>8} {'beta':>6}")
    print(header)
    print("-" * len(header))
    for (C, sigma), prec, bs in itertools.product(cs, precs, bss):
        cfg = Config(
            kernel_format="scs" if C > 1 or sigma > 1 else "crs",
            chunk_size=C, sigma=sigma, value_type=prec,
            block_vec_size=bs,
            vector_layout="rowwise" if bs > 1 else "colwise",
            bench_time=args.bench_time, backend=args.backend,
        )
        op = SpmvOperator.from_mtx(cfg, mtx)
        res = bench_spmv(op, warmup=10, start_iters=32)
        us = res.duration_kernel_s / res.n_iterations * 1e6
        beta = next(iter(res.device_beta.values()))
        print(f"{C:>6} {sigma:>6} {prec:>5} {bs:>3} "
              f"{res.perf_gflops:>9.1f} {res.effective_gbps:>7.1f} "
              f"{us:>8.1f} {beta:>6.3f}")
        rows.append({
            "matrix": args.matrix, "C": C, "sigma": sigma,
            "value_type": prec, "block_vec_size": bs,
            "gflops": round(res.perf_gflops, 2),
            "effective_gbps": round(res.effective_gbps, 2),
            "us_per_iter": round(us, 2),
            "device_beta": round(beta, 4),
            "platform": res.platform,
            # which kernel ran: the tier (SELL-C-sigma or packed rows)
            "impl": res.impl,
            "device_name": res.device_name,
            "timing": res.timing,
        })
        del op
    path = _common.write_rows(args.out or _common.default_out(NAME), rows)
    print(f"\n{len(rows)} results appended to {path}")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
