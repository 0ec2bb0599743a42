"""Accuracy of -dp_emu against native dp and scipy, and the dp speed.

Port of the JAX package's scripts/check_dp_emu.py, the check that the
on-chip dp path keeps f64 accuracy. On the TPU -dp_emu runs the df64
(hi, lo) float-pair kernel; the port runs native double for it, so
-dp_emu and plain dp build the same SELL-C-sigma kernel at f64. The
script holds both against the scipy f64 oracle from one random x, checks
that they name the same kernel, and times that kernel once with
``bench_spmv`` (the dp row) beside scipy's own CSR product on the host.
There is no df64-against-dp speed comparison to make here.

    python -m uspmv_tpu_torch.scripts.check_dp_emu ['Laplace3D,96']
        [--bench_time S] [--backend cuda|cpu] [--out PATH]

Rows ({"variant", "matrix", "gflops", "max_rel_err", "impl", "platform",
...}; the dp_emu row's gflops is null, "same_kernel_as": "dp") are
appended to --out, by default build/uspmv_tpu_torch/check_dp_emu.jsonl.
Exits 1 when a variant's error exceeds 1e-12 (the JAX script's bound).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from ..cli import load_matrix
from ..config import Config
from ..runtime.bench import bench_spmv
from ..runtime.operator import SpmvOperator
from . import _common

NAME = "check_dp_emu"
MAX_REL_ERR = 1e-12


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"uspmv_tpu_torch.scripts.{NAME}",
                                description=__doc__.split("\n")[0])
    p.add_argument("matrix", nargs="?", default="Laplace3D,96")
    p.add_argument("--bench_time", type=float, default=2.0)
    _common.add_common_args(p, NAME)
    return p


def run(args: argparse.Namespace) -> List[dict]:
    """The -dp_emu, dp and scipy rows of ``args.matrix``; also appended
    to --out."""
    _common.device_for(args.backend)  # raises early without the device
    mtx = load_matrix(args.matrix)
    A = mtx.to_scipy().tocsr().astype(np.float64)
    x = np.random.default_rng(0).standard_normal(mtx.n_rows)
    ref = A @ x
    rows = []
    for variant, emu in (("dp_emu", True), ("dp", False)):
        cfg = Config(kernel_format="scs", chunk_size=1024, sigma=1,
                     value_type="dp", dp_emulation=emu,
                     bench_time=args.bench_time, backend=args.backend)
        op = SpmvOperator.from_mtx(cfg, mtx)
        y = op.to_host(op.spmv(op.make_x(x)))
        rel = float(np.abs(y - ref).max() / np.abs(ref).max())
        row = {"variant": variant, "matrix": args.matrix, "gflops": None,
               "gbps": None, "max_rel_err": rel, "impl": op.impl_name()}
        if emu:
            row["same_kernel_as"] = "dp"
            print(f"{variant:>7}: max rel error {rel:.3e} [{row['impl']}]"
                  " (the dp kernel; timed once, as dp)")
        else:
            if row["impl"] != rows[0]["impl"]:
                raise RuntimeError(f"-dp_emu runs {rows[0]['impl']}, dp "
                                   f"runs {row['impl']}: not one kernel")
            res = bench_spmv(op, timing_reps=3)
            row.update(gflops=res.perf_gflops, gbps=res.effective_gbps,
                       platform=res.platform, device_name=res.device_name)
            print(f"{variant:>7}: max rel error {rel:.3e}, "
                  f"{res.perf_gflops:.1f} GFLOP/s ({res.effective_gbps:.0f}"
                  f" GB/s effective) [{res.impl}]")
        rows.append(row)
        del op
    # scipy's f64 CSR product on the host, the oracle's own speed
    reps, t = 0, 0.0
    t0 = time.perf_counter()
    while t < min(args.bench_time, 1.0) or reps < 3:
        A @ x
        reps += 1
        t = time.perf_counter() - t0
    gflops = 2.0 * mtx.nnz * reps / t / 1e9
    print(f"  scipy: {gflops:.1f} GFLOP/s on the host")
    rows.append({"variant": "scipy", "matrix": args.matrix, "gflops": gflops,
                 "max_rel_err": 0.0, "impl": "scipy-csr-f64",
                 "platform": "cpu", "device_name": "cpu"})
    path = _common.write_rows(args.out or _common.default_out(NAME), rows)
    print(f"{len(rows)} rows appended to {path}")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    rows = run(build_parser().parse_args(argv))
    bad = [r for r in rows if r["max_rel_err"] > MAX_REL_ERR]
    for r in bad:
        print(f"{r['variant']}: dp accuracy regressed: {r['max_rel_err']:.3e}"
              f" > {MAX_REL_ERR:g}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
