"""Report writers.

Port of ``uspmv_tpu/runtime/report.py`` (reference write_results.hpp):
append-mode human-readable blocks for bench results (``spmv_bench.txt``,
write_bench_to_file, write_results.hpp:42-157) and accuracy reports per
precision (``spmv_scipy_compare_{dp,sp}.txt``, write_result_to_file,
write_results.hpp:170-434), plus a machine-readable JSON sibling.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Optional

from ..config import Config
from .bench import BenchResult
from .validate import ValidationReport


def _stamp() -> str:
    return datetime.datetime.now().isoformat(timespec="seconds")


def format_bench_block(cfg: Config, res: BenchResult) -> str:
    lines = [
        "=" * 64,
        f"uspmv_tpu_torch bench @ {_stamp()}",
        f"matrix: {cfg.matrix_file_name or '<generated>'}",
        f"format: {res.kernel_format} C={res.C} sigma={res.sigma} "
        f"value_type={res.value_type} block_vec_size={res.block_vec_size} "
        f"layout={cfg.vector_layout}",
        f"platform: {res.platform} ({res.device_name})  impl: "
        f"{res.impl or '?'}  n_rows: {res.n_rows}  nnz: {res.nnz}",
        f"n_iterations: {res.n_iterations}  kernel_time: "
        f"{res.duration_kernel_s:.4f} s"
        + (
            f" (median of {len(res.timing_samples_s)}: "
            + ", ".join(f"{s:.4f}" for s in res.timing_samples_s) + ")"
            if res.timing_samples_s and len(res.timing_samples_s) > 1
            else ""
        ),
        f"perf: {res.perf_gflops:.3f} GFLOP/s   effective bw: "
        f"{res.effective_gbps:.2f} GB/s",
        f"memory footprint: {res.memory_footprint_bytes / 1e6:.2f} MB",
    ]
    for p in res.beta:
        pct = 100.0 * res.nnz_per_precision[p] / max(res.nnz, 1)
        lines.append(
            f"  [{p}] nnz={res.nnz_per_precision[p]} ({pct:.1f}%) "
            f"beta={res.beta[p]:.4f} device_beta={res.device_beta[p]:.4f}"
        )
    lines.append(
        f"  split_rows_threshold={res.split_rows_threshold} "
        f"pieces={res.n_pieces} nnz_in_pieces={res.nnz_in_pieces}"
    )
    if cfg.is_ap or cfg.dropout:
        # reference main.cpp:895-905 prints the per-precision split
        lines.append(f"  n_dropped={res.n_dropped}")
    if cfg.block_vec_size > 1 and cfg.vector_layout == "colwise":
        lines.append(
            f"note: colwise SpMMV streams the matrix once per vector "
            f"({cfg.block_vec_size} passes); -layout rowwise streams it once "
            "for up to 8 vectors"
        )
    lines.append("")
    return "\n".join(lines)


def write_bench_to_file(cfg: Config, res: BenchResult, path: Optional[str] = None) -> str:
    path = path or os.path.join(cfg.output_dir, "spmv_bench.txt")
    with open(path, "a") as f:
        f.write(format_bench_block(cfg, res))
    # machine-readable sibling
    jpath = os.path.splitext(path)[0] + ".jsonl"
    with open(jpath, "a") as f:
        f.write(json.dumps({"ts": _stamp(), **res.to_dict()}) + "\n")
    return path


def format_result_block(cfg: Config, rep: ValidationReport,
                        n_repetitions: int, impl: str = "") -> str:
    """``impl``: which solve implementation ran (solve-loop[...],
    solve-graph[...] or solve-fused[...])."""
    return "\n".join(
        [
            "=" * 64,
            f"uspmv_tpu_torch solve validation @ {_stamp()}",
            f"matrix: {cfg.matrix_file_name or '<generated>'}",
            f"format: {cfg.kernel_format} C={cfg.chunk_size} sigma={cfg.sigma} "
            f"value_type={cfg.value_type} revs={n_repetitions}",
            f"impl: {impl or '?'}",
            "oracle: scipy.sparse CSR (float64)",
            rep.summary(),
            "",
        ]
    )


def write_result_to_file(
    cfg: Config, rep: ValidationReport, n_repetitions: int,
    path: Optional[str] = None, impl: str = "",
) -> str:
    if path is None:
        tag = "ap" if cfg.is_ap else cfg.value_type
        path = os.path.join(cfg.output_dir, f"spmv_scipy_compare_{tag}.txt")
    with open(path, "a") as f:
        f.write(format_result_block(cfg, rep, n_repetitions, impl))
    return path
