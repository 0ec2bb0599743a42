"""Matrix statistics & histograms.

Port of ``uspmv_tpu/formats/stats.py``, host-side numpy with the same
fields and the same ``summary()`` text: the reference's get_matrix_stats /
Histogram / Statistics / print_matrix_statistics
(utilities.hpp:232-573,787-853), i.e. row/col length statistics, bandwidth
statistics and log2-scale histograms. The reference's main program has a
"bring back" TODO for this (main.cpp:1357-1359); the CLI prints it for
-matrix_stats.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .coo import MtxData


@dataclasses.dataclass
class Statistics:
    min: float
    max: float
    avg: float
    std_dev: float
    median: float

    @classmethod
    def of(cls, v: np.ndarray) -> "Statistics":
        v = np.asarray(v, dtype=np.float64)
        if v.size == 0:
            return cls(0, 0, 0, 0, 0)
        return cls(
            min=float(v.min()),
            max=float(v.max()),
            avg=float(v.mean()),
            std_dev=float(v.std()),
            median=float(np.median(v)),
        )


def log2_histogram(v: np.ndarray, n_buckets: int = 32) -> Dict[int, int]:
    """Histogram with log2-scaled bucket edges (reference Histogram,
    utilities.hpp:232-350): bucket k counts values in [2^(k-1), 2^k)
    (bucket 0 counts zeros and ones)."""
    v = np.asarray(v, dtype=np.float64)
    buckets: Dict[int, int] = {}
    nz = v[v > 0]
    buckets[0] = int((v <= 1).sum())
    if nz.size:
        k = np.ceil(np.log2(np.maximum(nz, 1.0))).astype(np.int64)
        k = np.clip(k, 0, n_buckets - 1)
        k = k[nz > 1]
        for kk, cnt in zip(*np.unique(k, return_counts=True)):
            buckets[int(kk)] = int(cnt)
    return buckets


@dataclasses.dataclass
class MatrixStats:
    n_rows: int
    n_cols: int
    nnz: int
    density_percent: float
    row_lengths: Statistics
    col_lengths: Statistics
    bandwidths: Statistics
    n_empty_rows: int
    row_length_hist: Dict[int, int]
    bandwidth_hist: Dict[int, int]
    value_min_abs: float
    value_max_abs: float

    def summary(self) -> str:
        return "\n".join(
            [
                f"matrix: {self.n_rows} x {self.n_cols}, nnz {self.nnz} "
                f"(density {self.density_percent:.4f}%)",
                f"row lengths : min {self.row_lengths.min:.0f} max "
                f"{self.row_lengths.max:.0f} avg {self.row_lengths.avg:.2f} "
                f"std {self.row_lengths.std_dev:.2f} median "
                f"{self.row_lengths.median:.0f}  (empty rows: {self.n_empty_rows})",
                f"col lengths : min {self.col_lengths.min:.0f} max "
                f"{self.col_lengths.max:.0f} avg {self.col_lengths.avg:.2f} "
                f"std {self.col_lengths.std_dev:.2f}",
                f"bandwidth   : min {self.bandwidths.min:.0f} max "
                f"{self.bandwidths.max:.0f} avg {self.bandwidths.avg:.2f}",
                f"|values|    : min {self.value_min_abs:.3e} max "
                f"{self.value_max_abs:.3e}",
                f"row-length log2 histogram: {self.row_length_hist}",
                f"bandwidth  log2 histogram: {self.bandwidth_hist}",
            ]
        )


def get_matrix_stats(mtx: MtxData) -> MatrixStats:
    row_lens = np.bincount(mtx.I, minlength=mtx.n_rows)
    col_lens = np.bincount(mtx.J, minlength=mtx.n_cols)
    # per-row bandwidth: max |j - i| over row entries (reference computes
    # distance from the diagonal)
    bw = np.zeros(mtx.n_rows, dtype=np.int64)
    if mtx.nnz:
        np.maximum.at(bw, mtx.I, np.abs(mtx.J.astype(np.int64) - mtx.I))
    a = np.abs(mtx.values.astype(np.float64))
    return MatrixStats(
        n_rows=mtx.n_rows,
        n_cols=mtx.n_cols,
        nnz=mtx.nnz,
        density_percent=100.0 * mtx.nnz / max(mtx.n_rows * mtx.n_cols, 1),
        row_lengths=Statistics.of(row_lens),
        col_lengths=Statistics.of(col_lens),
        bandwidths=Statistics.of(bw),
        n_empty_rows=int((row_lens == 0).sum()),
        row_length_hist=log2_histogram(row_lens),
        bandwidth_hist=log2_histogram(bw),
        value_min_abs=float(a.min()) if a.size else 0.0,
        value_max_abs=float(a.max()) if a.size else 0.0,
    )
