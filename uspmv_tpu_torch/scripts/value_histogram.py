"""Nonzero-value and row-length histograms of a matrix.

Port of the JAX package's scripts/value_histogram.py (the reference's
scripts/plot_nz.py + get_matrix_stats' log-scale histograms), through the
port's ``load_matrix`` and ``formats.stats.get_matrix_stats``. Host only.
A PNG via matplotlib where it is installed, else an ASCII rendering on
standard output.

    python -m uspmv_tpu_torch.scripts.value_histogram <matrix.mtx | spec>
        [-o OUT.png] [-b BINS]

The PNG goes to -o, by default build/uspmv_tpu_torch/<name>_values.png.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from ..cli import load_matrix
from ..formats.stats import get_matrix_stats
from ..ops._build import BUILD_DIR


def ascii_hist(title, centers, counts, width=50):
    print(title)
    mx = counts.max() or 1
    for c, n in zip(centers, counts):
        bar = "#" * int(n / mx * width)
        print(f"  {c:>12.3e} | {bar} {n}")


def histograms(mtx, bins: int):
    """(|value| bin centres, their counts, row lengths, their counts):
    log10 bins over the nonzero |values|, one bin per row length."""
    vals = np.abs(np.asarray(mtx.values, dtype=np.float64))
    vals = vals[vals > 0]
    log_edges = np.linspace(
        np.log10(vals.min()), np.log10(vals.max()) + 1e-12, bins + 1
    )
    vcounts, _ = np.histogram(np.log10(vals), bins=log_edges)
    vcenters = 10 ** ((log_edges[:-1] + log_edges[1:]) / 2)
    rl = np.bincount(mtx.I, minlength=mtx.n_rows)
    redges = np.arange(rl.min(), rl.max() + 2)
    rcounts, _ = np.histogram(rl, bins=redges)
    return vcenters, vcounts, redges[:-1], rcounts


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="uspmv_tpu_torch.scripts."
                                      "value_histogram")
    ap.add_argument("matrix")
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("-b", "--bins", type=int, default=40)
    args = ap.parse_args(argv)

    mtx = load_matrix(args.matrix)
    print(get_matrix_stats(mtx).summary())
    vcenters, vcounts, lengths, rcounts = histograms(mtx, args.bins)
    base = os.path.splitext(os.path.basename(args.matrix))[0] or "matrix"
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        ascii_hist("|a_ij| histogram (log bins):", vcenters, vcounts)
        nz = rcounts > 0
        ascii_hist("row-length histogram:", lengths[nz], rcounts[nz])
        return 0
    out = args.out or str(BUILD_DIR / f"{base}_values.png")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(11, 4))
    a1.bar(range(len(vcounts)), vcounts)
    a1.set_title(f"|a_ij| distribution (log10 bins), nnz={mtx.nnz}")
    a1.set_xlabel("log10 |value| bin")
    a2.bar(lengths, rcounts, width=1.0)
    a2.set_title("row length distribution")
    a2.set_xlabel("nnz per row")
    fig.savefig(out, dpi=130, bbox_inches="tight")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
