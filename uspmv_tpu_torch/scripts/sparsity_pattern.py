"""Sparsity-pattern renderer.

Port of the JAX package's scripts/sparsity_pattern.py (the reference's
scripts/mm2sparsityPattern.py), through the port's ``load_matrix``. Host
only. Renders an .mtx or a generator spec to a density bitmap: a PNG via
matplotlib where it is installed, else a portable PGM written with numpy
only.

    python -m uspmv_tpu_torch.scripts.sparsity_pattern <matrix.mtx | spec>
        [-o OUT] [-b BINS]

The image goes to -o, by default build/uspmv_tpu_torch/<name>_sparsity.png
(.pgm without matplotlib, or where -o names a .pgm file).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from ..cli import load_matrix
from ..ops._build import BUILD_DIR


def density_grid(mtx, bins: int) -> np.ndarray:
    bins = min(bins, max(mtx.n_rows, 1), max(mtx.n_cols, 1))
    r = (mtx.I.astype(np.int64) * bins) // max(mtx.n_rows, 1)
    c = (mtx.J.astype(np.int64) * bins) // max(mtx.n_cols, 1)
    grid = np.zeros((bins, bins), dtype=np.int64)
    np.add.at(grid, (r, c), 1)
    return grid


def write_pgm(path: str, grid: np.ndarray) -> None:
    # log-scaled 8-bit grayscale, nonzero = dark
    g = np.log1p(grid)
    mx = g.max() or 1.0
    img = 255 - (g / mx * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="uspmv_tpu_torch.scripts."
                                      "sparsity_pattern")
    ap.add_argument("matrix")
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("-b", "--bins", type=int, default=512)
    args = ap.parse_args(argv)

    mtx = load_matrix(args.matrix)
    grid = density_grid(mtx, args.bins)
    base = os.path.splitext(os.path.basename(args.matrix))[0] or "matrix"
    out = args.out or str(BUILD_DIR / f"{base}_sparsity.png")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    try:
        if out.endswith(".pgm"):
            raise ImportError  # asked for the portable format
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        out = os.path.splitext(out)[0] + ".pgm"
        write_pgm(out, grid)
        print(f"wrote {out}")
        return 0
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.log1p(grid), cmap="Greys", interpolation="nearest")
    ax.set_title(f"{base}: {mtx.n_rows}x{mtx.n_cols}, nnz={mtx.nnz}")
    fig.savefig(out, dpi=150, bbox_inches="tight")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
