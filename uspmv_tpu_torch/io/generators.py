"""Scalable synthetic matrix generators.

Port of the structured generators of ``uspmv_tpu/io/generators.py`` (the
stand-in for the reference's ScaMaC bridge, utilities.hpp:1585-1752). Each
produces a matrix bit-equal to the JAX package's for the same arguments.
"""

from __future__ import annotations

import numpy as np

from ..formats.coo import MtxData


def laplace2d(nx: int, ny: int | None = None) -> MtxData:
    """5-point 2-D Laplacian stencil on an nx-by-ny grid (FDM-2d analogue)."""
    ny = ny or nx
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    ix, iy = idx % nx, idx // nx
    rows, cols, vals = [idx], [idx], [np.full(n, 4.0)]
    for d, mask in (
        (-1, ix > 0),
        (+1, ix < nx - 1),
        (-nx, iy > 0),
        (+nx, iy < ny - 1),
    ):
        rows.append(idx[mask])
        cols.append(idx[mask] + d)
        vals.append(np.full(mask.sum(), -1.0))
    return MtxData.from_arrays(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
        n_rows=n,
        n_cols=n,
    ).sort_by_row()


def laplace3d(nx: int, ny: int | None = None, nz: int | None = None) -> MtxData:
    """7-point 3-D Laplacian stencil."""
    ny = ny or nx
    nz = nz or nx
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    rows, cols, vals = [idx], [idx], [np.full(n, 6.0)]
    for d, mask in (
        (-1, ix > 0),
        (+1, ix < nx - 1),
        (-nx, iy > 0),
        (+nx, iy < ny - 1),
        (-nx * ny, iz > 0),
        (+nx * ny, iz < nz - 1),
    ):
        rows.append(idx[mask])
        cols.append(idx[mask] + d)
        vals.append(np.full(mask.sum(), -1.0))
    return MtxData.from_arrays(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
        n_rows=n,
        n_cols=n,
    ).sort_by_row()


def random_banded(n: int, bandwidth: int, nnz_per_row: int, seed: int = 7) -> MtxData:
    """Random matrix with entries clustered in a band — exercises SCS
    sigma-sorting locality like the SuiteSparse FEM matrices."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    offs = rng.integers(-bandwidth, bandwidth + 1, size=rows.size)
    cols = np.clip(rows + offs, 0, n - 1)
    vals = rng.standard_normal(rows.size)
    # dedupe (row, col) keeping first occurrence
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    first.sort()
    return MtxData.from_arrays(
        rows[first], cols[first], vals[first], n_rows=n, n_cols=n
    ).sort_by_row()


def tridiag(n: int, diag: float = 2.0, off: float = -1.0) -> MtxData:
    idx = np.arange(n, dtype=np.int64)
    rows = np.concatenate([idx, idx[1:], idx[:-1]])
    cols = np.concatenate([idx, idx[1:] - 1, idx[:-1] + 1])
    vals = np.concatenate(
        [np.full(n, diag), np.full(n - 1, off), np.full(n - 1, off)]
    )
    return MtxData.from_arrays(rows, cols, vals, n_rows=n, n_cols=n).sort_by_row()


_GENERATORS = {
    "Laplace2D": laplace2d,
    "Laplace3D": laplace3d,
    "RandomBanded": random_banded,
    "Tridiag": tridiag,
}


def generate_matrix(spec: str) -> MtxData:
    """Generate a matrix from a spec string ``Name,arg1,arg2,...``
    (analogue of the reference's ScaMaC argument string,
    utilities.hpp:1585-1752)."""
    parts = spec.split(",")
    name = parts[0]
    if name not in _GENERATORS:
        raise NotImplementedError(
            f"generator {name!r} is not ported yet; available: "
            f"{sorted(_GENERATORS)}"
        )
    args = [float(a) if "." in a else int(a) for a in parts[1:]]
    return _GENERATORS[name](*args)
