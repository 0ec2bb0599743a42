"""Scalable synthetic matrix generators.

Port of ``uspmv_tpu/io/generators.py`` (the stand-in for the reference's
ScaMaC bridge, utilities.hpp:1585-1752): the structured generators, and
through ``generate_matrix`` the ScaMaC-style models of ``io/scamac.py``.
Each produces a matrix bit-equal to the JAX package's for the same
arguments.
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


def random_imbalanced(n: int, avg_nnz_per_row: int, alpha: float = 1.3, seed: int = 7) -> MtxData:
    """Power-law row lengths: stresses sigma-window sorting and seg-nnz
    partitioning (the workloads the reference's chunk-occupancy machinery
    exists for). Columns are uniform-random: no locality."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, size=n) + 1.0
    lens = np.maximum(1, (raw / raw.mean() * avg_nnz_per_row)).astype(np.int64)
    lens = np.minimum(lens, n)
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    cols = rng.integers(0, n, size=rows.size)
    vals = rng.standard_normal(rows.size)
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    first.sort()
    return MtxData.from_arrays(
        rows[first], cols[first], vals[first], n_rows=n, n_cols=n
    ).sort_by_row()


def banded_imbalanced(
    n: int, bandwidth: int = 64, avg_nnz_per_row: int = 8,
    alpha: float = 1.3, seed: int = 7,
) -> MtxData:
    """Banded matrix with power-law row lengths: columns stay within a
    diagonal band but row lengths are heavy-tailed, the regime where
    sigma-sorting and heavy-row handling pay."""
    rng = np.random.default_rng(seed)
    # mostly Poisson(avg) rows with a heavy tail: alpha controls the tail
    # fraction (~0.1% at 1.3) whose rows fill the whole band
    counts = rng.poisson(max(avg_nnz_per_row - 1, 1), n) + 1
    tail = rng.random(n) < 10 ** (-alpha - 1.7)
    counts = np.where(tail, 2 * bandwidth + 1, counts).astype(np.int64)
    counts = np.minimum(counts, 2 * bandwidth + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    offs = rng.integers(-bandwidth, bandwidth + 1, rows.size)
    cols = np.clip(rows + offs, 0, n - 1)
    vals = rng.standard_normal(rows.size)
    # deduplicate (i, j)
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    return MtxData.from_arrays(
        rows[first], cols[first], vals[first], n_rows=n, n_cols=n
    ).sort_by_row()


def powerlaw_cols(n: int, avg_nnz_per_row: int = 8, alpha: float = 1.0,
                  seed: int = 7) -> MtxData:
    """Power-law COLUMN popularity (SuiteSparse dlr1-class radiosity/graph
    workloads): column j is referenced with probability ~ 1/(j+1)^alpha, so
    a few hub columns appear in a large fraction of rows while the tail is
    near-uniform. Zero row locality, zero diagonal structure."""
    rng = np.random.default_rng(seed)
    lens = rng.poisson(max(avg_nnz_per_row - 1, 1), n) + 1
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    # Zipf-ish columns via inverse-CDF on the normalized weight cumsum;
    # a random permutation decouples popularity from column index
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), alpha)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    ranks = np.searchsorted(cdf, rng.random(rows.size))
    colmap = rng.permutation(n).astype(np.int64)
    cols = colmap[np.minimum(ranks, n - 1)]
    vals = rng.standard_normal(rows.size)
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    first.sort()
    return MtxData.from_arrays(
        rows[first], cols[first], vals[first], n_rows=n, n_cols=n
    ).sort_by_row()


def fem_tet3d(nx: int, dofs: int = 3, keep: float = 0.7,
              seed: int = 7) -> MtxData:
    """Unstructured-FEM stiffness-matrix structure (SuiteSparse Queen_4147 /
    af_shell class): a 3-D node grid where each node couples to a random
    ~``keep`` fraction of its 26 neighbours (symmetrically), then every node
    expands to a ``dofs``-wide dense block. Row lengths land in the 20-80
    nnz/row range; values are symmetric and diagonally dominant.

    nx=55, dofs=3 -> ~500k rows, ~28M nnz.
    """
    n_nodes = nx ** 3
    rng = np.random.default_rng(seed)
    idx = np.arange(n_nodes, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % nx
    iz = idx // (nx * nx)

    # symmetric node graph: lexicographically positive offsets, mirrored,
    # so (i, j) present <=> (j, i) present
    offsets = [
        (dx, dy, dz)
        for dz in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if (dz, dy, dx) > (0, 0, 0)
    ]
    I, J = [idx], [idx]
    for dx, dy, dz in offsets:
        m = np.ones(n_nodes, dtype=bool)
        if dx:
            m &= (ix + dx >= 0) & (ix + dx < nx)
        if dy:
            m &= (iy + dy >= 0) & (iy + dy < nx)
        if dz:
            m &= (iz + dz >= 0) & (iz + dz < nx)
        m &= rng.random(n_nodes) < keep
        src = idx[m]
        dst = src + dx + dy * nx + dz * nx * nx
        I += [src, dst]
        J += [dst, src]
    I = np.concatenate(I)
    J = np.concatenate(J)

    # dofs-wide dense blocks: node edge (a, b) -> all (a*d+p, b*d+q)
    d = int(dofs)
    p = np.arange(d, dtype=np.int64)
    bI = (I[:, None] * d + np.repeat(p, d)[None, :]).reshape(-1)
    bJ = (J[:, None] * d + np.tile(p, d)[None, :]).reshape(-1)
    # symmetric values: hash the unordered dof-pair key
    lo = np.minimum(bI, bJ)
    hi = np.maximum(bI, bJ)
    key = (lo * (n_nodes * d) + hi).astype(np.uint64)
    key ^= key >> 33
    key *= np.uint64(0xFF51AFD7ED558CCD)
    key ^= key >> 33
    vals = -(key.astype(np.float64) / 2.0**64) - 0.05  # in (-1.05, -0.05)
    diag = bI == bJ
    m = MtxData.from_arrays(
        bI[~diag], bJ[~diag], vals[~diag],
        n_rows=n_nodes * d, n_cols=n_nodes * d,
    )
    # diagonally dominant diagonal: sum of |off-diagonals| per row + 1
    rowsum = np.bincount(m.I, weights=np.abs(m.values), minlength=n_nodes * d)
    dI = np.arange(n_nodes * d, dtype=np.int64)
    return MtxData.from_arrays(
        np.concatenate([m.I, dI]), np.concatenate([m.J, dI]),
        np.concatenate([m.values, rowsum + 1.0]),
        n_rows=n_nodes * d, n_cols=n_nodes * d,
    ).sort_by_row()


def wide_spectrum(nx: int, decades: float = 8.0, dofs: int = 3,
                  seed: int = 7) -> MtxData:
    """``fem_tet3d``'s structure with values log-uniform over ``decades``
    orders of magnitude: the matrix class the 3-way ap[dp_sp_hp] split
    exists for (reference utilities.hpp:3042-3121). Diagonal entries are
    pinned to the top decade."""
    m = fem_tet3d(nx, dofs=dofs, seed=seed)
    rng = np.random.default_rng(seed + 1)
    mag = np.power(10.0, -rng.random(m.nnz) * decades)
    sign = rng.choice([-1.0, 1.0], m.nnz)
    values = mag * sign
    diag = m.I == m.J
    values[diag] = np.power(10.0, -rng.random(int(diag.sum()))) * 4.0
    m.values[:] = values
    return m


def stokes_saddle(nx: int, eps: float = 1e-3, seed: int = 7) -> MtxData:
    """Saddle-point structure (SuiteSparse vas_stokes / StocF class):

        [ A   B ]   A: 3x3-dense-block 7-point operator on cell velocities
        [ B^T -eps*I ]   B: velocity<->pressure gradient coupling

    over an nx^3 cell grid — 4 unknowns per cell (u,v,w,p), velocity rows
    ~24-27 nnz, pressure rows ~22, and the near-zero pressure block gives
    the strongly-mixed row-length profile SELL-C-sigma's sigma-sorting was
    built for. Unsymmetric in values (B vs B^T signs), symmetric pattern.

    nx=64 -> ~1.05M rows, ~25M nnz (vas_stokes_1M-class).
    """
    n = nx ** 3
    rng = np.random.default_rng(seed)
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % nx
    iz = idx // (nx * nx)
    nv = 3 * n  # velocity dofs, then pressures at [nv, nv + n)

    stencil = [(0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
               (0, 0, -1), (0, 0, 1)]
    cI, cJ = [], []  # cell-graph edges incl. self
    for dx, dy, dz in stencil:
        m = np.ones(n, dtype=bool)
        if dx:
            m &= (ix + dx >= 0) & (ix + dx < nx)
        if dy:
            m &= (iy + dy >= 0) & (iy + dy < nx)
        if dz:
            m &= (iz + dz >= 0) & (iz + dz < nx)
        cI.append(idx[m])
        cJ.append(idx[m] + dx + dy * nx + dz * nx * nx)
    cI = np.concatenate(cI)
    cJ = np.concatenate(cJ)
    ne = cI.size

    # A: 3x3 dense blocks on the cell graph (velocity-velocity)
    p3 = np.arange(3, dtype=np.int64)
    aI = (cI[:, None] * 3 + np.repeat(p3, 3)[None, :]).reshape(-1)
    aJ = (cJ[:, None] * 3 + np.tile(p3, 3)[None, :]).reshape(-1)
    aV = rng.standard_normal(ne * 9) * 0.1
    aV[aI == aJ] = 6.0  # dominant velocity diagonal

    # B: velocity row (cell, component) <- pressure of the stencil cells
    bI = (cI[:, None] * 3 + p3[None, :]).reshape(-1)
    bJ = np.repeat(nv + cJ, 3)
    bV = np.repeat(np.where(cI == cJ, 3.0, -0.5), 3)
    # B^T: pressure row <- velocities (divergence), opposite sign
    tI = np.repeat(nv + cI, 3)
    tJ = (cJ[:, None] * 3 + p3[None, :]).reshape(-1)
    tV = -np.repeat(np.where(cI == cJ, 3.0, -0.5), 3)

    # pressure stabilization diagonal
    pI = nv + idx
    return MtxData.from_arrays(
        np.concatenate([aI, bI, tI, pI]),
        np.concatenate([aJ, bJ, tJ, pI]),
        np.concatenate([aV, bV, tV, np.full(n, -eps)]),
        n_rows=nv + n, n_cols=nv + n,
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
    "RandomImbalanced": random_imbalanced,
    "BandedImbalanced": banded_imbalanced,
    "PowerLawCols": powerlaw_cols,
    "FemTet3D": fem_tet3d,
    "WideSpectrum": wide_spectrum,
    "StokesSaddle": stokes_saddle,
    "Tridiag": tridiag,
}


def generate_matrix(spec: str) -> MtxData:
    """Generate a matrix from a spec string ``Name,arg1,arg2,...``
    (analogue of the reference's ScaMaC argument string,
    utilities.hpp:1585-1752). ScaMaC-style quantum models (Anderson,
    Hubbard, ... with key=value options, any case) route to io.scamac; an
    unknown name raises ValueError."""
    parts = spec.split(",")
    name = parts[0]
    if name not in _GENERATORS:
        from .scamac import scamac_generate, scamac_models

        if name.lower() in scamac_models():
            # genuine model errors (bad options, size limits) propagate
            return scamac_generate(spec)
        raise ValueError(
            f"unknown generator {name!r}; available: "
            f"{sorted(_GENERATORS)} + ScaMaC models {sorted(scamac_models())}"
        )
    args = [float(a) if "." in a else int(a) for a in parts[1:]]
    return _GENERATORS[name](*args)
