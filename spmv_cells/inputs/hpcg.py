"""HPCG's matrix: the 27-point stencil of GenerateProblem_ref.cpp.

HPCG 3.1 (https://www.hpcg-benchmark.org/, src/GenerateProblem_ref.cpp)
builds, for a grid of nx * ny * nz points in natural order (row = ix +
nx * (iy + ny * iz)), one row per point with the point itself at 26 and
each of its up to 26 neighbours at -1, columns ascending within a row.
Here in plain numpy.

nnz = (3 nx - 2) (3 ny - 2) (3 nz - 2): along one axis, a point has
itself and, inside the grid, a neighbour on each side.
"""

from __future__ import annotations

import numpy as np

DIAGONAL = 26.0
OFF_DIAGONAL = -1.0
# per axis, whether the shift -1, 0, +1 stays inside the grid for a point
# inside (0), on the low face (1), on the high face (2) or on both (3)
INSIDE = np.array([[1, 1, 1], [0, 1, 1], [1, 1, 0], [0, 1, 0]], dtype=bool)


def nnz(params: dict) -> int:
    """The stencil's nonzeros, in closed form."""
    return int(np.prod([3 * params[k] - 2 for k in ("nx", "ny", "nz")]))


def _faces(m: int) -> np.ndarray:
    """Per point along an axis of m points: 1 on the low face, 2 on the
    high face, 3 on both, 0 inside."""
    i = np.arange(m)
    return ((i == 0) + 2 * (i == m - 1)).astype(np.int8)


def generate(params: dict) -> tuple:
    """(n_rows, n_cols, I, J, V): int32 rows sorted ascending, int32
    columns ascending within a row, float64 values."""
    nx, ny, nz = (int(params[k]) for k in ("nx", "ny", "nz"))
    n = nx * ny * nz
    if n >= 2**31:
        raise ValueError(f"hpcg: {n} rows exceed int32 indices")
    # HPCG's loop order: sz outer, then sy, then sx, so columns ascend
    shifts = [(sz, sy, sx) for sz in (-1, 0, 1) for sy in (-1, 0, 1)
              for sx in (-1, 0, 1)]
    offsets = np.array([(sz * ny + sy) * nx + sx for sz, sy, sx in shifts],
                       dtype=np.int32)
    # a point's neighbours inside the grid depend only on its faces along
    # each axis: 64 classes, each with its mask over the 27 shifts
    fz, fy, fx = np.meshgrid(np.arange(4), np.arange(4), np.arange(4),
                             indexing="ij")
    table = np.stack([INSIDE[fz, sz + 1] & INSIDE[fy, sy + 1]
                      & INSIDE[fx, sx + 1] for sz, sy, sx in shifts],
                     axis=-1).reshape(64, 27)
    cls = (16 * _faces(nz)[:, None, None] + 4 * _faces(ny)[None, :, None]
           + _faces(nx)[None, None, :]).ravel()
    keep = table[cls]
    rows = np.arange(n, dtype=np.int32)
    J = (rows[:, None] + offsets[None, :])[keep]
    del keep
    I = np.repeat(rows, table.sum(axis=1)[cls])
    V = np.where(J == I, DIAGONAL, OFF_DIAGONAL)
    return n, n, I, J, V
