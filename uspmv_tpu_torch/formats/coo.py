"""COO matrix container and host-side preprocessing.

Port of ``uspmv_tpu/formats/coo.py`` (reference ``MtxData``,
classes_structs.hpp:1169-1238, plus the permutation helpers of
utilities.hpp). Host-side numpy, int32 indices; every function returns
arrays bit-equal to the JAX package's for the same input.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class MtxData:
    """A COO sparse matrix (reference MtxData, classes_structs.hpp:1169).

    ``I``/``J`` are int32 row/col indices, ``values`` any float dtype.
    """

    n_rows: int
    n_cols: int
    nnz: int
    is_sorted: bool
    is_symmetric: bool
    I: np.ndarray
    J: np.ndarray
    values: np.ndarray

    @classmethod
    def from_arrays(
        cls,
        I,
        J,
        values,
        n_rows: Optional[int] = None,
        n_cols: Optional[int] = None,
        is_sorted: bool = False,
        is_symmetric: bool = False,
    ) -> "MtxData":
        I = np.asarray(I, dtype=np.int32)
        J = np.asarray(J, dtype=np.int32)
        values = np.asarray(values)
        if n_rows is None:
            n_rows = int(I.max()) + 1 if I.size else 0
        if n_cols is None:
            n_cols = int(J.max()) + 1 if J.size else 0
        return cls(
            n_rows=int(n_rows),
            n_cols=int(n_cols),
            nnz=int(values.size),
            is_sorted=is_sorted,
            is_symmetric=is_symmetric,
            I=I,
            J=J,
            values=values,
        )

    @classmethod
    def from_scipy(cls, mat, is_symmetric: bool = False) -> "MtxData":
        coo = mat.tocoo()
        return cls.from_arrays(
            coo.row,
            coo.col,
            coo.data,
            n_rows=coo.shape[0],
            n_cols=coo.shape[1],
            is_symmetric=is_symmetric,
        )

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.coo_matrix(
            (np.asarray(self.values, dtype=np.float64), (self.I, self.J)),
            shape=(self.n_rows, self.n_cols),
        )

    def astype(self, dtype) -> "MtxData":
        return dataclasses.replace(self, values=self.values.astype(dtype))

    def copy(self) -> "MtxData":
        return dataclasses.replace(
            self, I=self.I.copy(), J=self.J.copy(), values=self.values.copy()
        )

    def sort_by_row(self) -> "MtxData":
        """Stable sort of triplets by row (reference sort_perm,
        utilities.hpp:2139-2146,2269-2290)."""
        perm = np.argsort(self.I, kind="stable")
        return dataclasses.replace(
            self,
            I=self.I[perm],
            J=self.J[perm],
            values=self.values[perm],
            is_sorted=True,
        )

    def row_counts(self) -> np.ndarray:
        """int64 nonzeros per row, ``np.bincount(I, minlength=n_rows)``:
        counted by torch, which reads the int32 rows as they are where
        numpy first widens all of them to int64."""
        return torch.bincount(torch.from_numpy(self.I),
                              minlength=self.n_rows).numpy()

    def permute(self, perm: np.ndarray, inv_perm: np.ndarray) -> "MtxData":
        """Symmetric row+col permutation, ``perm[old] = new`` for rows and
        columns alike (mpi_funcs.hpp:494-598)."""
        perm = np.asarray(perm, dtype=np.int32)
        return dataclasses.replace(
            self,
            I=perm[self.I],
            J=perm[self.J],
            is_sorted=False,
        )

    def slice_rows(self, row_lo: int, row_hi: int) -> "MtxData":
        """Rows [row_lo, row_hi) with local row indices and global column
        indices (mpi_funcs.hpp:636-674, 862-877). Requires row-sorted
        input."""
        mask = (self.I >= row_lo) & (self.I < row_hi)
        return MtxData(
            n_rows=row_hi - row_lo,
            n_cols=self.n_cols,
            nnz=int(mask.sum()),
            is_sorted=self.is_sorted,
            is_symmetric=False,
            I=(self.I[mask] - row_lo).astype(np.int32),
            J=self.J[mask].astype(np.int32),
            values=self.values[mask],
        )


def split_heavy_rows(
    mtx: MtxData, threshold: int, row_counts: Optional[np.ndarray] = None
) -> Tuple[MtxData, Optional[np.ndarray]]:
    """Split rows with more than ``threshold`` nonzeros into virtual rows of
    at most ``threshold`` elements appended after the real rows.

    Extension beyond the reference: SELL-C-sigma pads every chunk to its
    longest row, so one power-law row inflates its whole C-row chunk, and
    one thread walks it alone; after splitting, row lengths are bounded.
    The caller adds the virtual rows' partial results back into their
    parent rows after each SpMV (ops/scs_pieces.py).

    Elements are ordered by (row, col) and cut into pieces of ``threshold``
    consecutive elements; piece 0 stays in the parent row, the rest become
    virtual rows, parent-ascending. Returns ``(mtx', parent)`` where
    ``mtx'`` has ``n_rows + n_virtual`` rows (columns untouched) and
    ``parent[v]`` is the real row of virtual row ``n_rows + v`` -- or
    ``(mtx, None)`` when nothing splits. Requires row-sorted input.
    ``row_counts``: ``mtx.row_counts()``, where the caller has them.
    """
    if not mtx.is_sorted:
        raise ValueError("split_heavy_rows requires row-sorted input")
    counts = mtx.row_counts() if row_counts is None else row_counts
    if not (counts > threshold).any():
        return mtx, None
    order = np.lexsort((mtx.J, mtx.I))
    mtx = dataclasses.replace(
        mtx, I=mtx.I[order], J=mtx.J[order], values=mtx.values[order]
    )
    # occurrence index k of each element within its row
    starts = np.concatenate(([0], np.cumsum(counts)))
    k = np.arange(mtx.nnz, dtype=np.int64) - starts[mtx.I]
    piece = k // threshold
    n_pieces = (counts + threshold - 1) // threshold
    n_virt_per_row = np.maximum(n_pieces - 1, 0)
    virt_base = mtx.n_rows + np.concatenate(
        ([0], np.cumsum(n_virt_per_row[:-1]))
    )
    new_I = np.where(
        piece == 0, mtx.I.astype(np.int64), virt_base[mtx.I] + piece - 1
    )
    parent = np.repeat(
        np.arange(mtx.n_rows, dtype=np.int32), n_virt_per_row
    )
    out = MtxData(
        n_rows=mtx.n_rows + int(n_virt_per_row.sum()),
        n_cols=mtx.n_cols,
        nnz=mtx.nnz,
        is_sorted=False,
        is_symmetric=False,
        I=new_I.astype(np.int32),
        J=mtx.J.copy(),
        values=mtx.values.copy(),
    ).sort_by_row()
    return out, parent


# ---------------------------------------------------------------------------
# Permutation helpers (reference utilities.hpp:1755-1831)
# ---------------------------------------------------------------------------


def generate_inv_perm(perm: np.ndarray) -> np.ndarray:
    """inv_perm[perm[i]] = i (reference generate_inv_perm)."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return inv


def apply_permutation(vec: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """permuted[i] = vec[perm[i]] (reference apply_permutation,
    utilities.hpp:1768-1781)."""
    return np.asarray(vec)[np.asarray(perm)]


def apply_strided_permutation(
    vec: np.ndarray, perm: np.ndarray, stride: int
) -> np.ndarray:
    """Permute a row-major block vector of row-stride ``stride``: its first
    ``perm.size`` rows of ``stride`` values go to row order ``perm``, the
    rest stay (reference apply_strided_permutation,
    utilities.hpp:1783-1799)."""
    vec = np.asarray(vec)
    n = perm.size
    out = vec.copy()
    rows = vec[: n * stride].reshape(n, stride)
    out[: n * stride] = rows[np.asarray(perm)].reshape(-1)
    return out


# ---------------------------------------------------------------------------
# Equilibration and Jacobi scaling (reference utilities.hpp:2605-2684)
# ---------------------------------------------------------------------------


def extract_largest_row_elems(mtx: MtxData) -> np.ndarray:
    """Per-row max |a_ij| (reference extract_largest_row_elems)."""
    out = np.zeros(mtx.n_rows, dtype=np.float64)
    np.maximum.at(out, mtx.I, np.abs(mtx.values.astype(np.float64)))
    return out


def extract_largest_col_elems(mtx: MtxData) -> np.ndarray:
    """Per-column max |a_ij| (reference extract_largest_col_elems)."""
    out = np.zeros(mtx.n_cols, dtype=np.float64)
    np.maximum.at(out, mtx.J, np.abs(mtx.values.astype(np.float64)))
    return out


def scale_matrix_rows(mtx: MtxData, largest_row_elems: np.ndarray) -> None:
    """a_ij /= largest_row_elems[i], in place, in the values' dtype."""
    mtx.values = (
        mtx.values / largest_row_elems[mtx.I].astype(mtx.values.dtype)
    ).astype(mtx.values.dtype)


def scale_matrix_cols(mtx: MtxData, largest_col_elems: np.ndarray) -> None:
    """a_ij /= largest_col_elems[j], in place, in the values' dtype."""
    mtx.values = (
        mtx.values / largest_col_elems[mtx.J].astype(mtx.values.dtype)
    ).astype(mtx.values.dtype)


def equilibrate_matrix(mtx: MtxData) -> Tuple[np.ndarray, np.ndarray]:
    """Row-scale by per-row max |a|, then col-scale the row-scaled matrix by
    its per-col max |a| (reference order, utilities.hpp:2670-2684). Returns
    (largest_row_elems, largest_col_elems) for the adaptive-precision
    partitioner."""
    lr = extract_largest_row_elems(mtx)
    scale_matrix_rows(mtx, lr)
    lc = extract_largest_col_elems(mtx)
    scale_matrix_cols(mtx, lc)
    return lr, lc


def jacobi_scale_matrix(mtx: MtxData) -> np.ndarray:
    """Scale each row by its diagonal element, in place (reference
    jacobi_scale flag, classes_structs.hpp:57). Returns the diagonal."""
    diag = np.zeros(mtx.n_rows, dtype=np.float64)
    on_diag = mtx.I == mtx.J
    diag[mtx.I[on_diag]] = mtx.values[on_diag].astype(np.float64)
    if np.any(diag == 0.0):
        raise ValueError("jacobi_scale: matrix has zero diagonal entries")
    mtx.values = (mtx.values / diag[mtx.I].astype(mtx.values.dtype)).astype(
        mtx.values.dtype
    )
    return diag


# values per block of ``extract_matrix_min_mean_max``: |a| of a block stays
# in cache, and no array of the matrix's size is made
STATS_BLOCK = 1 << 20


def extract_matrix_min_mean_max(mtx: MtxData) -> Tuple[float, float, float]:
    """(min|a|, midpoint, max|a|) — 'mean' is the min/max midpoint, not
    the average (reference extract_matrix_min_mean_max,
    utilities.hpp:2501-2540). |a| of float values is exact in their own
    dtype, so it is taken there, a block at a time."""
    v = mtx.values
    if v.dtype.kind != "f":
        v = v.astype(np.float64)
    if not v.size:
        return 0.0, 0.0, 0.0
    lows, highs = [], []
    for s in range(0, v.size, STATS_BLOCK):
        a = np.abs(v[s:s + STATS_BLOCK])
        lows.append(a.min())
        highs.append(a.max())
    mn, mx = float(np.min(lows)), float(np.max(highs))
    return mn, mn + (mx - mn) / 2.0, mx
