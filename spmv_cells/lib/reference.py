"""The plain reference: y = A x in float64, from the benchmark's own matrix
and x, and the number that decides ``correct``.

It re-implements the oracle of ``uspmv_tpu_torch/runtime/validate.py`` (at
commit 49643eb: scipy CSR in float64) and
imports numpy and scipy only: nothing of the program, nor of the JAX
package. The program's permutations, conversions and partitions need no
counterpart here: the reference works in the original row order, and the
program's result is brought back to it by its ``to_host``.

``max_err``: per vector, max_i |y_i - ref_i| / max_i |ref_i|, the largest
over the vectors; inf where y holds a value that is not finite. It is
scale-free, and an element near 0 cannot blow it up the way an
element-wise relative error does.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def csr(n_rows: int, n_cols: int, I: np.ndarray, J: np.ndarray,
        V: np.ndarray, dtype=np.float64) -> sp.csr_matrix:
    """The CSR matrix of COO arrays whose rows are sorted."""
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(I, minlength=n_rows), out=indptr[1:])
    return sp.csr_matrix((np.asarray(V, dtype=dtype), J, indptr),
                         shape=(n_rows, n_cols))


def spmv(A: sp.csr_matrix, x: np.ndarray) -> np.ndarray:
    return A @ np.asarray(x, dtype=A.dtype)


def max_err(y: np.ndarray, ref: np.ndarray) -> float:
    """The largest over the vectors of max |y - ref| / max |ref|; inf where
    y is not finite or its shape is not ref's."""
    y = np.asarray(y, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if y.shape != ref.shape or not np.isfinite(y).all():
        return float("inf")
    if ref.ndim == 1:
        y, ref = y[:, None], ref[:, None]
    scale = np.abs(ref).max(axis=0)
    scale[scale == 0] = 1.0
    return float((np.abs(y - ref).max(axis=0) / scale).max())
