"""Adaptive-precision nonzero partitioning.

Port of ``uspmv_tpu/precision/partition.py`` (reference
``partition_precisions``, utilities.hpp:2810-3123): split a COO matrix's
nonzeros into dp/sp/hp sub-matrices by magnitude thresholds, so that a
small element is stored and multiplied in a cheaper precision while the
sum stays in the highest precision in play.

  * ap[dp_sp], ap[dp_hp], ap[sp_hp]: |a| >= th1 -> the first precision,
    else the second;
  * ap[dp_sp_hp] with 0 <= th2 <= th1: |a| >= th1 -> dp,
    th2 <= |a| < th1 -> sp, |a| < th2 -> hp;
  * with -equilibrate the test threshold of element (i, j) is
    th / (largest_col_elems[j] * largest_row_elems[i]);
  * dropout (an extension of the JAX package; the reference parses the
    flag only) drops |a| < dropout_threshold before bucketing.

Every output array is bit-equal to the JAX package's; hp values are
float32 arrays of bf16-rounded values (``config.host_values``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..config import host_values
from ..formats.coo import MtxData

# machine epsilon of float32 over 2, as in the reference's threshold recipe
_HALF_EPS_SP = 0.5 * 2.0**-23

_SPLITS = (("dp", "sp"), ("dp", "hp"), ("sp", "hp"), ("dp", "sp", "hp"))


def ap_threshold_from_norm(mtx: MtxData, tol: float) -> float:
    """Threshold recipe of the reference's scripts/get_buckets.py:
    th = tol * ||A||_inf / (0.5 * 2^-23)."""
    rowsums = np.zeros(mtx.n_rows, dtype=np.float64)
    np.add.at(rowsums, mtx.I, np.abs(mtx.values.astype(np.float64)))
    norm_inf = float(rowsums.max()) if rowsums.size else 0.0
    return tol * norm_inf / _HALF_EPS_SP


def _bucket_masks(
    absvals: np.ndarray,
    precisions: Tuple[str, ...],
    th1,
    th2,
) -> Dict[str, np.ndarray]:
    """Boolean mask per precision, highest precision first; th1/th2 are
    scalars or per-element arrays (equilibrated thresholds)."""
    if len(precisions) == 2:
        hi = absvals >= th1
        return {precisions[0]: hi, precisions[1]: ~hi}
    dp = absvals >= th1
    hp = absvals < th2
    return {"dp": dp, "sp": ~dp & ~hp, "hp": hp}


def partition_precisions(
    mtx: MtxData,
    value_type: str,
    ap_threshold_1: float,
    ap_threshold_2: float = 0.0,
    equilibrate: bool = False,
    largest_row_elems: Optional[np.ndarray] = None,
    largest_col_elems: Optional[np.ndarray] = None,
    dropout: bool = False,
    dropout_threshold: float = 0.0,
) -> Tuple[Dict[str, MtxData], int]:
    """Split ``mtx`` into per-precision COO sub-matrices.

    Returns ``(sub_matrices, n_dropped)``: precision name -> MtxData with
    values in that precision (``host_values``), highest precision first.
    Every sub-matrix keeps the full (n_rows, n_cols) shape so that all can
    share one row permutation (reference main.cpp:1170-1221).
    """
    if not (value_type.startswith("ap[") and value_type.endswith("]")):
        raise ValueError(f"not an adaptive value type: {value_type!r}")
    precisions = tuple(value_type[3:-1].split("_"))
    if precisions not in _SPLITS:
        raise ValueError(f"unknown adaptive split {value_type!r}")
    if len(precisions) == 3 and not (0 <= ap_threshold_2 <= ap_threshold_1):
        raise ValueError("need 0 <= ap_threshold_2 <= ap_threshold_1")

    absvals = np.abs(mtx.values.astype(np.float64))
    th1, th2, th_drop = ap_threshold_1, ap_threshold_2, dropout_threshold
    if equilibrate:
        if largest_row_elems is None or largest_col_elems is None:
            raise ValueError(
                "equilibrated partitioning needs largest_row/col_elems "
                "(from equilibrate_matrix)"
            )
        scale = (
            largest_col_elems[mtx.J].astype(np.float64)
            * largest_row_elems[mtx.I].astype(np.float64)
        )
        th1, th2, th_drop = th1 / scale, th2 / scale, th_drop / scale

    keep = np.ones(mtx.nnz, dtype=bool)
    n_dropped = 0
    if dropout:
        keep = absvals >= th_drop
        n_dropped = int((~keep).sum())

    masks = _bucket_masks(absvals, precisions, th1, th2)
    subs: Dict[str, MtxData] = {}
    for prec in precisions:
        m = masks[prec] & keep
        subs[prec] = MtxData(
            n_rows=mtx.n_rows,
            n_cols=mtx.n_cols,
            nnz=int(m.sum()),
            is_sorted=mtx.is_sorted,
            is_symmetric=mtx.is_symmetric,
            I=mtx.I[m],
            J=mtx.J[m],
            values=host_values(mtx.values[m], prec),
        )

    # element-count conservation (reference utilities.hpp:2922-2926)
    lost = mtx.nnz - n_dropped - sum(s.nnz for s in subs.values())
    if lost:
        raise AssertionError(f"partition_precisions lost elements: {lost}")
    return subs, n_dropped
