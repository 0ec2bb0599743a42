"""Dense vector construction and permutation (host side).

Port of ``uspmv_tpu/ops/vectors.py`` (reference SimpleDenseMatrix/
DenseMatrix + init helpers, utilities.hpp:880-981, 2311-2499). Host arrays
are numpy; the operator moves the device layout onto its torch device.

Layouts (reference Makefile:17-31):
  rowwise : x[row, vec]  — shape [n_pad, bs]
  colwise : x[vec, row]  — shape [bs, n_pad]
Single vectors (bs=1) are plain [n_pad].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import Config, DefaultValues


def init_x_host(
    config: Config,
    n_rows: int,
    matrix_stats: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    x_in: Optional[np.ndarray] = None,
    dtype=np.float64,
) -> np.ndarray:
    """Unpermuted, unpadded x in logical [n_rows, bs] shape (bs dropped if 1).

    init modes (reference -rand_x '0'|'1'|'m', utilities.hpp:915-981):
      default      -> DefaultValues.x (5.0)
      random_init_x-> uniform(matrix_min, matrix_max), seeded
      mean_init_x  -> the matrix |value| min/max midpoint
    """
    bs = config.block_vec_size
    shape = (n_rows, bs) if bs > 1 else (n_rows,)
    if x_in is not None:
        x = np.asarray(x_in, dtype=dtype).reshape(shape)
    elif config.random_init_x:
        mn, _, mx = matrix_stats
        rng = np.random.default_rng(config.seed)
        x = rng.uniform(mn, mx, size=shape).astype(dtype)
    elif config.mean_init_x:
        x = np.full(shape, matrix_stats[1], dtype=dtype)
    else:
        x = np.full(shape, DefaultValues().x, dtype=dtype)
    return x


def to_device_layout(
    x: np.ndarray, layout: str, n_pad: int, old_to_new: np.ndarray
) -> np.ndarray:
    """[n_rows(, bs)] host vector -> padded, row-permuted device layout.

    device[old_to_new[o]] = host[o]; padded slots are zero (reference
    zero-fills halo/padding rows, utilities.hpp:957-981).
    """
    if x.ndim == 1:
        out = np.zeros(n_pad, dtype=x.dtype)
        out[old_to_new] = x
        return out
    bs = x.shape[1]
    out = np.zeros((n_pad, bs), dtype=x.dtype)
    out[old_to_new] = x
    if layout == "colwise":
        return np.ascontiguousarray(out.T)  # [bs, n_pad]
    return out  # rowwise [n_pad, bs]


def from_device_layout(
    y: np.ndarray, layout: str, old_to_new: np.ndarray
) -> np.ndarray:
    """Device layout -> host [n_rows(, bs)], un-permuted (reference
    copy_back_result, utilities.hpp:3817-3994)."""
    y = np.asarray(y)
    if y.ndim == 1:
        return y[old_to_new]
    if layout == "colwise":
        y = y.T  # [n_pad, bs]
    return y[old_to_new]
