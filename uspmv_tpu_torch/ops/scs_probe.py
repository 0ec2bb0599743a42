"""Cost split of the SELL-C-sigma kernel: the variants of ``csrc/scs_probe.cu``
and their plain versions.

Port of the TPU probe ``scripts/pallas_tile_cost.py`` of the JAX package.
``probe_scs(dev, x, variant)`` runs one variant of the SpMV row loop on an
f32 ``DeviceScs`` and one f32 vector in the permuted, padded layout and
returns ``(y, stored)``:

    full      y = A x through spmv_scs's own kernel launch
    x_window  y[r] = sum_j val * x[col & (W-1)], W = ``x_window(len(x))``
    no_store  the sums of full, written to y only for rows whose sum
              exceeds ``store_above``; ``stored`` counts those rows
    no_x      y[r] = sum_j val * float(col)
    bare      no_x's sums, stored as no_store stores them
    x_row     y[r] = sum_j val * x[r], the load still behind the column's
              (the kernel reads x[r ^ (col >> 31)]; every column is >= 0)

``store_above`` defaults to -inf, which stores every finite sum, so no_store
and bare can be held against their plain versions; +inf stores none, the
form they are timed in. ``y`` is a zero vector unless the caller passes one
(``y=``); the other variants leave ``stored`` at 0. For CUDA tensors the
wrapper launches the kernel; for CPU tensors it runs the plain version. A
failed launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import scs_spmv
from .device_format import DeviceScs

VARIANTS = ("full", "x_window", "no_store", "no_x", "bare", "x_row")
THRESHOLDED = ("no_store", "bare")  # the variants that take store_above
WINDOW = 4096  # the largest x window of x_window, in elements
_ENTRY = "uspmv_scs_probe"
_ARGTYPES = ([ctypes.c_int, ctypes.c_int64, ctypes.c_int]
             + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_float]
             + [ctypes.c_void_p] * 3)

_launches: Dict[str, int] = {f"{_ENTRY}_{v}": 0 for v in VARIANTS}
_lib = None


def launch_counts() -> Dict[str, int]:
    """Kernel launches per variant (``uspmv_scs_probe_<variant>``)."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


def x_window(n: int) -> int:
    """W of the x_window variant for an x of n elements: the largest power
    of two <= min(n, WINDOW)."""
    return 1 << (min(int(n), WINDOW).bit_length() - 1)


def _check(dev: DeviceScs, x: torch.Tensor, variant: str,
           y: Optional[torch.Tensor]) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    if dev.unit_vals or dev.values.dtype != torch.float32:
        raise TypeError("the cost variants take an f32 DeviceScs with values")
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"x must be one float32 vector, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if x.numel() < max(dev.x_len, 1) or (variant == "x_row"
                                         and x.numel() < dev.n_rows_padded):
        raise ValueError(f"x of {x.numel()} elements is too short for this "
                         f"matrix (x_len {dev.x_len}, {dev.n_rows_padded} "
                         "padded rows)")
    if x.device != dev.device:
        raise ValueError(f"x is on {x.device}, the matrix on {dev.device}")
    if y is not None and (y.dtype != torch.float32
                          or tuple(y.shape) != (dev.n_rows_padded,)
                          or y.device != x.device):
        raise ValueError(f"y must be float32 of shape ({dev.n_rows_padded},) "
                         f"on {x.device}")


def probe_plain(dev: DeviceScs, x: torch.Tensor, variant: str,
                y: Optional[torch.Tensor] = None,
                store_above: float = -math.inf
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the variant's per-element factor times the
    values, ``index_add_`` over each element's permuted row. Returns
    (y, stored), stored a one-element int32 tensor."""
    _check(dev, x, variant, y)
    cols = dev.col_idxs.long()
    if variant in ("full", "no_store"):
        g = x.index_select(0, cols)
    elif variant == "x_window":
        g = x.index_select(0, cols & (x_window(x.numel()) - 1))
    elif variant in ("no_x", "bare"):
        g = dev.col_idxs.to(torch.float32)
    else:  # x_row
        g = x.index_select(0, dev.row_idxs.long())
    sums = torch.zeros(dev.n_rows_padded, dtype=torch.float32,
                       device=x.device).index_add_(0, dev.row_idxs,
                                                   dev.values * g)
    if y is None:
        y = torch.zeros_like(sums)
    if variant in THRESHOLDED:
        keep = sums > store_above
        return (torch.where(keep, sums, y),
                keep.sum().to(torch.int32).reshape(1))
    return sums, torch.zeros(1, dtype=torch.int32, device=x.device)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = scs_spmv._kernel_lib()  # one library; binds the error string
        fn = getattr(lib, _ENTRY)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def probe_scs(dev: DeviceScs, x: torch.Tensor, variant: str,
              y: Optional[torch.Tensor] = None,
              stored: Optional[torch.Tensor] = None,
              store_above: float = -math.inf
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cost variant of the SpMV row loop. ``y``: the vector the kernel
    writes (default a new zero vector); ``stored``: a one-element int32
    counter that no_store and bare add their stored rows to (default a new
    zero); ``store_above``: their threshold. Returns (y, stored)."""
    _check(dev, x, variant, y)
    if x.device.type == "cpu":
        y_new, count = probe_plain(dev, x, variant, y, store_above)
        if y is not None:
            y.copy_(y_new)
            y_new = y
        if stored is not None:
            count = stored.add_(count)
        return y_new, count
    if x.device.type != "cuda":
        raise ValueError(f"probe_scs runs on cuda or cpu tensors, not {x.device}")
    tensors = (dev.chunk_ptrs, dev.chunk_lengths, dev.col_idxs, dev.values, x)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("probe_scs needs contiguous tensors")
    if y is None:
        y = torch.zeros(dev.n_rows_padded, dtype=torch.float32,
                        device=x.device)
    if stored is None:
        stored = torch.zeros(1, dtype=torch.int32, device=x.device)
    elif stored.dtype != torch.int32 or stored.device != x.device:
        raise ValueError("stored must be an int32 tensor on x's device")
    lib = _kernel_lib()
    name = f"{_ENTRY}_{variant}"
    with torch.cuda.device(x.device):
        rc = getattr(lib, _ENTRY)(
            VARIANTS.index(variant), dev.n_rows_padded, dev.C,
            dev.chunk_ptrs.data_ptr(), dev.chunk_lengths.data_ptr(),
            dev.col_idxs.data_ptr(), dev.values.data_ptr(), x.data_ptr(),
            x_window(x.numel()) - 1, float(store_above), y.data_ptr(),
            stored.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        )
    scs_spmv.book_launch(lib, rc, name, _launches)
    return y, stored
