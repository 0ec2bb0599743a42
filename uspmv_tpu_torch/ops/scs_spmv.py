"""SELL-C-sigma SpMV: the CUDA kernel's wrapper and its plain version.

Port of ``spmv_lane_tiles`` / ``spmv_pallas`` (uspmv_tpu/ops/pallas_scs.py).
``spmv_scs(dev, x)`` returns y = A x in the permuted, padded row order, the
same y that ``spmv_lane_tiles`` returns for the same matrix. For CUDA
tensors it launches the hand-written kernel of ``csrc/scs_spmv.cu``; for
CPU tensors it runs ``spmv_scs_plain``. Any failure to build or launch the
kernel raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .device_format import DeviceScs

_ENTRY_POINTS = {
    torch.float32: "uspmv_scs_spmv_f32",
    torch.float64: "uspmv_scs_spmv_f64",
}
_ARGTYPES = [ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 7

_launches = 0
_lib = None


def launch_count() -> int:
    """Kernel launches made by ``spmv_scs`` in this process."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library().lib
        for name in _ENTRY_POINTS.values():
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.uspmv_cuda_error_string.argtypes = [ctypes.c_int]
        lib.uspmv_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_args(dev: DeviceScs, x: torch.Tensor) -> None:
    if x.dtype != dev.values.dtype:
        raise TypeError(
            f"x has dtype {x.dtype}, the matrix values {dev.values.dtype}"
        )
    if x.dim() != 1 or x.shape[0] < dev.x_len:
        raise ValueError(
            f"x must be 1-D with at least {dev.x_len} entries (the largest "
            f"column index + 1); got shape {tuple(x.shape)}"
        )
    if x.device != dev.device:
        raise ValueError(
            f"x is on {x.device}, the matrix on {dev.device}"
        )


def spmv_scs_plain(dev: DeviceScs, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather x[col_idxs] * values, then
    ``index_add_`` over each flat element's permuted row (like
    uspmv_tpu/ops/spmv_xla.spmv_flat). Padding elements add 0 * x[0]."""
    y = torch.zeros(dev.n_rows_padded, dtype=x.dtype, device=x.device)
    prod = dev.values * x.index_select(0, dev.col_idxs)
    return y.index_add_(0, dev.row_idxs, prod)


def spmv_scs(dev: DeviceScs, x: torch.Tensor) -> torch.Tensor:
    """y[n_rows_padded] = A x for x in the permuted, padded layout."""
    global _launches
    _check_args(dev, x)
    if x.device.type == "cpu":
        return spmv_scs_plain(dev, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmv_scs runs on cuda or cpu tensors, not {x.device}")
    if x.dtype not in _ENTRY_POINTS:
        raise TypeError(f"the CUDA kernel takes float32 or float64, not {x.dtype}")
    tensors = (dev.chunk_ptrs, dev.chunk_lengths, dev.col_idxs, dev.values, x)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("spmv_scs needs contiguous tensors")
    if not (dev.chunk_ptrs.dtype == dev.chunk_lengths.dtype
            == dev.col_idxs.dtype == torch.int32):
        raise TypeError("chunk_ptrs, chunk_lengths and col_idxs must be int32")
    lib = _kernel_lib()
    y = torch.empty(dev.n_rows_padded, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, _ENTRY_POINTS[x.dtype])(
            dev.n_rows_padded, dev.C,
            dev.chunk_ptrs.data_ptr(), dev.chunk_lengths.data_ptr(),
            dev.col_idxs.data_ptr(), dev.values.data_ptr(),
            x.data_ptr(), y.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.uspmv_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"scs_spmv kernel launch failed: {msg} (cudaError {rc})")
    _launches += 1
    return y
