"""Fused solve: k iterations of y = A x; x <- y in one kernel launch.

Port of ``solve_lane_tiles`` / ``solve_tiles_fit``
(uspmv_tpu/ops/pallas_scs.py). ``solve_scs(dev, x, k)`` returns
``(A^(k-1) x, A^k x)`` in the permuted, padded layout of x, the contract of
``SpmvOperator.solve``. For CUDA tensors it launches the persistent
cooperative kernel of ``csrc/scs_solve.cu`` once; for CPU tensors it runs
``solve_scs_plain``, k calls of the plain SpMV with a swap. Any failure to
build or launch the kernel raises, and so does a shape the kernel does not
take.

The kernel takes one precision stream, with (values, x) dtypes (f64, f64),
(f32, f32) or (bf16, f32), and one vector [n_pad] or rowwise block vectors
[n_pad, bs] with bs <= 8. ``solve_fits`` says whether that holds;
colwise block vectors, bs > 8 and adaptive-precision sums go through k
launches of the SpMV kernel (``SpmvOperator.solve`` with impl "loop" or
"graph"). Its row sums are the SpMV kernel's own code, so its result
equals k launches of that kernel bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import scs_spmv
from .device_format import VECTORS_PER_PASS, DeviceScs
from .scs_spmv import (
    LAYOUTS,
    check_matrix_tensors,
    matrix_args,
    spmv_scs_plain,
)

# (value dtype, x dtype) -> entry point of csrc/scs_solve.cu
_ENTRY_POINTS = {
    (torch.float64, torch.float64): "uspmv_scs_solve_f64_f64",
    (torch.float32, torch.float32): "uspmv_scs_solve_f32_f32",
    (torch.bfloat16, torch.float32): "uspmv_scs_solve_bf16_f32",
}
# the matrix as csrc/scs_spmv.cu takes it (scs_spmv.matrix_args), x0,
# buf0, buf1, ld, ncols, k, stream
_ARGTYPES = (
    [ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    + [ctypes.c_void_p] * 5
    + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)

_launches: Dict[str, int] = {name: 0 for name in _ENTRY_POINTS.values()}
_lib = None


def launch_count() -> int:
    """Kernel launches made by ``solve_scs`` in this process: one per
    solve, whatever k."""
    return sum(_launches.values())


def launch_counts() -> Dict[str, int]:
    """Kernel launches per instantiation (entry point name)."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


def entry_point(value_dtype: torch.dtype, x_dtype: torch.dtype) -> str:
    """The kernel instantiation for a (values, x) dtype pair; raises for a
    pair it does not take."""
    try:
        return _ENTRY_POINTS[(value_dtype, x_dtype)]
    except KeyError:
        raise TypeError(
            f"no fused solve kernel for {value_dtype} values with {x_dtype} "
            f"x; supported (values, x) dtype pairs: {list(_ENTRY_POINTS)}"
        ) from None


def solve_fits(dev: DeviceScs, x_shape: Tuple[int, ...], x_dtype: torch.dtype,
               layout: str = "rowwise") -> bool:
    """Whether the fused kernel takes this matrix stream with an x of this
    shape, dtype and layout (the counterpart of ``solve_tiles_fit``, which
    refuses a unit-value stream too)."""
    if dev.unit_vals or (dev.values.dtype, x_dtype) not in _ENTRY_POINTS:
        return False
    if dev.x_len > dev.n_rows_padded:  # y must be a valid next x
        return False
    if len(x_shape) == 1:
        return x_shape[0] == dev.n_rows_padded
    return (len(x_shape) == 2 and layout == "rowwise"
            and x_shape[0] == dev.n_rows_padded
            and 1 <= x_shape[1] <= VECTORS_PER_PASS)


def _check_args(dev: DeviceScs, x: torch.Tensor, k: int, layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, not {layout!r}")
    if int(k) < 1:
        raise ValueError(f"solve_scs needs k >= 1 iterations, not {k}")
    if dev.unit_vals:
        raise ValueError("the fused solve kernel takes no unit-value stream")
    entry_point(dev.values.dtype, x.dtype)
    if x.device != dev.device:
        raise ValueError(f"x is on {x.device}, the matrix on {dev.device}")
    if not solve_fits(dev, tuple(x.shape), x.dtype, layout):
        raise ValueError(
            "the fused solve kernel takes one vector "
            f"[{dev.n_rows_padded}] or rowwise block vectors "
            f"[{dev.n_rows_padded}, bs <= {VECTORS_PER_PASS}] of a square "
            f"operator; got shape {tuple(x.shape)} in the {layout} layout "
            f"(largest column index + 1 = {dev.x_len})"
        )


def solve_scs_plain(dev: DeviceScs, x: torch.Tensor, k: int,
                    layout: str = "rowwise") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: k calls of ``spmv_scs_plain`` with a swap.
    Returns (A^(k-1) x, A^k x); for k == 1 the first is x itself."""
    prev = x
    for _ in range(int(k)):
        prev, x = x, spmv_scs_plain(dev, x, layout)
    return prev, x


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = scs_spmv._kernel_lib()  # one library; binds the error string
        for name in _ENTRY_POINTS.values():
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def solve_scs(dev: DeviceScs, x: torch.Tensor, k: int,
              layout: str = "rowwise") -> Tuple[torch.Tensor, torch.Tensor]:
    """k iterations of y = A x; x <- y for x in the permuted, padded layout
    ([n_pad] or rowwise [n_pad, bs <= 8]). Returns (A^(k-1) x, A^k x) in
    x's dtype; x is only read (for k == 1 the first result is x itself)."""
    _check_args(dev, x, k, layout)
    k = int(k)
    if x.device.type == "cpu":
        return solve_scs_plain(dev, x, k, layout)
    if x.device.type != "cuda":
        raise ValueError(f"solve_scs runs on cuda or cpu tensors, not {x.device}")
    name = entry_point(dev.values.dtype, x.dtype)
    check_matrix_tensors(dev, "solve_scs")
    if not x.is_contiguous():
        raise ValueError("solve_scs needs contiguous tensors")
    bufs = (torch.empty_like(x), torch.empty_like(x))
    bs = 1 if x.dim() == 1 else x.shape[1]
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        rc = getattr(lib, name)(
            *matrix_args(dev), x.data_ptr(), bufs[0].data_ptr(),
            bufs[1].data_ptr(), bs, bs, k,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.uspmv_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(
            f"scs_solve kernel {name} launch failed: {msg} (cudaError {rc})"
        )
    _launches[name] += 1
    # iteration it writes bufs[it & 1]
    prev = x if k == 1 else bufs[k & 1]
    return prev, bufs[(k - 1) & 1]
