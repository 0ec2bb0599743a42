"""Padding-free SpMV / SpMMV over packed row groups: the CUDA kernel's
wrapper and its plain version.

Port of ``spmv_mixed_tiles`` (uspmv_tpu/ops/pallas_scs.py). The TPU's mixed
tiles let many short rows share one dense tile so that the stream carries
little padding; ``DevicePacked`` (ops/device_format.py) stores no padding at
all, and one thread block per row group routes the products to their rows
through shared memory (csrc/scs_packed.cu).

``spmv_packed`` has the contract of ``ops.scs_spmv.spmv_scs``: it returns
y = A x in the permuted, padded row order; with ``y`` given it adds A x into
y in place; with ``out`` given it writes A x into the caller's buffer. For
CUDA tensors it launches the kernel, for CPU tensors it runs
``spmv_packed_plain``; a failure to build or launch raises.

(values, x) dtype pairs: (f64, f64), (f32, f32), (bf16, f32): dp, sp and hp.
The adaptive-precision streams do not take this tier, as in the JAX
operator. x layouts: one vector [n_pad]; rowwise block vectors [n_pad, bs],
one launch that makes one pass per column inside each block (the group's
values and columns come from L1/L2 after the first, so the matrix bytes are
counted once); colwise block vectors [bs, n_pad], one launch with one matrix
pass per vector.

The kernel rounds each product and then sums (two roundings), as the plain
version does, where the SELL-C-sigma kernel contracts to FMAs. Kernel and
plain version differ only in the order of the sum within a row when
``index_add_`` runs on a GPU (atomics), and not at all on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import scs_spmv
from .device_format import DevicePacked
from .scs_spmv import MAX_VECTORS, book_launch, check_args, out_shape

# (value dtype, x dtype) -> entry point of csrc/scs_packed.cu
_ENTRY_POINTS = {
    (torch.float64, torch.float64): "uspmv_scs_packed_f64_f64",
    (torch.float32, torch.float32): "uspmv_scs_packed_f32_f32",
    (torch.bfloat16, torch.float32): "uspmv_scs_packed_bf16_f32",
}
_ARGTYPES = (
    [ctypes.c_int64] + [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2
    + [ctypes.c_void_p] + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3
    + [ctypes.c_void_p]
)

_launches: Dict[str, int] = {name: 0 for name in _ENTRY_POINTS.values()}
_lib = None


def launch_count() -> int:
    """Kernel launches made by ``spmv_packed`` in this process."""
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
            f"no packed-row kernel for {value_dtype} values with {x_dtype} "
            f"x; supported (values, x) dtype pairs: {list(_ENTRY_POINTS)}"
        ) from None


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


def spmv_packed_plain(dev: DevicePacked, x: torch.Tensor,
                      layout: str = "rowwise",
                      y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: gather x[col_idxs], multiply by the values
    widened to x's dtype, ``index_add_`` by each element's permuted row.
    With ``y`` given, adds the product into it in place and returns it."""
    vals = dev.values.to(x.dtype)
    part = torch.zeros(out_shape(dev, x, layout), dtype=x.dtype,
                       device=x.device)
    if x.dim() == 1 or layout == "rowwise":
        xg = x.index_select(0, dev.col_idxs)
        prod = (vals if x.dim() == 1 else vals[:, None]) * xg
        part.index_add_(0, dev.row_idxs, prod)
    else:  # colwise [bs, n_pad]
        part.index_add_(1, dev.row_idxs,
                        vals[None, :] * x.index_select(1, dev.col_idxs))
    if y is None:
        return part
    return y.add_(part)


def spmv_packed(dev: DevicePacked, x: torch.Tensor, layout: str = "rowwise",
                y: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A x for x in the permuted, padded layout ([n_pad], rowwise
    [n_pad, bs] or colwise [bs, n_pad]); with ``y`` given, y += A x in
    place; with ``out`` given, out = A x written into the caller's buffer
    (which must not be x). Returns y in x's dtype."""
    if y is not None and out is not None:
        raise ValueError("give y (accumulate into) or out (write to), not both")
    name = entry_point(dev.values.dtype, x.dtype)
    check_args(dev, x, layout, y if out is None else out)
    if out is not None and out.data_ptr() == x.data_ptr():
        raise ValueError("out must not be x: rows read x while others write")
    if x.device.type == "cpu":
        if out is not None:
            return out.copy_(spmv_packed_plain(dev, x, layout))
        return spmv_packed_plain(dev, x, layout, y)
    if x.device.type != "cuda":
        raise ValueError(
            f"spmv_packed runs on cuda or cpu tensors, not {x.device}")
    accumulate = y is not None
    if out is not None:
        y = out
    index_tensors = (dev.group_ptr, dev.row_ptr, dev.col_idxs)
    if not all(t.is_contiguous() for t in (*index_tensors, dev.values, x)) or (
        y is not None and not y.is_contiguous()
    ):
        raise ValueError("spmv_packed needs contiguous tensors")
    if any(t.dtype != torch.int32 for t in index_tensors):
        raise TypeError("group_ptr, row_ptr and col_idxs must be int32")
    if y is None:
        y = torch.empty(out_shape(dev, x, layout), dtype=x.dtype,
                        device=x.device)
    if x.dim() == 1:
        strides, ncols, n_vec = (1, 0, 1, 0), 1, 1
    elif layout == "colwise":
        strides, ncols, n_vec = (1, x.shape[1], 1, dev.n_rows_padded), 1, \
            x.shape[0]
        if n_vec > MAX_VECTORS:
            raise ValueError(
                f"colwise block vectors take at most {MAX_VECTORS} vectors "
                f"in one launch, not {n_vec}"
            )
    else:
        strides, ncols, n_vec = (x.shape[1], 0, x.shape[1], 0), x.shape[1], 1
    x_ld, x_vstride, y_ld, y_vstride = strides
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        rc = getattr(lib, name)(
            dev.n_groups, dev.group_ptr.data_ptr(), dev.row_ptr.data_ptr(),
            dev.col_idxs.data_ptr(), dev.values.data_ptr(),
            x.data_ptr(), x_ld, x_vstride, y.data_ptr(), y_ld, y_vstride,
            ncols, n_vec, int(accumulate),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    book_launch(lib, rc, name, _launches)
    return y
