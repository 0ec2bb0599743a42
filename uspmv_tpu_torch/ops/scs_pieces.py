"""Heavy-row pieces: the CUDA kernel's wrapper and its plain version.

Port of ``spmv_product_tiles`` and ``spmv_product_tiles_t``
(uspmv_tpu/ops/pallas_scs.py) together with the fold of split rows that
follows them in the JAX operator. ``DevicePieces`` (ops/device_format.py)
holds the virtual rows of ``formats.coo.split_heavy_rows`` as a CSR stream;
``spmv_pieces(dev, x, layout, y)`` adds every parent's pieces into its row
of y, in place: y[parent_row[q]] += sum over the parent's pieces of
sum_k values[k] * x[col_idxs[k]].

For CUDA tensors one call of the entry point of ``csrc/scs_pieces.cu``
enqueues one kernel on the current stream: warps walk the work records of
``dev.records`` (``device_format.piece_records``). Parents of at most
``device_format.RECORD_PIECES`` pieces are summed and folded by one warp
in registers, several to a record; a longer one's records meet in
``dev.slots``, where the last to finish folds them (``dev.arrivals``
counts them; both are 0 again after the launch). It counts as one launch of
the wrapper and as one kernel node in a captured CUDA graph. Nothing is
allocated. For CPU tensors it runs ``spmv_pieces_plain``. A failure to
build or launch raises.

Every sum has one fixed order and there are no floating-point atomics, so
two calls give the same bits. Against the plain version the order of the
sums differs (lanes, then a shuffle tree; ``index_add_`` in element order
on the CPU, by atomics on a GPU), by a few ulp times the square root of the
longest row.

(values, x) dtype pairs: those of the SELL-C-sigma kernel, so the split
serves dp, sp, hp, -dp_emu and every adaptive-precision stream. Block
vectors, rowwise [n_pad, bs] or colwise [bs, n_pad]: one launch, a grid row
per pass of up to 8 vectors (``vector_pass_count``), whose warps read each
record's pieces once for all its vectors; each vector's y equals a
one-vector launch's bit for bit. A rowwise x whose rows lie on 16-byte
boundaries is read by 16-byte loads.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import scs_spmv
from .device_format import DevicePieces, vector_pass_count
from .scs_spmv import (
    MAX_VECTORS,
    addressable,
    book_launch,
    check_args,
    raise_for,
)

# (value dtype, x dtype) -> entry point of csrc/scs_pieces.cu
_ENTRY_POINTS = {
    (torch.float64, torch.float64): "uspmv_scs_pieces_f64_f64",
    (torch.float32, torch.float32): "uspmv_scs_pieces_f32_f32",
    (torch.bfloat16, torch.float32): "uspmv_scs_pieces_bf16_f32",
    (torch.float32, torch.float64): "uspmv_scs_pieces_f32_f64",
    (torch.bfloat16, torch.float64): "uspmv_scs_pieces_bf16_f64",
}
_ARGTYPES = (
    [ctypes.c_int64, ctypes.c_void_p] * 2 + [ctypes.c_void_p] * 6
    + [ctypes.c_int64] * 2 + [ctypes.c_void_p, ctypes.c_int64]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
    + [ctypes.c_int, ctypes.c_void_p]
)
KERNELS_PER_LAUNCH = 1

_launches: Dict[str, int] = {name: 0 for name in _ENTRY_POINTS.values()}
_lib = None


def launch_count() -> int:
    """Launches made by ``spmv_pieces`` in this process (one kernel
    each)."""
    return sum(_launches.values())


def launch_counts() -> Dict[str, int]:
    """Launches per instantiation (entry point name)."""
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
            f"no pieces kernel for {value_dtype} values with {x_dtype} x; "
            f"supported (values, x) dtype pairs: {list(_ENTRY_POINTS)}"
        ) from None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = scs_spmv._kernel_lib()  # one library; binds the error string
        for name in _ENTRY_POINTS.values():
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"{name}_blocks_per_sm")
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def spmv_pieces_plain(dev: DevicePieces, x: torch.Tensor, layout: str,
                      y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather x[col_idxs], multiply by the values
    widened to x's dtype, ``index_add_`` into each element's piece, then
    ``index_add_`` each piece into its parent's row of y, in place."""
    vals = dev.values.to(x.dtype)
    if x.dim() == 1 or layout == "rowwise":
        xg = x.index_select(0, dev.col_idxs)
        prod = (vals if x.dim() == 1 else vals[:, None]) * xg
        partials = torch.zeros((dev.n_pieces,) + tuple(x.shape[1:]),
                               dtype=x.dtype, device=x.device)
        partials.index_add_(0, dev.piece_idxs, prod)
        return y.index_add_(0, dev.piece_rows, partials)
    prod = vals[None, :] * x.index_select(1, dev.col_idxs)
    partials = torch.zeros((x.shape[0], dev.n_pieces), dtype=x.dtype,
                           device=x.device)
    partials.index_add_(1, dev.piece_idxs, prod)
    return y.index_add_(1, dev.piece_rows, partials)


def spmv_pieces(dev: DevicePieces, x: torch.Tensor, layout: str,
                y: torch.Tensor) -> torch.Tensor:
    """y += (the pieces' rows of A) x, in place, for x and y in the
    permuted, padded layout ([n_pad], rowwise [n_pad, bs] or colwise
    [bs, n_pad]). Returns y."""
    name = entry_point(dev.values.dtype, x.dtype)
    check_args(dev, x, layout, y)
    if y.data_ptr() == x.data_ptr():
        raise ValueError("y must not be x: pieces read x while parents write")
    if x.device.type == "cpu":
        return spmv_pieces_plain(dev, x, layout, y)
    if x.device.type != "cuda":
        raise ValueError(
            f"spmv_pieces runs on cuda or cpu tensors, not {x.device}")
    index_tensors = (dev.piece_ptr, dev.parent_ptr, dev.parent_row,
                     dev.col_idxs, dev.records, dev.longs, dev.arrivals)
    if not all(t.is_contiguous()
               for t in (*index_tensors, dev.values, dev.slots)) or not (
            addressable(x, layout) and addressable(y, layout)):
        raise ValueError("spmv_pieces needs contiguous tensors")
    if any(t.dtype != torch.int32 for t in index_tensors):
        raise TypeError("piece_ptr, parent_ptr, parent_row, col_idxs, "
                        "records, longs and arrivals must be int32")
    if x.dim() == 1:
        x_ld, vstride, n_vec = 1, 0, 1
    elif layout == "colwise":
        x_ld, vstride, n_vec = 1, x.stride(0), x.shape[0]
    else:
        x_ld, vstride, n_vec = x.shape[1], 1, x.shape[1]
    if n_vec > MAX_VECTORS:
        raise ValueError(
            f"block vectors take at most {MAX_VECTORS} vectors in one "
            f"launch, not {n_vec}"
        )
    n_long = dev.longs.shape[0]
    if (dev.slots.dtype != torch.int64 or dev.slots.device != x.device
            or dev.slots.shape[0] < n_vec
            or dev.slots.shape[2] != x.element_size() // 4
            or dev.arrivals.shape != (vector_pass_count(dev.slots.shape[0]),
                                      n_long)):
        raise ValueError(
            f"the slots hold {tuple(dev.slots.shape)} {dev.slots.dtype} and "
            f"the counters {tuple(dev.arrivals.shape)}; this call needs "
            f"({n_vec}, {dev.slots.shape[1]}, {x.element_size() // 4}) "
            f"int64 and ({vector_pass_count(n_vec)}, {n_long}), a row per "
            "pass of 8 vectors (build_device_pieces: n_vec, acc_dtype)"
        )
    y_vstride = y.stride(0) if layout == "colwise" and x.dim() == 2 \
        else vstride
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        rc = getattr(lib, name)(
            dev.records.shape[0], dev.records.data_ptr(), n_long,
            dev.longs.data_ptr(), dev.piece_ptr.data_ptr(),
            dev.parent_ptr.data_ptr(), dev.parent_row.data_ptr(),
            dev.col_idxs.data_ptr(), dev.values.data_ptr(), x.data_ptr(),
            x_ld, vstride, dev.slots.data_ptr(), dev.slots[0].numel(),
            dev.arrivals.data_ptr(), y.data_ptr(), x_ld, y_vstride, n_vec,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    book_launch(lib, rc, name, _launches, nodes=KERNELS_PER_LAUNCH,
                passes=vector_pass_count(n_vec))
    return y


def launch_geometry(dev: DevicePieces, x_dtype: torch.dtype, n_vec: int = 1,
                    vec_x: bool = False) -> Dict[str, int]:
    """How ``spmv_pieces`` launches ``dev`` for ``n_vec`` vectors of
    ``x_dtype`` on the current GPU: the instantiation it picks (``vec_x``:
    a rowwise x whose rows lie on 16-byte boundaries, read by 16-byte
    loads), its threads per block and blocks resident per SM, its passes
    of up to 8 vectors (grid rows) and the blocks of a grid row (all
    resident blocks shared among the passes, at most a warp per record)."""
    name = entry_point(dev.values.dtype, x_dtype)
    lib = _kernel_lib()
    per_sm, threads = ctypes.c_int(0), ctypes.c_int(0)
    raise_for(lib, getattr(lib, f"{name}_blocks_per_sm")(
        ctypes.byref(per_sm), ctypes.byref(threads), n_vec, int(vec_x)),
        f"{name} occupancy query")
    passes = vector_pass_count(n_vec)
    n_sm = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    needed = -(-dev.records.shape[0] // (threads.value // 32))
    return dict(threads_per_block=threads.value,
                blocks_per_sm=per_sm.value, passes=passes,
                grid=min(max(per_sm.value * n_sm // passes, 1), needed))
