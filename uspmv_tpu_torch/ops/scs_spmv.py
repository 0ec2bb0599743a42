"""SELL-C-sigma SpMV / SpMMV: the CUDA kernel's wrapper and its plain version.

Port of ``spmv_lane_tiles`` and ``_spmv_lane_tiles_df64``
(uspmv_tpu/ops/pallas_scs.py). ``spmv_scs(dev, x)`` returns y = A x in the
permuted, padded row order; ``spmv_scs(dev, x, y=y)`` adds A x into y in
place, the form the adaptive-precision sum uses; ``spmv_scs(dev, x, out=y)``
writes A x into a buffer the caller owns, the form a CUDA graph of a solve
needs (static ping-pong vectors). For CUDA tensors it
launches the hand-written kernel of ``csrc/scs_spmv.cu``; for CPU tensors it
runs ``spmv_scs_plain``. Any failure to build or launch the kernel raises,
and so does a pair of dtypes the kernel does not take.

Supported (values, x) dtype pairs, x being the vector and accumulator type:
(f64, f64), (f32, f32), (bf16, f32), (f32, f64), (bf16, f64). A unit stream
(``build_device_scs(unit_values=True)``: an all-ones matrix without values)
takes f32 x and runs the kernel's unit-value entry, the counterpart of the
``unit=True`` form of the TPU kernel.

x layouts (ops/vectors.py): one vector [n_pad]; rowwise block vectors
[n_pad, bs] and colwise block vectors [bs, n_pad], for which the kernel
streams the matrix once for up to 8 columns or vectors (``vector_passes``:
rowwise bs > 8 as one launch per pass, colwise as one launch whose grid
rows are the passes). A colwise x or y may be a view whose vectors are
each contiguous (``addressable``).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from ..runtime import profiling
from . import _build
from .device_format import VECTORS_PER_PASS, DeviceScs, vector_pass_count

# (value dtype, x dtype) -> entry point of csrc/scs_spmv.cu
_ENTRY_POINTS = {
    (torch.float64, torch.float64): "uspmv_scs_spmv_f64_f64",
    (torch.float32, torch.float32): "uspmv_scs_spmv_f32_f32",
    (torch.bfloat16, torch.float32): "uspmv_scs_spmv_bf16_f32",
    (torch.float32, torch.float64): "uspmv_scs_spmv_f32_f64",
    (torch.bfloat16, torch.float64): "uspmv_scs_spmv_bf16_f64",
}
# the all-ones matrix without a value stream (DeviceScs.unit_vals)
UNIT_ENTRY = "uspmv_scs_spmv_unit_f32"
# n_rows_padded, C, chunk_ptrs, chunk_lengths, group_lengths, their bytes,
# col_idxs, values, x, x_ld, x_vstride, y, y_ld, y_vstride, ncols, n_vec,
# accumulate, stream
_ARGTYPES = (
    [ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
    + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
)
THREADS = 256  # threads per block of every row-sum kernel (kThreads)
# colwise vectors one launch of a kernel takes (the pieces and halo
# kernels: gridDim.y)
MAX_VECTORS = 65535
LAYOUTS = ("rowwise", "colwise")

_launches: Dict[str, int] = {
    name: 0 for name in [*_ENTRY_POINTS.values(), UNIT_ENTRY]
}
# while a CUDA graph is captured: the kernel nodes enqueued, per entry point
_captured: Optional[Dict[str, int]] = None
_lib = None


def launch_count() -> int:
    """Kernel launches made by ``spmv_scs`` in this process."""
    return sum(_launches.values())


def launch_counts() -> Dict[str, int]:
    """Kernel launches per instantiation (entry point name)."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


@contextlib.contextmanager
def record_captured_launches() -> Iterator[Dict[str, int]]:
    """Inside a CUDA-graph capture a call to ``spmv_scs`` (or to
    ``spmv_packed`` / ``spmv_pieces``) adds kernel nodes to the graph and
    launches nothing. Within this context such calls are
    counted into the yielded dict (entry point -> nodes) and not into the
    launch count, which holds launches this wrapper made itself and nothing
    else. Whoever owns the graph keeps the dict and its own count of
    replays (runtime/operator.graph_nodes_replayed)."""
    global _captured
    _captured = {}
    try:
        yield _captured
    finally:
        _captured = None


def book_launch(lib, rc: int, name: str, launches: Dict[str, int],
                nodes: int = 1, passes: int = 0) -> None:
    """After a call of kernel entry point ``name`` that returned ``rc``,
    enqueued ``nodes`` kernels and made ``passes`` passes over a matrix
    stream: raise when the launch was refused, else add one to the
    wrapper's count ``launches`` and to the process-wide launch total
    (``profiling.LAUNCHES``) and the passes to ``profiling.MATRIX_PASSES``
    -- or, while a CUDA graph is captured, the kernel nodes to the
    capture's count. Shared by the wrappers of every csrc/*.cu, which load
    one library."""
    raise_for(lib, rc, f"kernel {name} launch")
    if _captured is not None:
        _captured[name] = _captured.get(name, 0) + nodes
    else:
        launches[name] += 1
        profiling.count(profiling.LAUNCHES)
        if passes:
            profiling.count(profiling.MATRIX_PASSES, passes)


def entry_point(value_dtype: torch.dtype, x_dtype: torch.dtype) -> str:
    """The kernel instantiation for a (values, x) dtype pair; raises for a
    pair it does not take."""
    try:
        return _ENTRY_POINTS[(value_dtype, x_dtype)]
    except KeyError:
        raise TypeError(
            f"no SCS kernel for {value_dtype} values with {x_dtype} x; "
            f"supported (values, x) dtype pairs: {list(_ENTRY_POINTS)}"
        ) from None


def entry_for(dev: DeviceScs, x_dtype: torch.dtype) -> str:
    """The kernel instantiation that runs ``dev`` with x of ``x_dtype``:
    the unit-value entry for a unit stream, else ``entry_point``."""
    if dev.unit_vals:
        if x_dtype != torch.float32:
            raise TypeError(
                f"a unit-value stream takes float32 x, not {x_dtype}")
        return UNIT_ENTRY
    return entry_point(dev.values.dtype, x_dtype)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library().lib
        for name in _launches:
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            query = getattr(lib, f"{name}_blocks_per_sm")
            query.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            query.restype = ctypes.c_int
        lib.uspmv_cuda_error_string.argtypes = [ctypes.c_int]
        lib.uspmv_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def raise_for(lib, rc: int, what: str) -> None:
    """Raise with CUDA's text when a call into the library returned an
    error."""
    if rc != 0:
        msg = lib.uspmv_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: {msg} (cudaError {rc})")


def launch_geometry(dev: DeviceScs, x_dtype: torch.dtype,
                    n_vec: int = 1) -> Dict[str, int]:
    """How ``spmv_scs`` launches ``dev`` for one vector of ``x_dtype``, or
    ``n_vec`` > 1 colwise vectors, on the current GPU: threads per block,
    blocks resident per SM (the occupancy of the one-vector instantiation,
    or of the one of 8 colwise vectors, in the loop form ``dev`` runs: by
    group lengths where it has them, else by chunk lengths), the form, the
    grid and its passes over the matrix (``vector_pass_count``)."""
    name = entry_for(dev, x_dtype)
    lib = _kernel_lib()
    per_sm = ctypes.c_int(0)
    groups = int(dev.group_length_bytes != 0)
    raise_for(lib, getattr(lib, f"{name}_blocks_per_sm")(
        ctypes.byref(per_sm), groups, int(n_vec > 1)),
        f"{name} occupancy query")
    return dict(threads_per_block=THREADS, blocks_per_sm=per_sm.value,
                groups=groups, grid=-(-dev.n_rows_padded // THREADS),
                passes=vector_pass_count(n_vec))


def vector_passes(bs: int) -> List[Tuple[int, int]]:
    """The passes of the SELL-C-sigma kernel over the matrix for a block
    of ``bs`` vectors, in either layout: (first column or vector, count)
    of each, at most VECTORS_PER_PASS, in order. Rowwise, each pass is a
    launch; colwise, a launch runs them as its grid rows (vectors 8p ..
    8p + 7 in row p, ``launch_colwise`` of csrc/scs_spmv.cu)."""
    return [(v0, min(VECTORS_PER_PASS, bs - v0))
            for v0 in range(0, bs, VECTORS_PER_PASS)]


def out_shape(dev, x: torch.Tensor, layout: str) -> Tuple[int, ...]:
    if x.dim() == 1:
        return (dev.n_rows_padded,)
    if layout == "rowwise":
        return (dev.n_rows_padded, x.shape[1])
    return (x.shape[0], dev.n_rows_padded)


def addressable(t: torch.Tensor, layout: str) -> bool:
    """Whether the kernels can address vector block ``t``: contiguous, or
    colwise [bs, n] with each vector contiguous (a view into a larger
    buffer, as one shard's part of the stacked x of a sharded operator);
    they take the stride between vectors from ``t.stride(0)``."""
    if t.dim() == 2 and layout == "colwise":
        return t.stride(1) == 1
    return t.is_contiguous()


def check_args(dev, x: torch.Tensor, layout: str,
               y: Optional[torch.Tensor]) -> None:
    """Shapes, dtypes and devices of one product with any device stream
    (``DeviceScs``, ``DevicePacked``, ``DevicePieces``). ``y``: the vector
    the product is added into or written to, if any."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, not {layout!r}")
    if x.dim() == 1:
        rows = x.shape[0]
    elif x.dim() == 2:
        rows = x.shape[0] if layout == "rowwise" else x.shape[1]
    else:
        rows = -1
    if rows < dev.x_len or (x.dim() == 2 and x.numel() == 0):
        raise ValueError(
            f"x must be 1-D, or 2-D in the {layout} layout, with at least "
            f"{dev.x_len} rows (the largest column index + 1); got shape "
            f"{tuple(x.shape)}"
        )
    if x.device != dev.device:
        raise ValueError(f"x is on {x.device}, the matrix on {dev.device}")
    if y is not None:
        shape = out_shape(dev, x, layout)
        if tuple(y.shape) != shape or y.dtype != x.dtype or y.device != x.device:
            raise ValueError(
                f"y to accumulate or write into must be {x.dtype} of shape "
                f"{shape} on "
                f"{x.device}; got {y.dtype} {tuple(y.shape)} on {y.device}"
            )


def spmv_scs_plain(dev: DeviceScs, x: torch.Tensor, layout: str = "rowwise",
                   y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: gather x[col_idxs], multiply by the values
    widened to x's dtype, ``index_add_`` over each flat element's permuted
    row, in x's dtype (like uspmv_tpu/ops/spmv_xla.spmv_flat). Every
    padding element adds 0 * x[0], the kernel's only those below its
    group's length. With ``y`` given, adds the product into it in
    place and returns it. A unit stream sums x[col] over the slots whose
    column is >= 0."""
    if dev.unit_vals:
        valid = dev.col_idxs >= 0
        cols = torch.where(valid, dev.col_idxs, 0)
        vals = valid.to(x.dtype)
    else:
        cols = dev.col_idxs
        vals = dev.values.to(x.dtype)
    if x.dim() == 1 or layout == "rowwise":
        xg = x.index_select(0, cols)
        prod = (vals if x.dim() == 1 else vals[:, None]) * xg
        part = torch.zeros(out_shape(dev, x, layout), dtype=x.dtype,
                           device=x.device).index_add_(0, dev.row_idxs, prod)
    else:  # colwise [bs, n_pad]
        prod = vals[None, :] * x.index_select(1, cols)
        part = torch.zeros(out_shape(dev, x, layout), dtype=x.dtype,
                           device=x.device).index_add_(1, dev.row_idxs, prod)
    if y is None:
        return part
    return y.add_(part)


def matrix_args(dev: DeviceScs) -> tuple:
    """The matrix arguments of an entry point of csrc/scs_spmv.cu or
    scs_solve.cu, in order: n_rows_padded, C, chunk_ptrs, chunk_lengths,
    group_lengths, their bytes each (0: none), col_idxs, values."""
    return (dev.n_rows_padded, dev.C, dev.chunk_ptrs.data_ptr(),
            dev.chunk_lengths.data_ptr(), dev.group_lengths.data_ptr(),
            dev.group_length_bytes, dev.col_idxs.data_ptr(),
            dev.values.data_ptr())


def check_matrix_tensors(dev: DeviceScs, what: str) -> None:
    """Raise unless the kernels can read ``dev``'s arrays: contiguous,
    int32 chunk metadata and columns, group lengths of 1, 2 or 4 bytes."""
    tensors = (dev.chunk_ptrs, dev.chunk_lengths, dev.group_lengths,
               dev.col_idxs, dev.values)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} needs contiguous tensors")
    if not (dev.chunk_ptrs.dtype == dev.chunk_lengths.dtype
            == dev.col_idxs.dtype == torch.int32):
        raise TypeError("chunk_ptrs, chunk_lengths and col_idxs must be int32")
    if dev.group_lengths.dtype not in (torch.uint8, torch.int16,
                                       torch.int32):
        raise TypeError("group_lengths must be uint8, int16 or int32, not "
                        f"{dev.group_lengths.dtype}")


def _launch(lib, name: str, dev: DeviceScs, x_ptr: int, x_ld: int,
            x_vstride: int, y_ptr: int, y_ld: int, y_vstride: int,
            ncols: int, n_vec: int, accumulate: bool, stream: int) -> None:
    rc = getattr(lib, name)(
        *matrix_args(dev),
        x_ptr, x_ld, x_vstride, y_ptr, y_ld, y_vstride,
        ncols, n_vec, int(accumulate), stream,
    )
    book_launch(lib, rc, name, _launches, passes=vector_pass_count(n_vec))


def spmv_scs(dev: DeviceScs, x: torch.Tensor, layout: str = "rowwise",
             y: Optional[torch.Tensor] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A x for x in the permuted, padded layout ([n_pad], rowwise
    [n_pad, bs] or colwise [bs, n_pad]); with ``y`` given, y += A x in
    place; with ``out`` given, out = A x written into the caller's buffer
    (which must not be x). Returns y in x's dtype."""
    if y is not None and out is not None:
        raise ValueError("give y (accumulate into) or out (write to), not both")
    name = entry_for(dev, x.dtype)
    check_args(dev, x, layout, y if out is None else out)
    if out is not None and out.data_ptr() == x.data_ptr():
        raise ValueError("out must not be x: rows read x while others write")
    if x.device.type == "cpu":
        if out is not None:
            return out.copy_(spmv_scs_plain(dev, x, layout))
        return spmv_scs_plain(dev, x, layout, y)
    if x.device.type != "cuda":
        raise ValueError(f"spmv_scs runs on cuda or cpu tensors, not {x.device}")
    accumulate = y is not None
    if out is not None:
        y = out
    check_matrix_tensors(dev, "spmv_scs")
    if not addressable(x, layout) or (y is not None
                                      and not addressable(y, layout)):
        raise ValueError("spmv_scs needs contiguous tensors")
    if y is None:
        y = torch.empty(out_shape(dev, x, layout), dtype=x.dtype,
                        device=x.device)
    lib = _kernel_lib()
    esize = x.element_size()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dim() == 1:
            _launch(lib, name, dev, x.data_ptr(), 1, 0, y.data_ptr(), 1, 0,
                    1, 1, accumulate, stream)
        elif layout == "colwise":
            bs = x.shape[0]
            if bs > MAX_VECTORS:
                raise ValueError(
                    f"colwise block vectors take at most {MAX_VECTORS} "
                    f"vectors in one launch, not {bs}"
                )
            _launch(lib, name, dev, x.data_ptr(), 1, x.stride(0),
                    y.data_ptr(), 1, y.stride(0), 1, bs, accumulate, stream)
        else:
            bs = x.shape[1]
            for c0, ncols in vector_passes(bs):
                _launch(lib, name, dev, x.data_ptr() + c0 * esize, bs, 0,
                        y.data_ptr() + c0 * esize, bs, 0, ncols, 1,
                        accumulate, stream)
    return y
