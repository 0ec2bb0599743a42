"""Halo exchange of the row-sharded SpMV: the CUDA kernel's wrapper and its
plain version.

Port of the exchange of ``DistributedSpmvOperator._exchange``
(uspmv_tpu/parallel/distributed.py:917-944), which packs each shard's send
buffer with ``jnp.take``, moves it with one ``ppermute`` per ring offset and
scatters it into the receiver's halo region: XLA ops, not a Pallas kernel.
In this package the R shards of an operator share one device, and their x
buffers are stacked into one tensor (parallel/distributed.py):

    one vector [R, L]; rowwise block vectors [R, L, bs]; colwise [bs, R, L]

So the exchange is one copy inside that tensor, ``x[dst[i]] = x[src[i]]``
over the rows of its flat view (``[R * L]``, ``[R * L, bs]`` or
``[bs, R * L]``), the pairs of ``parallel.halo.exchange_rows``.
``halo_exchange`` does it in place: for CUDA tensors one launch of the
kernel of ``csrc/halo_exchange.cu`` covers every offset, shard and vector;
for CPU tensors it runs ``halo_exchange_plain``,
``index_copy_(index_select)``. A failure to build or launch raises.
Sources and destinations never share a row, so both give the same bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import numpy as np
import torch

from . import scs_spmv
from .scs_spmv import MAX_VECTORS, book_launch

_ENTRY_POINTS = {
    torch.float32: "uspmv_halo_exchange_f32",
    torch.float64: "uspmv_halo_exchange_f64",
}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
             + [ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])

_launches: Dict[str, int] = {name: 0 for name in _ENTRY_POINTS.values()}
_lib = None


def launch_counts() -> Dict[str, int]:
    """Kernel launches per instantiation (entry point name)."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


@dataclasses.dataclass
class DeviceExchange:
    """The (src, dst) row pairs of one precision's exchange on a device."""

    src: torch.Tensor  # int32 [n]
    dst: torch.Tensor  # int32 [n]
    n_shards: int
    length: int  # L, the rows of one shard's x buffer

    @property
    def n(self) -> int:
        return int(self.src.shape[0])

    def bound_bytes(self, x_itemsize: int, n_values: int = 1) -> int:
        """Bytes of the function per call on rows of ``n_values`` values
        (bs of a block of vectors): both indices of every pair read once,
        each source value read and each destination value written once."""
        return self.n * (8 + 2 * x_itemsize * n_values)


def build_device_exchange(src: np.ndarray, dst: np.ndarray, n_shards: int,
                          length: int, device: torch.device
                          ) -> DeviceExchange:
    """The host's (src, dst) rows (``parallel.halo.exchange_rows``) on
    ``device`` as int32; raises for a row outside the R * L stacked rows
    or one that is both a source and a destination."""
    rows = n_shards * length
    if rows > np.iinfo(np.int32).max:
        raise OverflowError(f"{rows} stacked rows exceed int32 indices")
    if src.size and not (0 <= min(src.min(), dst.min())
                         and max(src.max(), dst.max()) < rows):
        raise ValueError("an exchange row lies outside the stacked buffer")
    if np.intersect1d(src, dst).size:
        raise ValueError("an exchange row is both a source and a destination")

    def put(a):
        return torch.from_numpy(a.astype(np.int32)).to(device)

    return DeviceExchange(src=put(src), dst=put(dst), n_shards=n_shards,
                          length=length)


def flat_view(ex: DeviceExchange, x: torch.Tensor, layout: str):
    """(the flat view of the stacked buffer x, the dimension of its rows):
    [R*L] or [R*L, bs] (dim 0), colwise [bs, R*L] (dim 1)."""
    rows = ex.n_shards * ex.length
    if x.dim() == 2 and x.shape == (ex.n_shards, ex.length):
        return x.view(rows), 0
    if x.dim() == 3 and layout == "rowwise" and x.shape[:2] == (
            ex.n_shards, ex.length):
        return x.view(rows, x.shape[2]), 0
    if x.dim() == 3 and layout == "colwise" and x.shape[1:] == (
            ex.n_shards, ex.length):
        return x.view(x.shape[0], rows), 1
    raise ValueError(
        f"x must be the stacked buffer [R, L], rowwise [R, L, bs] or "
        f"colwise [bs, R, L] with R={ex.n_shards}, L={ex.length}; got "
        f"{tuple(x.shape)} {layout}")


def halo_exchange_plain(ex: DeviceExchange, x: torch.Tensor,
                        layout: str = "rowwise") -> torch.Tensor:
    """Plain PyTorch version, in place: the rows ``dst`` of the flat view
    take the rows ``src``. Returns x."""
    flat, dim = flat_view(ex, x, layout)
    flat.index_copy_(dim, ex.dst.long(), flat.index_select(dim, ex.src))
    return x


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


def halo_exchange(ex: DeviceExchange, x: torch.Tensor,
                  layout: str = "rowwise") -> torch.Tensor:
    """Fill the halo rows of the stacked buffer x in place (see the module
    docstring). An exchange without pairs launches nothing. Returns x."""
    try:
        name = _ENTRY_POINTS[x.dtype]
    except KeyError:
        raise TypeError(f"the halo exchange takes float32 or float64 x, "
                        f"not {x.dtype}") from None
    flat, dim = flat_view(ex, x, layout)
    if x.device != ex.src.device:
        raise ValueError(f"x is on {x.device}, the exchange on "
                         f"{ex.src.device}")
    if ex.n == 0:
        return x
    if x.device.type == "cpu":
        return halo_exchange_plain(ex, x, layout)
    if x.device.type != "cuda":
        raise ValueError(
            f"halo_exchange runs on cuda or cpu tensors, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("halo_exchange needs a contiguous buffer")
    if dim == 1:
        ld, ncols, vstride, n_vec = 1, 1, flat.shape[1], flat.shape[0]
    else:
        ncols = 1 if flat.dim() == 1 else flat.shape[1]
        ld, vstride, n_vec = ncols, 0, 1
    if n_vec > MAX_VECTORS:
        raise ValueError(f"colwise block vectors take at most {MAX_VECTORS} "
                         f"vectors in one launch, not {n_vec}")
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        rc = getattr(lib, name)(
            x.data_ptr(), ex.src.data_ptr(), ex.dst.data_ptr(), ex.n, ld,
            ncols, vstride, n_vec,
            torch.cuda.current_stream(x.device).cuda_stream)
    book_launch(lib, rc, name, _launches)
    return x
