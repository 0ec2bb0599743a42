"""x-access probes: the CUDA kernels of ``csrc/x_access.cu`` and their plain
versions.

Port of the TPU gather probes of the JAX package's scripts/
(``test_gather1d.py``, ``test_gather2d.py``, ``test_gather_tput.py``). On
Hopper every gather is a load of ``x.flat[idx]``, so three modes on a flat
float32 x and an int32 index answer all three:

    gather_store(x, idx)          out[e] = x[idx[e]]
    gather_fma(x, idx, v)         partial[t] = sum_k v[e] * x[idx[e]]
    copy_fma(x, v)                partial[t] = sum_k v[e] * x[e]

with e = t + k*T: T = ``fma_threads(len(v))`` threads walk the elements
with a grid stride and sum their own in order of k. A 2-D source and a
gather dimension become flat indices through ``flat_index``. For CUDA
tensors the wrappers launch the kernels; for CPU tensors they run the plain
versions. A failed launch raises; nothing falls back.

Tolerance of the FMA modes against their plain versions: the plain version
sums each thread's products in another order, so max|d| / max|plain| <=
4 eps_f32 sqrt(elements per thread) (``fma_tol``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence

import torch

from . import scs_spmv

ENTRIES = {
    "gather_store": "uspmv_x_gather_store",
    "gather_fma": "uspmv_x_gather_fma",
    "copy_fma": "uspmv_x_copy_fma",
}
_ARGTYPES = {
    "uspmv_x_gather_store": [ctypes.c_void_p] * 3
    + [ctypes.c_int64, ctypes.c_void_p],
    "uspmv_x_gather_fma": [ctypes.c_void_p] * 4
    + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
    "uspmv_x_copy_fma": [ctypes.c_void_p] * 3
    + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
}
BLOCK = 256  # threads per block of the FMA modes (kThreads)
ELEMS_PER_THREAD = 64  # the default T gives each thread about this many
MAX_BLOCKS = 1024  # about one wave of 256-thread blocks on 132 SMs

_launches: Dict[str, int] = {name: 0 for name in ENTRIES.values()}
_lib = None


def launch_counts() -> Dict[str, int]:
    """Kernel launches per entry point."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


def fma_threads(n: int) -> int:
    """The thread count T of the FMA modes for n elements, the length of
    their result: a multiple of 256, about ELEMS_PER_THREAD elements each,
    at most MAX_BLOCKS blocks. It depends on n alone, so the plain version
    reproduces the kernel's element-to-thread order on any device."""
    blocks = -(-max(int(n), 1) // (BLOCK * ELEMS_PER_THREAD))
    return BLOCK * min(max(blocks, 1), MAX_BLOCKS)


def fma_tol(n: int) -> float:
    """max|kernel - plain| / max|plain| of the FMA modes on n elements: the
    sum of ceil(n / T) products per thread in two orders."""
    per_thread = max(-(-int(n) // fma_threads(n)), 1)
    return 4 * torch.finfo(torch.float32).eps * math.sqrt(per_thread)


def flat_index(idx: torch.Tensor, src_shape: Sequence[int],
               dim: Optional[int]) -> torch.Tensor:
    """Flat int32 indices (1-D, row-major over ``idx``) into a row-major 2-D
    source of ``src_shape`` for the TPU probes' gathers of an index tile
    ``idx`` (i, j):
    dim 0 (sublanes): src[idx mod H, j mod W]  -> (idx mod H) * W + j mod W;
    dim 1 (lanes):    src[i mod H, idx mod W]  -> (i mod H) * W + idx mod W;
    None (full table, gather2d): src.flat[idx mod H*W]."""
    H, W = int(src_shape[0]), int(src_shape[1])
    idx = idx.long()
    if dim is None:
        flat = idx % (H * W)
    else:
        i = torch.arange(idx.shape[0], device=idx.device)[:, None]
        j = torch.arange(idx.shape[1], device=idx.device)[None, :]
        if dim == 0:
            flat = (idx % H) * W + j % W
        elif dim == 1:
            flat = (i % H) * W + idx % W
        else:
            raise ValueError(f"dim must be 0, 1 or None, not {dim}")
    return flat.to(torch.int32).reshape(-1).contiguous()


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = scs_spmv._kernel_lib()  # one library; binds the error string
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x: torch.Tensor, others: Sequence[torch.Tensor], n: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"x must be a 1-D float32 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    for t in others:
        if t.device != x.device or t.dim() != 1 or t.numel() != n:
            raise ValueError(
                f"index and value tensors must be 1-D with {n} elements on "
                f"{x.device}; got {tuple(t.shape)} on {t.device}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"x_access runs on cuda or cpu tensors, not {x.device}")
    if x.device.type == "cuda" and not all(
            t.is_contiguous() for t in (x, *others)):
        raise ValueError("x_access needs contiguous tensors")


def _check_idx(idx: torch.Tensor) -> None:
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, not {idx.dtype}")


def gather_store_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out = x[idx]."""
    return x.index_select(0, idx.long())


def gather_store(x: torch.Tensor, idx: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[e] = x[idx[e]]; every index must lie in x (the kernel does not
    check). ``out``: a float32 buffer of idx's length to write into."""
    _check_idx(idx)
    _check(x, (idx,) if out is None else (idx, out), idx.numel())
    if x.device.type == "cpu":
        y = gather_store_plain(x, idx)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty(idx.numel(), dtype=torch.float32, device=x.device)
    name = ENTRIES["gather_store"]
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        rc = getattr(lib, name)(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                idx.numel(),
                                torch.cuda.current_stream(x.device).cuda_stream)
    scs_spmv.book_launch(lib, rc, name, _launches)
    return out


def _thread_sums(prod: torch.Tensor) -> torch.Tensor:
    """partial[t] = sum of prod[t + k*T] over k, T = fma_threads(len)."""
    T = fma_threads(prod.numel())
    pad = (-prod.numel()) % T
    if pad:
        prod = torch.cat([prod, prod.new_zeros(pad)])
    return prod.view(-1, T).sum(0)


def gather_fma_plain(x: torch.Tensor, idx: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """partial[t] = sum of (v * x[idx])[t + k*T] over k, in the kernel's
    element-to-thread order."""
    return _thread_sums(v * x.index_select(0, idx.long()))


def copy_fma_plain(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """partial[t] = sum of (v * x[:n])[t + k*T] over k."""
    return _thread_sums(v * x[: v.numel()])


def _fma(mode: str, x: torch.Tensor, idx: Optional[torch.Tensor],
         v: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    n = v.numel()
    T = fma_threads(n)
    if v.dtype != torch.float32:
        raise TypeError(f"v must be float32, not {v.dtype}")
    _check(x, (v,) if idx is None else (idx, v), n)
    if idx is None and x.numel() < n:
        raise ValueError(f"copy_fma reads x[:{n}]; x holds {x.numel()}")
    if out is not None and (out.dtype != torch.float32 or out.numel() != T
                            or out.device != x.device):
        raise ValueError(f"out must be float32 with {T} elements on {x.device}")
    if x.device.type == "cpu":
        y = (copy_fma_plain(x, v) if idx is None
             else gather_fma_plain(x, idx, v))
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty(T, dtype=torch.float32, device=x.device)
    name = ENTRIES[mode]
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if idx is None:
            rc = getattr(lib, name)(x.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    n, T, stream)
        else:
            rc = getattr(lib, name)(x.data_ptr(), idx.data_ptr(),
                                    v.data_ptr(), out.data_ptr(), n, T, stream)
    scs_spmv.book_launch(lib, rc, name, _launches)
    return out


def gather_fma(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """partial[t] = sum of v[e] * x[idx[e]] over e = t, t + T, ..., for
    T = ``fma_threads(len(v))`` threads; returns the T partial sums
    (``out``: a float32 buffer of T elements to write them into)."""
    _check_idx(idx)
    return _fma("gather_fma", x, idx, v, out)


def copy_fma(x: torch.Tensor, v: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """partial[t] = sum of v[e] * x[e] over e = t, t + T, ...: the FMA mode
    with x read in place, coalesced (the TPU probe's "copy")."""
    return _fma("copy_fma", x, None, v, out)
