"""ctypes binding of the native host library (native/uspmv_host.cpp).

Port of the two host entries of ``uspmv_tpu/native/__init__.py``
(``read_mtx_native``, ``convert_to_scs_native``): the MatrixMarket reader
and the COO -> SELL-C-sigma converter in C++ (the reference's native
mmio.cpp and convert_to_scs, utilities.hpp:1842-2104), bit-equal to the
Python paths of ``io/mmio.py`` and ``formats/scs.py``, which stay the
fallback and the oracle of the tests.

The library is built at first use by ``g++ -O3 -std=c++17 -fPIC -shared``
(``$CXX`` if set) from the repository's ``native/uspmv_host.cpp`` into
``build/uspmv_tpu_torch/``, under a name that carries a hash of the source
and the flags; ``native/Makefile`` and the JAX package's copy of the
library are not used. Set ``USPMV_DISABLE_NATIVE=1`` to force the Python
paths. The library's TPU packers (``uspmv_pack_*``) are not bound.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

from .ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "native" / "uspmv_host.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fvisibility=hidden")
ABI_VERSION = 7  # uspmv_abi_version() of native/uspmv_host.cpp

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the library could not be built or bound
_warned = False  # the default path's fallback was announced

_i64 = ctypes.c_int64
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_f32p = ctypes.POINTER(ctypes.c_float)


class NativeUnavailableError(RuntimeError):
    """native=True was asked for and the library cannot be built."""


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libuspmv_host_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile into a private name, then rename: a concurrent build never
    loads a half-written library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeUnavailableError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailableError(
            f"{' '.join(cmd)} failed (rc {proc.returncode}): "
            f"{proc.stderr.strip()[:2000]}")
    os.replace(tmp, out)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.uspmv_abi_version.restype = _i64
    version = int(lib.uspmv_abi_version())
    if version != ABI_VERSION:
        raise NativeUnavailableError(
            f"native library ABI version {version} != {ABI_VERSION}")
    lib.uspmv_last_error.restype = ctypes.c_char_p
    lib.uspmv_read_mtx.restype = ctypes.c_void_p
    lib.uspmv_read_mtx.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.uspmv_mtx_sizes.argtypes = [ctypes.c_void_p, _i64p, _i64p, _i64p,
                                    _i32p]
    lib.uspmv_mtx_fetch.argtypes = [ctypes.c_void_p, _i32p, _i32p, _f64p]
    lib.uspmv_mtx_free.argtypes = [ctypes.c_void_p]
    lib.uspmv_convert_to_scs.restype = ctypes.c_void_p
    lib.uspmv_convert_to_scs.argtypes = [
        _i64, _i64, _i32p, _i32p, _f64p, _i64, _i64, _i32p,
    ]
    lib.uspmv_scs_sizes.argtypes = [ctypes.c_void_p, _i64p, _i64p, _i64p,
                                    _i64p]
    lib.uspmv_scs_fetch.argtypes = [
        ctypes.c_void_p, _i32p, _i32p, _i32p, _f64p, _i32p, _i32p, _i32p,
    ]
    lib.uspmv_scs_fetch_vals_f32.argtypes = [ctypes.c_void_p, _f32p]
    lib.uspmv_scs_free.argtypes = [ctypes.c_void_p]
    return lib


def load(required: bool = False) -> Optional[ctypes.CDLL]:
    """The library, built on first use in this process; None where it
    cannot be built or is disabled, or with ``required`` a
    NativeUnavailableError. The first fallback of the default path warns
    with the reason, so set-up seconds never move without a word."""
    global _lib, _error, _warned
    if os.environ.get("USPMV_DISABLE_NATIVE"):  # read at every call
        if required:
            raise NativeUnavailableError("USPMV_DISABLE_NATIVE is set")
        return None
    with _lock:
        if _lib is None and _error is None:
            try:
                path = library_path()
                if not path.exists():
                    _build(path)
                _lib = _bind(ctypes.CDLL(str(path)))
            except (OSError, NativeUnavailableError) as e:
                _error = str(e)
    if _lib is None and required:
        raise NativeUnavailableError(
            f"native host library unavailable: {_error}")
    if _lib is None and not _warned:
        _warned = True
        warnings.warn(f"native host library unavailable ({_error}); "
                      "reading and converting in Python", RuntimeWarning,
                      stacklevel=2)
    return _lib


def available() -> bool:
    return load() is not None


def _ptr_i32(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


def _raise_last(lib):
    raise ValueError(lib.uspmv_last_error().decode("utf-8", "replace"))


def read_mtx_native(path: str, require_square: bool = True,
                    required: bool = False):
    """Native MatrixMarket read -> ``MtxData``, or None where the library
    is unavailable (``required``: raise instead)."""
    lib = load(required)
    if lib is None:
        return None
    from .formats.coo import MtxData

    h = lib.uspmv_read_mtx(str(path).encode(), 1 if require_square else 0)
    if not h:
        _raise_last(lib)
    try:
        n_rows, n_cols, nnz = _i64(0), _i64(0), _i64(0)
        is_sym = ctypes.c_int32(0)
        lib.uspmv_mtx_sizes(h, ctypes.byref(n_rows), ctypes.byref(n_cols),
                            ctypes.byref(nnz), ctypes.byref(is_sym))
        I = np.empty(nnz.value, dtype=np.int32)
        J = np.empty(nnz.value, dtype=np.int32)
        vals = np.empty(nnz.value, dtype=np.float64)
        lib.uspmv_mtx_fetch(h, _ptr_i32(I), _ptr_i32(J),
                            vals.ctypes.data_as(_f64p))
    finally:
        lib.uspmv_mtx_free(h)
    return MtxData(
        n_rows=n_rows.value, n_cols=n_cols.value, nnz=nnz.value,
        is_sorted=True, is_symmetric=bool(is_sym.value),
        I=I, J=J, values=vals,
    )


def convert_to_scs_native(mtx, C: int, sigma: int, dtype=None,
                          fixed_permutation=None, required: bool = False):
    """Native COO -> ``ScsData``, the result of ``formats.scs
    .convert_to_scs``, or None where the library is unavailable
    (``required``: raise instead)."""
    lib = load(required)
    if lib is None:
        return None
    from .formats.scs import ScsData

    I = np.ascontiguousarray(mtx.I, dtype=np.int32)
    J = np.ascontiguousarray(mtx.J, dtype=np.int32)
    vals = np.ascontiguousarray(mtx.values, dtype=np.float64)
    fpp = None
    if fixed_permutation is not None:
        fp = np.ascontiguousarray(fixed_permutation, dtype=np.int32)
        if fp.shape[0] < mtx.n_rows:
            raise ValueError("fixed_permutation shorter than n_rows")
        fpp = _ptr_i32(fp)
    h = lib.uspmv_convert_to_scs(mtx.n_rows, mtx.nnz, _ptr_i32(I),
                                 _ptr_i32(J), vals.ctypes.data_as(_f64p),
                                 C, sigma, fpp)
    if not h:
        _raise_last(lib)
    try:
        n_rows, n_pad, n_chunks, n_elems = _i64(0), _i64(0), _i64(0), _i64(0)
        lib.uspmv_scs_sizes(h, ctypes.byref(n_rows), ctypes.byref(n_pad),
                            ctypes.byref(n_chunks), ctypes.byref(n_elems))
        chunk_ptrs = np.empty(n_chunks.value + 1, dtype=np.int32)
        chunk_lengths = np.empty(n_chunks.value, dtype=np.int32)
        col_idxs = np.empty(n_elems.value, dtype=np.int32)
        out_dtype = np.dtype(dtype if dtype is not None
                             else mtx.values.dtype)
        # f32 targets are cast during the copy: no second full-size buffer
        f32 = out_dtype == np.float32
        values = np.empty(n_elems.value,
                          dtype=np.float32 if f32 else np.float64)
        old_to_new = np.empty(n_rows.value, dtype=np.int32)
        new_to_old = np.empty(n_pad.value, dtype=np.int32)
        row_counts = np.empty(n_pad.value, dtype=np.int32)
        lib.uspmv_scs_fetch(
            h, _ptr_i32(chunk_ptrs), _ptr_i32(chunk_lengths),
            _ptr_i32(col_idxs), None if f32 else values.ctypes.data_as(_f64p),
            _ptr_i32(old_to_new), _ptr_i32(new_to_old), _ptr_i32(row_counts),
        )
        if f32:
            lib.uspmv_scs_fetch_vals_f32(h, values.ctypes.data_as(_f32p))
    finally:
        lib.uspmv_scs_free(h)
    return ScsData(
        C=int(C), sigma=int(sigma), n_rows=n_rows.value,
        n_rows_padded=n_pad.value, n_chunks=n_chunks.value,
        n_elements=n_elems.value, nnz=mtx.nnz, chunk_ptrs=chunk_ptrs,
        chunk_lengths=chunk_lengths, col_idxs=col_idxs,
        values=(values if values.dtype == out_dtype
                else values.astype(out_dtype)),
        old_to_new_idx=old_to_new, new_to_old_idx=new_to_old,
        n_cols=mtx.n_cols, row_counts_new=row_counts,
    )
