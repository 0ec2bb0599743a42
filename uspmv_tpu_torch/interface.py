"""Embedding/library interface.

Port of ``uspmv_tpu/interface.py`` (the re-design of the reference's
standalone ``interface.hpp``, documented in API_doc.md): a small,
harness-free API for host applications that want SpMV as a library call.
The host app owns its own distribution, like the reference's MPI-free
interface (API_doc.md:5).

Mapping to the reference exports (interface.hpp):
  convert_to_scs / partition_precisions / apply_permutation /
  permute_scs_cols            -> re-exported from the core modules
  uspmv_csr_cpu, uspmv_scs_cpu,
  uspmv_scs_c_cpu, uspmv_*_gpu -> prepare() + execute_uspmv(): one entry,
                                  dispatching on format x precision x
                                  backend like interface.hpp:1871-2188
  uspmv_*_ap*_cpu              -> value_type="ap[...]" in prepare()

Example:
    import uspmv_tpu_torch.interface as ui
    h = ui.prepare(mtx, C=1024, sigma=1, value_type="sp")
    y = ui.execute_uspmv(h, x)          # numpy in, numpy out
    y = ui.execute_uspmv(h, x, n_repetitions=50)   # repeated-SpMV solve

    # solver embedding: keep x/y device-resident between calls
    xd = ui.upload_x(h, x)
    for _ in range(iters):
        xd = ui.execute_uspmv(h, xd, device_resident=True)
    y = ui.download_y(h, xd)

``backend`` is "cuda" (default; raises without a GPU) or "cpu" (the plain
PyTorch version).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .config import Config
from .formats.coo import MtxData, apply_permutation  # noqa: F401 (re-export)
from .formats.scs import ScsData, convert_to_scs, permute_scs_cols  # noqa: F401
from .precision.partition import partition_precisions  # noqa: F401
from .runtime.operator import SpmvOperator


def prepare(
    mtx: Union[MtxData, "np.ndarray", object],
    C: int = 1,
    sigma: int = 1,
    value_type: str = "dp",
    kernel_format: Optional[str] = None,
    block_vec_size: int = 1,
    vector_layout: str = "rowwise",
    backend: str = "cuda",
    use_pallas: bool = True,
    ap_threshold_1: float = 0.0,
    ap_threshold_2: float = 0.0,
    equilibrate: bool = False,
) -> SpmvOperator:
    """Convert + upload a matrix once; returns a reusable operator handle.

    ``mtx`` may be an MtxData, a scipy.sparse matrix, or a dense ndarray.
    """
    if not isinstance(mtx, MtxData):
        if hasattr(mtx, "tocoo"):
            mtx = MtxData.from_scipy(mtx)
        else:
            a = np.asarray(mtx)
            nz = np.nonzero(a)
            mtx = MtxData.from_arrays(
                nz[0], nz[1], a[nz], n_rows=a.shape[0], n_cols=a.shape[1]
            )
    if kernel_format is None:
        kernel_format = "crs" if (C == 1 and sigma == 1) else "scs"
    cfg = Config(
        kernel_format=kernel_format,
        chunk_size=C if kernel_format == "scs" else 1,
        sigma=sigma if kernel_format == "scs" else 1,
        value_type=value_type,
        block_vec_size=block_vec_size,
        vector_layout=vector_layout,
        backend=backend,
        use_pallas=use_pallas,
        ap_threshold_1=ap_threshold_1,
        ap_threshold_2=ap_threshold_2,
        equilibrate=equilibrate,
    )
    return SpmvOperator.from_mtx(cfg, mtx)


def execute_uspmv(
    handle: SpmvOperator,
    x,
    n_repetitions: int = 1,
    device_resident: bool = False,
):
    """y = A^n x through the prepared operator (reference execute_uspmv,
    interface.hpp:1871-2188; n_repetitions>1 = the repeated-SpMV solve loop
    with x<->y swap, main.cpp:528-607). Host numpy in/out, original row
    order; permutation/padding/device transfer handled internally.

    Solver embedding (avoid per-call host<->device transfers): pass
    ``device_resident=True`` and a ``torch.Tensor`` from :func:`upload_x`;
    the result stays on the device in the operator's layout, ready to feed
    the next call. Round-trip back with :func:`download_y`. (The CG example
    in examples/cg_solver_torch.py runs a whole solver on that layout.)
    """
    xd = x if _is_device_vector(x) else handle.make_x(np.asarray(x))
    if n_repetitions <= 1:
        yd = handle.spmv(xd)
    else:
        _, yd = handle.solve(xd, n_repetitions)
    if device_resident:
        return yd
    return handle.to_host(yd)


def _is_device_vector(x) -> bool:
    return isinstance(x, torch.Tensor)


def upload_x(handle: SpmvOperator, x: np.ndarray) -> torch.Tensor:
    """Permute/pad/upload a host vector once; the returned device vector
    can be passed to execute_uspmv repeatedly (no re-upload per call)."""
    return handle.make_x(np.asarray(x))


def download_y(handle: SpmvOperator, y: torch.Tensor) -> np.ndarray:
    """Bring a device-resident result back to host order."""
    return handle.to_host(y)


def spmv_reference_host(scs: ScsData, x: np.ndarray) -> np.ndarray:
    """Trivially-correct host SCS SpMV in original row order (the library
    analogue of the reference's spmv_verify COO loop, utilities.hpp:662-715).
    ``scs`` must be un-column-permuted (fresh from convert_to_scs)."""
    x = np.asarray(x, dtype=np.float64)
    xp = np.concatenate([x, np.zeros(scs.n_rows_padded - scs.n_rows)])
    y = scs.spmv_reference(xp)
    return y[scs.old_to_new_idx]
