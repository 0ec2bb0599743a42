"""Device-resident SELL-C-sigma matrix.

Port of ``uspmv_tpu/ops/device_format.py``. The JAX package re-tiles the
host ``ScsData`` into static-shape bricks for XLA and lane tiles for the
TPU; on a GPU the hand-written kernel (csrc/scs_spmv.cu) reads the SCS
arrays as they are, so ``DeviceScs`` is the host layout moved onto a
``torch.device``, plus the permuted row of each flat element, which only
the plain PyTorch version (ops/scs_spmv.spmv_scs_plain) reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..formats.scs import ScsData


@dataclasses.dataclass
class DeviceScs:
    """Device tensors of one precision's SCS matrix."""

    chunk_ptrs: torch.Tensor  # int32 [n_chunks + 1]
    chunk_lengths: torch.Tensor  # int32 [n_chunks]
    col_idxs: torch.Tensor  # int32 [n_elements]
    values: torch.Tensor  # [n_elements]: float64, float32 or bfloat16
    row_idxs: torch.Tensor  # int32 [n_elements], permuted row of each element

    C: int
    n_rows: int
    n_rows_padded: int
    n_chunks: int
    n_elements: int
    nnz: int
    # smallest x length the column indices allow (largest column + 1)
    x_len: int

    @property
    def device(self) -> torch.device:
        return self.values.device

    def stream_bytes(self) -> int:
        """Matrix bytes the kernel streams per SpMV: values (8, 4 or 2 B)
        + col_idxs + chunk metadata (x and y are counted by the caller)."""
        return sum(
            t.numel() * t.element_size()
            for t in (self.values, self.col_idxs, self.chunk_ptrs,
                      self.chunk_lengths)
        )

    @property
    def device_beta(self) -> float:
        """nnz / elements the kernel streams — the format's own beta, since
        the kernel reads the SCS layout without re-tiling."""
        return self.nnz / self.n_elements if self.n_elements else 1.0


_VALUE_DTYPES = (torch.float64, torch.float32, torch.bfloat16)


def build_device_scs(
    scs: ScsData, device: torch.device, dtype: Optional[torch.dtype] = None
) -> DeviceScs:
    """Host ScsData -> DeviceScs on ``device``, values in ``dtype``
    (default: the host values' own dtype). hp passes ``torch.bfloat16``
    for float32 host values that carry bf16-rounded numbers, so the cast
    is exact."""

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    values = torch.from_numpy(np.ascontiguousarray(scs.values))
    if dtype is not None:
        values = values.to(dtype)
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(
            f"device values must be one of {_VALUE_DTYPES}, not {values.dtype}"
        )

    return DeviceScs(
        chunk_ptrs=put(scs.chunk_ptrs.astype(np.int32)),
        chunk_lengths=put(scs.chunk_lengths.astype(np.int32)),
        col_idxs=put(scs.col_idxs.astype(np.int32)),
        values=values.to(device),
        row_idxs=put(scs.flat_row_idx()),
        C=scs.C,
        n_rows=scs.n_rows,
        n_rows_padded=scs.n_rows_padded,
        n_chunks=scs.n_chunks,
        n_elements=scs.n_elements,
        nnz=scs.nnz,
        x_len=int(scs.col_idxs.max()) + 1 if scs.n_elements else 0,
    )
