"""Device-resident matrix streams.

Port of ``uspmv_tpu/ops/device_format.py``. The JAX package re-tiles the
host ``ScsData`` into static-shape bricks for XLA and lane tiles for the
TPU; on a GPU the hand-written kernel (csrc/scs_spmv.cu) reads the SCS
arrays as they are, so ``DeviceScs`` is the host layout moved onto a
``torch.device``, plus the permuted row of each flat element, which only
the plain PyTorch version (ops/scs_spmv.spmv_scs_plain) reads.

Two more streams serve matrices whose rows are badly imbalanced:
``DevicePacked`` is the same ``ScsData`` with its padding dropped, cut into
row groups one thread block stages in shared memory (csrc/scs_packed.cu,
the answer to the TPU's mixed tiles); ``DevicePieces`` holds the virtual
rows of ``formats.coo.split_heavy_rows`` as a CSR stream with the map back
to their parents (csrc/scs_pieces.cu, the answer to the TPU's product
tiles and the fold behind them).
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
    # [n_elements]: float64, float32 or bfloat16; empty float32 for a unit
    # stream
    values: torch.Tensor
    row_idxs: torch.Tensor  # int32 [n_elements], permuted row of each element

    C: int
    n_rows: int
    n_rows_padded: int
    n_chunks: int
    n_elements: int
    nnz: int
    # smallest x length the column indices allow (largest column + 1)
    x_len: int
    # an all-ones matrix without a value stream: col_idxs is -1 at padding
    # slots (build_device_scs(unit_values=True))
    unit_vals: bool = False

    @property
    def device(self) -> torch.device:
        return self.values.device

    def stream_bytes(self) -> int:
        """Matrix bytes the kernel streams per SpMV: values (8, 4 or 2 B;
        none for a unit stream) + col_idxs + chunk metadata (x and y are
        counted by the caller)."""
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


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _put_values(values: np.ndarray, device: torch.device,
                dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Host values onto ``device`` in ``dtype`` (default: their own). hp
    passes ``torch.bfloat16`` for float32 host values that carry
    bf16-rounded numbers, so the cast is exact."""
    values = torch.from_numpy(np.ascontiguousarray(values))
    if dtype is not None:
        values = values.to(dtype)
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(
            f"device values must be one of {_VALUE_DTYPES}, not {values.dtype}"
        )
    return values.to(device)


def build_device_scs(
    scs: ScsData, device: torch.device, dtype: Optional[torch.dtype] = None,
    unit_values: bool = False,
) -> DeviceScs:
    """Host ScsData -> DeviceScs on ``device``, values in ``dtype``
    (default: the host values' own dtype).

    ``unit_values``: the matrix is all ones (every stored value is 1 or 0),
    so the value stream is dropped and the kernel sums x[col] over the
    valid slots (the counterpart of ``build_device_lane_tiles(
    unit_values=True)``, uspmv_tpu/ops/pallas_scs.py:353-371). A slot
    whose value is 0 is padding; its column becomes -1, as the TPU
    tables mark it with bit 15. Only float32 values are taken, as there."""
    col_idxs = scs.col_idxs.astype(np.int32)
    values = _put_values(scs.values, device, dtype)
    if unit_values:
        if values.dtype != torch.float32:
            raise ValueError("unit_values requires plain f32 tiles")
        valid = scs.values != 0
        if not np.all(scs.values[valid] == 1):
            raise ValueError("unit_values requires an all-ones matrix")
        col_idxs = np.where(valid, col_idxs, np.int32(-1))
        values = values.new_empty(0)
    return DeviceScs(
        chunk_ptrs=_put(scs.chunk_ptrs.astype(np.int32), device),
        chunk_lengths=_put(scs.chunk_lengths.astype(np.int32), device),
        col_idxs=_put(col_idxs, device),
        values=values,
        row_idxs=_put(scs.flat_row_idx(), device),
        C=scs.C,
        n_rows=scs.n_rows,
        n_rows_padded=scs.n_rows_padded,
        n_chunks=scs.n_chunks,
        n_elements=scs.n_elements,
        nnz=scs.nnz,
        x_len=int(col_idxs.max()) + 1 if scs.n_elements else 0,
        unit_vals=unit_values,
    )


# ------------------------------------------------------------ packed rows

# limits of one row group: csrc/scs_packed.cu runs a row per thread of a
# kThreads block and stages a group's products in shared memory, sized by
# the largest group (at most GROUP_MAX_ELEMS * 8 B = 32 KB)
GROUP_MAX_ROWS = 256
GROUP_MAX_ELEMS = 4096


@dataclasses.dataclass
class DevicePacked:
    """One precision's SCS matrix with its padding dropped: rows in the
    SCS's permuted order, each row's elements contiguous in the order the
    SCS holds them (running column position j), cut into consecutive row
    groups of at most GROUP_MAX_ROWS rows and GROUP_MAX_ELEMS elements."""

    row_ptr: torch.Tensor  # int32 [n_rows_padded + 1]
    col_idxs: torch.Tensor  # int32 [nnz]
    values: torch.Tensor  # [nnz]: float64, float32 or bfloat16
    # int32 [n_groups, 4]: (first row, end row, first element, end element)
    # of each group, the one 16 B record the kernel reads per group
    groups: torch.Tensor
    row_idxs: torch.Tensor  # int32 [nnz], permuted row of each element

    n_rows: int
    n_rows_padded: int
    n_groups: int
    nnz: int
    x_len: int
    max_group_elems: int  # elements of the largest group (the stage size)

    @property
    def device(self) -> torch.device:
        return self.values.device

    def stream_bytes(self) -> int:
        """Matrix bytes the kernel streams per SpMV: values + col_idxs +
        row pointers + the group records."""
        return sum(
            t.numel() * t.element_size()
            for t in (self.values, self.col_idxs, self.row_ptr, self.groups)
        )

    @property
    def device_beta(self) -> float:
        """No padding is stored or streamed."""
        return 1.0


def row_groups(row_ptr: np.ndarray, max_rows: int = GROUP_MAX_ROWS,
               max_elems: int = GROUP_MAX_ELEMS) -> np.ndarray:
    """Cut rows 0..n into consecutive groups, each the longest run of at
    most ``max_rows`` rows holding at most ``max_elems`` elements. Returns
    the first row of every group and n at the end."""
    n = row_ptr.size - 1
    if n == 0:
        return np.zeros(1, dtype=np.int32)
    # where a group that starts at row s must end at the latest
    by_elems = np.searchsorted(row_ptr, row_ptr[:-1] + max_elems,
                               side="right") - 1
    stop = np.minimum(np.minimum(np.arange(n) + max_rows, n), by_elems)
    too_long = np.flatnonzero(stop <= np.arange(n))
    if too_long.size:
        r = int(too_long[0])
        raise ValueError(
            f"row {r} (permuted order) holds {int(row_ptr[r + 1] - row_ptr[r])} "
            f"elements, more than the {max_elems} one row group stages; "
            "split heavy rows first (split_rows_threshold >= 0)"
        )
    cuts = [0]
    while cuts[-1] < n:  # one step per group, not per row
        cuts.append(int(stop[cuts[-1]]))
    return np.asarray(cuts, dtype=np.int32)


def build_device_packed(
    scs: ScsData, device: torch.device, dtype: Optional[torch.dtype] = None
) -> DevicePacked:
    """Host ScsData -> DevicePacked on ``device``: the stored elements of
    every permuted row r = c*C + i, j = 0..count-1, gathered from
    ``chunk_ptrs[c] + j*C + i``. Raises when a row exceeds a group's
    element capacity."""
    if scs.row_counts_new is None:
        raise ValueError("packing needs ScsData.row_counts_new")
    counts = scs.row_counts_new.astype(np.int64)
    row_ptr = np.zeros(scs.n_rows_padded + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    group_ptr = row_groups(row_ptr)
    rows = np.repeat(np.arange(scs.n_rows_padded, dtype=np.int64), counts)
    j = np.arange(rows.size, dtype=np.int64) - row_ptr[rows]
    src = scs.chunk_ptrs[rows // scs.C].astype(np.int64) + j * scs.C \
        + rows % scs.C
    col_idxs = scs.col_idxs[src].astype(np.int32)
    groups = group_records(row_ptr, group_ptr)
    return DevicePacked(
        row_ptr=_put(row_ptr.astype(np.int32), device),
        col_idxs=_put(col_idxs, device),
        values=_put_values(scs.values[src], device, dtype),
        groups=_put(groups, device),
        row_idxs=_put(rows.astype(np.int32), device),
        n_rows=scs.n_rows,
        n_rows_padded=scs.n_rows_padded,
        n_groups=group_ptr.size - 1,
        nnz=int(rows.size),
        x_len=int(col_idxs.max()) + 1 if rows.size else 0,
        max_group_elems=int((groups[:, 3] - groups[:, 2]).max(initial=0)),
    )


def group_records(row_ptr: np.ndarray, group_ptr: np.ndarray) -> np.ndarray:
    """int32 [n_groups, 4]: (first row, end row, first element, end
    element) of each group of ``row_groups``."""
    return np.stack([group_ptr[:-1], group_ptr[1:], row_ptr[group_ptr[:-1]],
                     row_ptr[group_ptr[1:]]], axis=1).astype(np.int32)


# ------------------------------------------------------- heavy-row pieces


@dataclasses.dataclass
class DevicePieces:
    """The virtual rows ("pieces") of one precision's split heavy rows as
    a CSR stream, with each parent's consecutive run of pieces. Pieces that
    hold no element of this precision are left out."""

    piece_ptr: torch.Tensor  # int32 [n_pieces + 1]
    col_idxs: torch.Tensor  # int32 [nnz], permuted like the SCS columns
    values: torch.Tensor  # [nnz]: float64, float32 or bfloat16
    parent_ptr: torch.Tensor  # int32 [n_parents + 1], runs of pieces
    parent_row: torch.Tensor  # int32 [n_parents], permuted row, each once
    # one partial sum per (vector, piece), written and read by the kernels
    partials: torch.Tensor  # [n_vec, n_pieces] in the accumulator dtype
    piece_idxs: torch.Tensor  # int32 [nnz], piece of each element (plain)
    piece_rows: torch.Tensor  # int32 [n_pieces], parent's row (plain)

    n_pieces: int
    n_parents: int
    nnz: int
    n_rows_padded: int
    x_len: int

    @property
    def device(self) -> torch.device:
        return self.values.device

    def stream_bytes(self) -> int:
        """Bytes both kernels move per vector: the CSR stream once, the
        parents' runs, and each partial sum written and read once."""
        part = self.n_pieces * self.partials.element_size()
        return 2 * part + sum(
            t.numel() * t.element_size()
            for t in (self.values, self.col_idxs, self.piece_ptr,
                      self.parent_ptr, self.parent_row)
        )

    @property
    def device_beta(self) -> float:
        return 1.0


def build_device_pieces(
    piece_ids: np.ndarray,
    col_idxs: np.ndarray,
    values: np.ndarray,
    piece_parent_row: np.ndarray,
    n_rows_padded: int,
    device: torch.device,
    dtype: Optional[torch.dtype] = None,
    acc_dtype: Optional[torch.dtype] = None,
    n_vec: int = 1,
) -> DevicePieces:
    """Elements (piece id, permuted column, value) of the virtual rows ->
    DevicePieces. ``piece_parent_row[v]`` is the permuted row of virtual
    row v's parent; the virtual rows of one parent are consecutive ids
    (``split_heavy_rows``). Element order within a piece is kept.
    ``acc_dtype`` and ``n_vec`` size the partial sums (default: one vector
    of the values' dtype, float32 for bfloat16)."""
    piece_ids = np.asarray(piece_ids, dtype=np.int64)
    order = np.argsort(piece_ids, kind="stable")
    present, counts = np.unique(piece_ids, return_counts=True)
    piece_ptr = np.zeros(present.size + 1, dtype=np.int64)
    np.cumsum(counts, out=piece_ptr[1:])
    piece_rows = np.asarray(piece_parent_row, dtype=np.int64)[present]
    first = np.flatnonzero(
        np.concatenate(([True], piece_rows[1:] != piece_rows[:-1]))
    ) if present.size else np.zeros(0, dtype=np.int64)
    parent_row = piece_rows[first]
    if np.unique(parent_row).size != parent_row.size:
        raise ValueError("the pieces of one parent must be consecutive")
    if parent_row.size and not (0 <= parent_row.min()
                                and parent_row.max() < n_rows_padded):
        raise ValueError("a parent row lies outside the padded rows")
    cols = np.asarray(col_idxs)[order].astype(np.int32)
    dev_values = _put_values(np.asarray(values)[order], device, dtype)
    if acc_dtype is None:
        acc_dtype = (torch.float32 if dev_values.dtype == torch.bfloat16
                     else dev_values.dtype)
    return DevicePieces(
        piece_ptr=_put(piece_ptr.astype(np.int32), device),
        col_idxs=_put(cols, device),
        values=dev_values,
        parent_ptr=_put(np.append(first, present.size).astype(np.int32),
                        device),
        parent_row=_put(parent_row.astype(np.int32), device),
        partials=torch.zeros((max(int(n_vec), 1), present.size),
                             dtype=acc_dtype, device=device),
        piece_idxs=_put(np.repeat(np.arange(present.size, dtype=np.int32),
                                  counts), device),
        piece_rows=_put(piece_rows.astype(np.int32), device),
        n_pieces=int(present.size),
        n_parents=int(parent_row.size),
        nnz=int(cols.size),
        n_rows_padded=int(n_rows_padded),
        x_len=int(cols.max()) + 1 if cols.size else 0,
    )
