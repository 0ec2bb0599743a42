"""SELL-C-sigma (SCS) storage format.

Port of ``uspmv_tpu/formats/scs.py`` (reference ``ScsData`` +
``convert_to_scs``, classes_structs.hpp:1313-1470, utilities.hpp:1842-2104):
sigma-window descending-nnz row sort, chunk padding, column-major element
layout within a chunk, and an optional fixed permutation. Host-side numpy,
or the C++ converter of ``native/uspmv_host.cpp`` (``uspmv_tpu_torch
.native``); every array comes out bit-equal to the JAX package's.

The JAX package's ``CompactScs`` and ``convert_to_scs_retiled`` are TPU
lane-tile packing artefacts and are not ported: the CUDA kernel reads this
layout directly, at the user's (C, sigma).

Values keep the dtype of the COO they come from; hp values are float32
arrays of bf16-rounded values (config.host_values), which the device format
casts to bfloat16 exactly.

Degenerate cases (reference README): C=1, sigma=1 => CRS; C=n_rows => ELL;
sigma=1, C>1 => SELL-P.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .coo import MtxData


@dataclasses.dataclass
class ScsData:
    """SELL-C-sigma matrix (reference ScsData, classes_structs.hpp:1313).

    Element ``e`` of chunk ``c`` at row-slot ``i`` (0 <= i < C) and running
    column position ``j`` lives at flat index
    ``chunk_ptrs[c] + j*C + i`` — column-major within the chunk.
    """

    C: int
    sigma: int
    n_rows: int
    n_rows_padded: int
    n_chunks: int
    n_elements: int  # nnz + explicit zero padding
    nnz: int
    chunk_ptrs: np.ndarray  # int32 [n_chunks + 1]
    chunk_lengths: np.ndarray  # int32 [n_chunks]
    col_idxs: np.ndarray  # int32 [n_elements]
    values: np.ndarray  # [n_elements]
    old_to_new_idx: np.ndarray  # int32 [n_rows] -> [0, n_rows_padded)
    new_to_old_idx: np.ndarray  # int32 [n_rows_padded], -1 at padded slots
    n_cols: int = 0
    # nnz per *permuted* row — distinguishes structural zero-padding
    # elements from stored zeros
    row_counts_new: Optional[np.ndarray] = None

    @property
    def beta(self) -> float:
        """Fill efficiency nnz/n_elements (reference main.cpp:693)."""
        return self.nnz / self.n_elements if self.n_elements else 1.0

    def flat_row_idx(self) -> np.ndarray:
        """Permuted row index of every flat element (padding included)."""
        per_chunk = self.chunk_lengths.astype(np.int64) * self.C
        chunk = np.repeat(np.arange(self.n_chunks, dtype=np.int64), per_chunk)
        offset = np.arange(self.n_elements, dtype=np.int64) - np.repeat(
            self.chunk_ptrs[:-1].astype(np.int64), per_chunk
        )
        return (chunk * self.C + offset % self.C).astype(np.int32)

    def padding_mask(self) -> np.ndarray:
        """True at the structural padding elements: running column
        position j at or beyond the count of the element's row."""
        if self.row_counts_new is None:
            raise ValueError("row_counts_new not recorded for this ScsData")
        per_chunk = self.chunk_lengths.astype(np.int64) * self.C
        start = np.repeat(self.chunk_ptrs[:-1].astype(np.int64), per_chunk)
        j = (np.arange(self.n_elements, dtype=np.int64) - start) // self.C
        counts = self.row_counts_new.astype(np.int64)
        return j >= counts[self.flat_row_idx()]

    def spmv_reference(self, x: np.ndarray) -> np.ndarray:
        """Trivially-correct host SpMV in *permuted* row order, in float64.

        x is indexed by col_idxs directly (i.e. x must already be laid out
        in whatever order col_idxs refers to). Returns y[n_rows_padded].
        """
        x = np.asarray(x)
        y = np.zeros((self.n_rows_padded,) + x.shape[1:], dtype=np.float64)
        contrib = self.values.astype(np.float64)[
            (slice(None),) + (None,) * (x.ndim - 1)
        ] * x.astype(np.float64)[self.col_idxs]
        np.add.at(y, self.flat_row_idx(), contrib)
        return y

    def to_mtx(self, col_unperm=None) -> MtxData:
        """The stored nonzeros as COO in original row order, explicit
        padding dropped (``write_to_mtx_file``'s entries, in its order).

        ``col_unperm`` (new->old) inverts a prior symmetric column
        permutation (permute_scs_cols) so the columns are original indices.
        Padding elements hold value 0 and real zeros cannot be told from
        them, so (like the reference, which writes only the nonzeros it
        finds) exact zeros are dropped.
        """
        rows = self.flat_row_idx()
        keep = self.values.astype(np.float64) != 0.0
        keep &= self.new_to_old_idx[rows] >= 0
        orig_rows = self.new_to_old_idx[rows[keep]]
        cols = self.col_idxs[keep]
        if col_unperm is not None:
            cols = np.asarray(col_unperm, dtype=np.int32)[cols]
        return MtxData.from_arrays(orig_rows, cols, self.values[keep],
                                   n_rows=self.n_rows, n_cols=self.n_cols)

    def write_to_mtx_file(self, path: str, col_unperm=None) -> None:
        """Dump the (padded) SCS structure back to MatrixMarket, original row
        order, dropping explicit padding (reference OUTPUT_SPARSITY /
        ScsData::write_to_mtx_file, classes_structs.hpp:1758-1790): the
        JAX package's file byte for byte (``to_mtx`` for ``col_unperm``)."""
        from ..io.mmio import write_mtx

        write_mtx(path, self.to_mtx(col_unperm))


def scs_from_reference(fields: dict) -> ScsData:
    """The port's ``ScsData`` from the JAX package's, given as
    ``dataclasses.asdict(...)`` (numpy arrays and ints), so that both
    packages can run the very same SELL-C-sigma arrays."""
    return ScsData(
        **{
            k: (np.array(v) if isinstance(v, np.ndarray) else v)
            for k, v in fields.items()
        }
    )


def convert_to_scs(
    mtx: MtxData,
    C: int,
    sigma: int,
    dtype=None,
    fixed_permutation: Optional[np.ndarray] = None,
    native: Optional[bool] = None,
) -> ScsData:
    """COO -> SELL-C-sigma (reference convert_to_scs, utilities.hpp:1842-2104).

    ``native=None`` takes the C++ converter (``uspmv_tpu_torch.native``,
    built at first use) when the library can be built, else the numpy path
    below; True requires it (NativeUnavailableError); False forces numpy.
    Both give the same arrays.

    Steps:
      1. n_chunks = ceil(n_rows/C); pad rows to n_rows_padded = n_chunks*C
         with empty rows;
      2. per sigma-window [i, i+sigma) over the padded row range, sort rows
         by descending nnz, stable on the original index;
      3. or, if ``fixed_permutation`` (old->new) is given, use it verbatim;
      4. chunk_lengths[c] = max row length in chunk; chunk_ptrs = exclusive
         cumsum of chunk_lengths*C;
      5. scatter nonzeros to chunk_ptrs[c] + k*C + (row_new % C), preserving
         the input (row-sorted) order within each row; padding slots hold
         value 0 at column 0.
    """
    if C < 1 or sigma < 1:
        raise ValueError("C and sigma must be >= 1")
    if native is not False:
        from ..native import convert_to_scs_native

        out = convert_to_scs_native(mtx, C, sigma, dtype=dtype,
                                    fixed_permutation=fixed_permutation,
                                    required=bool(native))
        if out is not None:
            return out
    n_rows = mtx.n_rows
    n_chunks = (n_rows + C - 1) // C
    n_rows_padded = n_chunks * C

    counts = np.zeros(n_rows_padded, dtype=np.int64)
    if mtx.nnz:
        counts[:n_rows] = np.bincount(mtx.I, minlength=n_rows)[:n_rows]

    if fixed_permutation is not None:
        old_to_new = np.asarray(fixed_permutation, dtype=np.int32)
        if old_to_new.shape[0] < n_rows:
            raise ValueError("fixed_permutation shorter than n_rows")
        old_to_new = old_to_new[:n_rows]
        counts_new = np.zeros(n_rows_padded, dtype=np.int64)
        counts_new[old_to_new] = counts[:n_rows]
        counts_sorted = counts_new
    else:
        # one stable sort by (window, -count) gives the same order as a
        # stable descending sort inside each window
        window = np.arange(n_rows_padded, dtype=np.int64) // sigma
        order = np.lexsort((-counts, window))
        counts_sorted = counts[order]
        old_to_new = np.empty(n_rows_padded, dtype=np.int32)
        old_to_new[order] = np.arange(n_rows_padded, dtype=np.int32)
        old_to_new = old_to_new[:n_rows]

    chunk_lengths = (
        counts_sorted.reshape(n_chunks, C).max(axis=1).astype(np.int32)
    )
    chunk_ptrs = np.zeros(n_chunks + 1, dtype=np.int64)
    np.cumsum(chunk_lengths.astype(np.int64) * C, out=chunk_ptrs[1:])
    n_elements = int(chunk_ptrs[-1])
    if n_elements > np.iinfo(np.int32).max:
        raise OverflowError(
            "SCS element count exceeds int32 (reference overflow guard, "
            "utilities.hpp:105-190)"
        )
    chunk_ptrs = chunk_ptrs.astype(np.int32)

    out_dtype = dtype if dtype is not None else mtx.values.dtype
    values = np.zeros(n_elements, dtype=out_dtype)
    col_idxs = np.zeros(n_elements, dtype=np.int32)

    if mtx.nnz:
        rows_new = old_to_new[mtx.I].astype(np.int64)
        # occurrence index k of each element within its (new) row, input
        # order preserved within rows
        sort_e = np.argsort(rows_new, kind="stable")
        rs = rows_new[sort_e]
        boundaries = np.flatnonzero(np.diff(rs)) + 1
        starts = np.concatenate(([0], boundaries))
        group_id = np.zeros(rs.size, dtype=np.int64)
        group_id[boundaries] = 1
        group_id = np.cumsum(group_id)
        k_sorted = np.arange(rs.size, dtype=np.int64) - starts[group_id]
        k = np.empty(rs.size, dtype=np.int64)
        k[sort_e] = k_sorted

        idx = (
            chunk_ptrs[(rows_new // C)].astype(np.int64)
            + k * C
            + rows_new % C
        )
        values[idx] = mtx.values.astype(out_dtype)
        col_idxs[idx] = mtx.J

    new_to_old = np.full(n_rows_padded, -1, dtype=np.int32)
    new_to_old[old_to_new] = np.arange(n_rows, dtype=np.int32)

    return ScsData(
        C=int(C),
        sigma=int(sigma),
        n_rows=n_rows,
        n_rows_padded=n_rows_padded,
        n_chunks=n_chunks,
        n_elements=n_elements,
        nnz=mtx.nnz,
        chunk_ptrs=chunk_ptrs,
        chunk_lengths=chunk_lengths,
        col_idxs=col_idxs,
        values=values,
        old_to_new_idx=old_to_new.astype(np.int32),
        new_to_old_idx=new_to_old,
        n_cols=mtx.n_cols,
        row_counts_new=counts_sorted.astype(np.int32),
    )


def permute_scs_cols(scs: ScsData, perm: np.ndarray) -> None:
    """Symmetric column permutation: col_idxs[e] = perm[col_idxs[e]]
    (reference permute_scs_cols, utilities.hpp:1802-1831). ``perm`` must
    cover every column value present, including padding column 0 — padding
    values are zero so remapping the padding column is harmless."""
    scs.col_idxs = np.asarray(perm, dtype=np.int32)[scs.col_idxs]
