"""1-D row partitioning of a matrix over R shards.

Port of ``uspmv_tpu/parallel/partition.py`` (the reference's
seg_work_sharing_arr, mpi_funcs.hpp:424-622): ``work_sharing[R+1]``, the
global row boundaries of the shards.

  seg-rows  : equal row counts                          (:446-465)
  seg-nnz   : boundaries every nnz/R nonzeros           (:466-493)
  seg-metis : graph partitioning. The reference calls METIS_PartGraphKway
              and turns the partition vector into a global symmetric
              permutation (:494-598). Without METIS, three candidate
              orderings -- natural, Cuthill-McKee, and a greedy
              graph-growing k-way partition with FM-style boundary
              refinement -- each get an nnz-balanced contiguous split, their
              halo volumes are measured, and the cheapest wins. The caller
              receives a global permutation to apply symmetrically and to
              invert when gathering results.

Host-side numpy; every function returns the JAX package's arrays bit for
bit for the same input.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..formats.coo import MtxData


def _seg_rows(n_rows: int, n_shards: int) -> np.ndarray:
    ws = np.linspace(0, n_rows, n_shards + 1).astype(np.int64)
    return ws


def _seg_nnz(mtx: MtxData, n_shards: int) -> np.ndarray:
    counts = np.bincount(mtx.I, minlength=mtx.n_rows).astype(np.int64)
    cum = np.concatenate(([0], np.cumsum(counts)))
    targets = np.arange(1, n_shards) * (mtx.nnz / n_shards)
    inner = np.searchsorted(cum, targets, side="left")
    ws = np.concatenate(([0], inner, [mtx.n_rows])).astype(np.int64)
    # guard against empty shards (reference guards the empty last rank,
    # mpi_funcs.hpp:602-606). Two passes: force strict increase forward,
    # then clamp backward so every LATER shard can still get >= 1 row
    # (nnz concentrated in the last rows would otherwise push an inner
    # boundary to n_rows and leave trailing shards empty).
    for r in range(1, n_shards + 1):
        ws[r] = max(ws[r], ws[r - 1] + 1)
    for r in range(n_shards, -1, -1):
        ws[r] = min(ws[r], mtx.n_rows - (n_shards - r))
    ws[0] = 0
    return ws


def cuthill_mckee_permutation(mtx: MtxData) -> np.ndarray:
    """Symmetric Cuthill-McKee ordering of the (symmetrized) pattern.
    Returns perm with perm[old] = new. Uses scipy's RCM (reversed back to
    plain CM ordering is unnecessary — RCM is standard)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    A = sp.csr_matrix(
        (np.ones(mtx.nnz, dtype=np.int8), (mtx.I, mtx.J)),
        shape=(mtx.n_rows, mtx.n_cols),
    )
    A = A + A.T
    order = reverse_cuthill_mckee(A.tocsr(), symmetric_mode=True)
    perm = np.empty(mtx.n_rows, dtype=np.int32)
    perm[order] = np.arange(mtx.n_rows, dtype=np.int32)
    return perm


def _sym_csr(mtx: MtxData):
    """Symmetrized pattern CSR (indptr, indices) without self-loops."""
    import scipy.sparse as sp

    n = max(mtx.n_rows, mtx.n_cols)
    A = sp.csr_matrix(
        (np.ones(mtx.nnz, dtype=np.int8), (mtx.I, mtx.J)), shape=(n, n)
    )
    A = A + A.T
    A.setdiag(0)
    A.eliminate_zeros()
    A = A.tocsr()
    return A.indptr.astype(np.int64), A.indices.astype(np.int64)


def greedy_graph_growing(
    mtx: MtxData, n_shards: int, refine_passes: int = 4
) -> np.ndarray:
    """Dependency-free k-way partition: greedy graph growing + FM-style
    boundary refinement. Returns part[row] in [0, n_shards).

    The stand-in for METIS_PartGraphKway (reference mpi_funcs.hpp:494-598):
    each part is grown by repeatedly absorbing the frontier vertex with the
    highest gain (neighbors inside minus neighbors outside — the classic
    GGGP rule), seeded from a minimum-degree unassigned vertex, until it
    holds ~nnz/n_shards work. A few refinement passes then move boundary
    vertices to their majority-neighbor part when the cut shrinks and the
    balance budget (10%) allows."""
    import heapq

    indptr, indices = _sym_csr(mtx)
    n = mtx.n_rows
    w = np.bincount(mtx.I, minlength=n).astype(np.int64) + 1  # row work
    total = int(w.sum())
    part = np.full(n, -1, dtype=np.int32)
    degree = np.diff(indptr)

    order_by_degree = np.argsort(degree, kind="stable")
    seed_cursor = 0
    for p in range(n_shards):
        target = (total - int(w[part >= 0].sum())) // (n_shards - p)
        # seed: lowest-degree unassigned vertex (peripheral)
        while (seed_cursor < n
               and part[order_by_degree[seed_cursor]] >= 0):
            seed_cursor += 1
        if seed_cursor >= n:
            break
        seed = int(order_by_degree[seed_cursor])
        heap = [(-0, seed)]  # (-gain, vertex), lazy deletion
        in_heap_gain = {seed: 0}
        size = 0
        while heap and size < target:
            g, v = heapq.heappop(heap)
            if part[v] >= 0 or in_heap_gain.get(v) != -g:
                continue  # stale entry
            part[v] = p
            size += int(w[v])
            for u in indices[indptr[v]:indptr[v + 1]]:
                if part[u] >= 0:
                    continue
                gain = in_heap_gain.get(u, -int(degree[u])) + 2
                in_heap_gain[u] = gain
                heapq.heappush(heap, (-gain, u))
    part[part < 0] = n_shards - 1  # leftovers (disconnected tail)

    # FM-style refinement: vectorized passes over boundary vertices
    cap = int(1.1 * total / n_shards)
    for _ in range(refine_passes):
        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        link = np.zeros((n, n_shards), dtype=np.int32)
        np.add.at(link, (src, part[indices]), 1)
        own = link[np.arange(n), part]
        best_other = np.array(link, copy=True)
        best_other[np.arange(n), part] = -1
        cand = best_other.argmax(axis=1).astype(np.int32)
        gain = best_other[np.arange(n), cand] - own
        movers = np.flatnonzero(gain > 0)
        if movers.size == 0:
            break
        # apply in descending gain, respecting the balance cap greedily
        movers = movers[np.argsort(-gain[movers], kind="stable")]
        sizes = np.bincount(part, weights=w, minlength=n_shards)
        moved = 0
        for v in movers:
            d = int(cand[v])
            if sizes[d] + w[v] > cap or sizes[part[v]] - w[v] <= 0:
                continue
            sizes[d] += w[v]
            sizes[part[v]] -= w[v]
            part[v] = d
            moved += 1
        if moved == 0:
            break
    return part


def partition_to_permutation(part: np.ndarray) -> np.ndarray:
    """Stable grouping of rows by part — the reference's
    'partition vector -> global symmetric permutation' step
    (mpi_funcs.hpp:544-598). perm[old] = new; natural order is preserved
    within each part (keeps intra-shard locality for the kernels)."""
    order = np.argsort(part, kind="stable")
    perm = np.empty(part.size, dtype=np.int64)
    perm[order] = np.arange(part.size, dtype=np.int64)
    return perm


def halo_comm_volume(mtx: MtxData, ws: np.ndarray) -> int:
    """Halo elements received per SpMV for a contiguous row split:
    per shard, the number of DISTINCT off-shard columns touched (what the
    bulkvec exchange actually ships; halo.py, reference -print_comm_vol)."""
    total = 0
    order = np.argsort(mtx.I, kind="stable")
    I = mtx.I[order]
    J = mtx.J[order]
    starts = np.searchsorted(I, ws)
    for r in range(len(ws) - 1):
        cols = np.unique(J[starts[r]:starts[r + 1]])
        lo, hi = int(ws[r]), int(ws[r + 1])
        total += int(((cols < lo) | (cols >= hi)).sum())
    return total


def seg_work_sharing(
    mtx: MtxData, n_shards: int, method: str = "seg-rows"
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (work_sharing[n_shards+1], global_perm or None).

    When a permutation is returned (seg-metis), the caller must permute the
    matrix symmetrically before slicing, and un-permute gathered results
    (reference main.cpp:995-1003).
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if mtx.n_rows < n_shards:
        raise ValueError(
            f"cannot partition {mtx.n_rows} rows over {n_shards} shards "
            "(every shard needs at least one row); reduce n_shards"
        )
    if method == "seg-rows":
        return _seg_rows(mtx.n_rows, n_shards), None
    if method == "seg-nnz":
        return _seg_nnz(mtx, n_shards), None
    if method == "seg-metis":
        # three dependency-free candidates, judged by the real objective
        # (halo volume of the resulting contiguous split); the reference
        # trusts METIS here — we trust the measurement instead
        candidates: list = [(None, _seg_nnz(mtx, n_shards))]
        rcm = cuthill_mckee_permutation(mtx).astype(np.int64)
        m_rcm = mtx.permute(rcm, None).sort_by_row()
        candidates.append((rcm, _seg_nnz(m_rcm, n_shards)))
        ggg = partition_to_permutation(greedy_graph_growing(mtx, n_shards))
        m_ggg = mtx.permute(ggg, None).sort_by_row()
        candidates.append((ggg, _seg_nnz(m_ggg, n_shards)))
        best, best_vol = None, None
        for perm, ws in candidates:
            m = (mtx if perm is None
                 else mtx.permute(perm, None).sort_by_row())
            vol = halo_comm_volume(m, ws)
            if best_vol is None or vol < best_vol:
                best, best_vol = (perm, ws), vol
        return best[1], best[0]
    raise ValueError(f"unknown seg method {method!r}")
