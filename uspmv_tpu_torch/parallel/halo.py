"""Halo (ghost-element) analysis: the communication plan of a row split.

Port of ``uspmv_tpu/parallel/halo.py`` (the reference's three-phase
analyzer, mpi_funcs.hpp:111-415, 1061-1124), bit for bit:

  1. scan each shard's column indices, classify local vs remote by the
     work-sharing boundaries, deduplicate the remote columns, record their
     owner shard, and renumber them into a halo region appended after the
     shard's local (padded) rows;
  2. derive who sends what (the plan is built on the host for all shards);
  3. the send index lists per (source, destination) pair.

The plan is static: ring offsets d = 1..R-1, each with gather indices into
the sender's permuted x (reference pack_send_buf,
classes_structs.hpp:786-855) and scatter indices into the receiver's halo
region (reference Irecv into &local_x[halo offset],
classes_structs.hpp:876-926), padded to the largest count of the offset;
padding lanes scatter into a dump slot at index H. The port runs the
exchange as one device-side copy of the real lanes
(ops/halo_exchange.py, parallel/distributed.py); across processes, the
lanes between two processes go through a packed buffer
(``split_exchange_rows``).

Halo columns are numbered in ascending global column order, which is
owner-grouped because work_sharing is sorted (the reference numbers them in
first-encounter order; results do not depend on it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..formats.scs import ScsData


@dataclasses.dataclass
class HaloPlan:
    n_shards: int
    work_sharing: np.ndarray  # [R+1] global row boundaries
    n_rows_padded: List[int]  # per shard (local SCS padded rows)
    halo_counts: List[int]  # per shard: total remote columns needed
    H: int  # common x length (max local_padded + halo); dump slot at H
    # per active ring offset d: gather/scatter index matrices [R, max_d]
    offsets: List[int]
    send_gather_idx: Dict[int, np.ndarray]
    recv_scatter_idx: Dict[int, np.ndarray]
    recv_counts: np.ndarray  # [R, R] recv_counts[r, o] = elems r needs from o
    # per-shard padded send-count per offset (real, for comm-volume report)
    real_counts: Dict[int, np.ndarray]
    # per-shard ascending GLOBAL columns living in the halo region (the
    # order they occupy [n_rows_padded_r, n_rows_padded_r + halo_r));
    # callers use it to locate extra_cols (the heavy-row pieces' columns)
    halo_cols: Optional[List[np.ndarray]] = None

    @property
    def comm_volume_per_spmv(self) -> int:
        """Total halo elements received per SpMV across all shards
        (reference -print_comm_vol, main.cpp:822,844-851)."""
        return int(sum(self.halo_counts))

    @property
    def padded_comm_volume_per_spmv(self) -> int:
        """Elements actually moved by the padded static collectives
        (reports real vs padded volume, SURVEY.md §7 hard parts)."""
        return int(
            sum(self.send_gather_idx[d].size for d in self.offsets)
        )


def build_halo_plan(
    scs_list: List[ScsData],
    work_sharing: np.ndarray,
    renumber: bool = True,
    extra_cols: Optional[List[np.ndarray]] = None,
) -> HaloPlan:
    """Analyze per-shard SCS structs whose col_idxs are GLOBAL, build the
    exchange plan, and (if ``renumber``) rewrite col_idxs in place to the
    local layout: [0, n_rows_padded) = own permuted rows,
    [n_rows_padded, n_rows_padded + halo) = halo in ascending-global-col
    order. Structural padding elements are pointed at local slot 0
    (their values are zero).

    ``extra_cols`` (per shard, GLOBAL column ids) are folded into the
    needed-set even though the SCS does not reference them: the columns
    of the shard's heavy-row pieces, a stream of their own beside the SCS
    (ops/scs_pieces.py). Their positions are recoverable from
    ``HaloPlan.halo_cols`` (remote) or the shard's own permutation
    (local)."""
    R = len(scs_list)
    ws = np.asarray(work_sharing, dtype=np.int64)
    assert ws.shape[0] == R + 1

    needed: List[List[np.ndarray]] = [[None] * R for _ in range(R)]
    halo_counts: List[int] = []
    n_rows_padded = [s.n_rows_padded for s in scs_list]
    recv_counts = np.zeros((R, R), dtype=np.int64)

    urcs: List[np.ndarray] = []
    for r, scs in enumerate(scs_list):
        lo, hi = ws[r], ws[r + 1]
        pad = scs.padding_mask()
        cols = scs.col_idxs.astype(np.int64)
        local = (cols >= lo) & (cols < hi) & ~pad
        remote = ~pad & ~local
        rem_cols = cols[remote]
        if extra_cols is not None and extra_cols[r] is not None:
            ex = np.asarray(extra_cols[r], dtype=np.int64)
            ex = ex[(ex < lo) | (ex >= hi)]
            rem_cols = np.concatenate([rem_cols, ex])
        urc = np.unique(rem_cols)
        urcs.append(urc)
        halo_counts.append(int(urc.size))
        owners = np.searchsorted(ws, urc, side="right") - 1
        for o in range(R):
            seg = urc[owners == o]
            needed[r][o] = seg
            recv_counts[r, o] = seg.size

        if renumber:
            new_cols = np.zeros(scs.n_elements, dtype=np.int32)
            new_cols[local] = scs.old_to_new_idx[cols[local] - lo]
            new_cols[remote] = (
                scs.n_rows_padded
                + np.searchsorted(urc, cols[remote])
            ).astype(np.int32)
            scs.col_idxs = new_cols

    H = max(
        n_rows_padded[r] + halo_counts[r] for r in range(R)
    ) if R else 0

    offsets: List[int] = []
    send_gather_idx: Dict[int, np.ndarray] = {}
    recv_scatter_idx: Dict[int, np.ndarray] = {}
    real_counts: Dict[int, np.ndarray] = {}
    for d in range(1, R):
        cnts = np.array(
            [needed[(r + d) % R][r].size for r in range(R)], dtype=np.int64
        )
        # cnts[r] = elements shard r sends to (r+d)%R
        max_d = int(cnts.max())
        if max_d == 0:
            continue
        offsets.append(d)
        gath = np.zeros((R, max_d), dtype=np.int32)
        scat = np.full((R, max_d), H, dtype=np.int32)  # default: dump slot
        for r in range(R):
            dst = (r + d) % R
            src = (r - d) % R
            # what r sends to dst: dst's needed columns owned by r,
            # translated into r's permuted x positions
            seg = needed[dst][r]
            if seg.size:
                gath[r, : seg.size] = scs_list[r].old_to_new_idx[seg - ws[r]]
            # what r receives from src: lands in r's halo at the position
            # of src's segment within r's ascending halo ordering
            seg_in = needed[r][src]
            if seg_in.size:
                start = n_rows_padded[r] + int(
                    np.searchsorted(urcs[r], seg_in[0])
                )
                scat[r, : seg_in.size] = start + np.arange(
                    seg_in.size, dtype=np.int32
                )
        send_gather_idx[d] = gath
        recv_scatter_idx[d] = scat
        real_counts[d] = cnts

    return HaloPlan(
        n_shards=R,
        work_sharing=ws,
        n_rows_padded=n_rows_padded,
        halo_counts=halo_counts,
        H=H,
        offsets=offsets,
        send_gather_idx=send_gather_idx,
        recv_scatter_idx=recv_scatter_idx,
        recv_counts=recv_counts,
        real_counts=real_counts,
        halo_cols=urcs,
    )


def build_allgather_col_map(
    scs_list: List[ScsData],
    work_sharing: np.ndarray,
    stride: int,
) -> None:
    """Alternative 'allgather' mode: keep no halo; renumber every global
    column c to ``owner*stride + owner_perm[c - ws[owner]]`` so the kernel
    can gather straight from the all-gathered concatenation of per-shard
    permuted x blocks (each padded to ``stride``). Rewrites col_idxs in
    place. Structural padding points at slot 0."""
    ws = np.asarray(work_sharing, dtype=np.int64)
    for r, scs in enumerate(scs_list):
        pad = scs.padding_mask()
        cols = scs.col_idxs.astype(np.int64)
        owners = np.searchsorted(ws, cols, side="right") - 1
        owners = np.clip(owners, 0, len(scs_list) - 1)
        new_cols = np.zeros(scs.n_elements, dtype=np.int32)
        for o in range(len(scs_list)):
            m = (owners == o) & ~pad
            if m.any():
                new_cols[m] = (
                    o * stride
                    + scs_list[o].old_to_new_idx[cols[m] - ws[o]]
                ).astype(np.int32)
        scs.col_idxs = new_cols


def _exchange_pairs(plan: HaloPlan, no_pack: bool = False):
    """The real lanes of the plan, in one fixed order: for every active
    offset d and receiving shard r, (s = (r - d) % R, r, the rows of s's
    buffer it sends, the rows of r's buffer they land in). ``no_pack``
    sends s's rows 0..count-1 in place of its gather indices."""
    R = plan.n_shards
    for d in plan.offsets:
        gather = plan.send_gather_idx[d]
        scatter = plan.recv_scatter_idx[d]
        for r in range(R):
            s = (r - d) % R
            n = int(plan.real_counts[d][s])
            if n == 0:
                continue
            rows = (np.arange(n, dtype=np.int64) if no_pack
                    else gather[s, :n].astype(np.int64))
            yield s, r, rows, scatter[r, :n].astype(np.int64)


def _check_length(plan: HaloPlan, length: int) -> None:
    if length <= plan.H:
        raise ValueError(f"buffer length {length} must exceed H={plan.H}")


def _cat(parts) -> np.ndarray:
    return (np.concatenate(parts) if parts
            else np.zeros(0, dtype=np.int64))


def exchange_rows(
    plan: HaloPlan, length: int, no_pack: bool = False
):
    """The plan as (src, dst) rows of the shards' x buffers stacked into one
    of ``R * length`` rows (shard r's x at rows [r * length, (r+1) *
    length), length > H): for every active offset d and receiving shard r,
    the real lanes of what shard s = (r - d) % R sends, src from s's
    gather indices, dst at r's scatter indices. Padding lanes, which write
    the dump slot H in the JAX exchange, are left out. ``no_pack`` sends
    s's rows 0..count-1 in place of its gather indices (the reference's
    -no_pack; wrong results on purpose). Returns two int64 arrays."""
    _check_length(plan, length)
    src, dst = [], []
    for s, r, rows, scat in _exchange_pairs(plan, no_pack):
        src.append(s * length + rows)
        dst.append(r * length + scat)
    return _cat(src), _cat(dst)


def split_exchange_rows(
    plan: HaloPlan, length: int, owner: np.ndarray, me: int,
    no_pack: bool = False,
):
    """``exchange_rows`` for the shards of process ``me`` when shard r lives
    in process ``owner[r]`` (owners ascending: a process holds consecutive
    shards, stacked in shard order into its own buffer of ``length`` rows
    per shard). Returns (src, dst, send, recv):

      * src, dst: the pairs whose two shards both live in ``me``, as rows of
        its stacked buffer (one copy, as ``exchange_rows``);
      * send[q]: the rows of its buffer that ``me`` sends to process q;
      * recv[q]: the rows of its buffer that take what q sends to ``me``.

    Every process walks the same pairs in the same order (offset d, then
    receiver r), so q's ``send[me]`` and ``me``'s ``recv[q]`` list the same
    rows in the same order. Applied together over every process, the parts
    equal the one-process exchange."""
    _check_length(plan, length)
    owner = np.asarray(owner, dtype=np.int64)
    n_proc = int(owner.max()) + 1 if owner.size else 1
    # a shard's place in its process's stack (owners ascend)
    slot = np.arange(owner.size) - np.searchsorted(owner, owner)
    src, dst = [], []
    send = [[] for _ in range(n_proc)]
    recv = [[] for _ in range(n_proc)]
    for s, r, rows, scat in _exchange_pairs(plan, no_pack):
        qs, qr = int(owner[s]), int(owner[r])
        if qs == me and qr == me:
            src.append(slot[s] * length + rows)
            dst.append(slot[r] * length + scat)
        elif qs == me:
            send[qr].append(slot[s] * length + rows)
        elif qr == me:
            recv[qs].append(slot[r] * length + scat)
    return (_cat(src), _cat(dst), [_cat(p) for p in send],
            [_cat(p) for p in recv])


def group_pair_counts(plan: HaloPlan, group_of: np.ndarray) -> np.ndarray:
    """[G, G] rows of the exchange that move from group g to another group
    h when shard r lives in group ``group_of[r]`` (ascending, G groups):
    what ``split_exchange_rows(plan, length, group_of, g)`` sends to h,
    counted for every pair of groups at once. The diagonal is zero."""
    group_of = np.asarray(group_of, dtype=np.int64)
    G = int(group_of.max()) + 1 if group_of.size else 1
    out = np.zeros((G, G), dtype=np.int64)
    R = plan.n_shards
    for d in plan.offsets:
        for s in range(R):
            g, h = int(group_of[s]), int(group_of[(s + d) % R])
            if g != h:
                out[g, h] += int(plan.real_counts[d][s])
    return out
