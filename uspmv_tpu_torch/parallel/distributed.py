"""Row-sharded SpMV with a halo exchange: ``DistributedSpmvOperator``.

Port of ``uspmv_tpu/parallel/distributed.py`` (the reference's MPI
execution model, SURVEY.md §2): a 1-D row partition (seg-rows, seg-nnz,
seg-metis; parallel/partition.py) into R shards; each shard's remote x
entries are deduplicated and renumbered into a halo appended after its
local (padded) rows (parallel/halo.py), and every SpMV fills the halos
from their owners before the rows that read them run.

The JAX operator is one SPMD program over a mesh of the first R devices,
its exchange a ``ppermute`` per ring offset. Here the R shards are spread
over card groups, each group a card and the shards it holds, with their own
structs and launches: the SELL-C-sigma or packed kernel of its rows (the
tier chosen per struct, as on one device), its heavy-row pieces, and, per
precision, one launch of the exchange kernel (ops/halo_exchange.py) that
copies every halo row whose owner is on the same card. A process holds D
shard slots (one process: D = R; across processes ``local_devices``) and G
= min(D, its cards) groups, ceil(D / G) slots each, slot i on group i // that
(``shard_cards``; cards past the last shard stay idle): in one process
``config.backend="cuda"`` takes the visible cards, across processes the
cards ``multihost.initialize`` gave the process (``CUDA_VISIBLE_DEVICES``
pins a run to fewer cards); with one card, every shard of the process runs
on the device ``config.backend`` names. The ``devices`` argument of
``from_mtx`` names the process's groups' devices itself (two groups may
share one: the tests' counterpart of the JAX virtual CPU mesh). Nothing
falls back to one card or to the CPU: ``backend="cuda"`` without a GPU
raises, where the JAX operator may fall back to a virtual CPU mesh.

x lives in its halo-extended form. The x buffers of a group's R_g shards
(L = H + 1 rows each; H: the plan's common length, the dump slot at H) are
stacked on its card:

    one vector [R_g, L]; rowwise block vectors [R_g, L, bs]; colwise
    [bs, R_g, L]

``make_x`` returns that tensor for one group and a tuple of them, one per
card, for several. ``spmv(x)`` fills the halo rows of x in place and writes
each shard's y into the local rows of a value of the same form, so a solve
swaps x and y with no copy, and ``to_host`` reads each shard's local rows.
Each adaptive precision has its own plan and L (its streams have their own
column sets); its buffer takes a copy of the local rows of x on every SpMV.
In ``comm_mode="allgather"`` there is no plan: x is [R_g, n_loc(, bs)],
every shard reads the whole x of all R shards, whose concatenation
``build_allgather_col_map`` addresses (on one group the stack itself; on
several, each card's copy of every group's rows), and no exchange runs.

Per shard and precision, in the JAX closure's order (distributed.py
:1003-1051): with ``overlap_comm`` the rows are split into an interior
part, which reads local rows only, and a halo part; the exchange runs on a
second CUDA stream while the interior launches run, and the halo part adds
into y after the join. Without it, the exchange first, then the rows.
The pieces add into y last (they may read halo rows). Precisions are
summed highest first: the first launch of a shard writes its y, the rest
add. ``comm_halos=False`` skips the exchange (halo rows stay zero: wrong
results on purpose); ``no_pack`` sends each sender's first rows in place
of the packed ones (the reference's -no_pack, wrong on purpose too).

The rows that cross groups go through a buffer of rows per group
(``DeviceTransfer``): the pack kernel gathers the rows a group sends,
grouped by destination, the unpack kernel scatters the rows it receives,
grouped by source. Between them, in one process, each sender's slice for
each receiver is copied into the receiver's buffer
(``ops.halo_exchange.peer_copy``: a peer copy between two cards) after
the packs, on the cards' second streams, beside the interior launches;
the current streams join them before the unpack, which orders the unpack
after every copy into it and the next pack after every copy out of it.
PyTorch runs a copy between two cards after the receiver's current
stream, so the copies follow one another (PERF.md, section 6, has what
other orders cost on four H100s). With the overlap the exchange inside a
card runs on its second stream too.
``transport()`` says how the copies travel: "peer" where every pair of
cards that exchanges rows has peer access, "host-staged" where one lacks it.

impl='xla' (or use_pallas=False) runs every launch's plain PyTorch version,
the exchange's too, on the chosen devices, in one stream per card.

Across processes (parallel/multihost.py) shard r lives in process ``r //
D`` (D = ``local_devices``, default ceil(R / P)), as the JAX mesh takes the
first R devices of its process-major global list, and inside the process on
its groups as above; the groups are numbered across the run, the earlier
processes' first (``run_cards``: every process learns the others' card
counts at build). Every process plans every shard on the host (partition,
splits, precisions, SCS, halo plans: the same bits everywhere) and builds
device structs for its own shards only. The rows between its groups move by
the peer copies above; the rows between processes by one
``all_to_all_single`` per precision on the process's lead card (its first
group's), staged through it (``StagePlan``): peer copies gather each
group's rows for each other process into the lead's send buffer, ordered by
destination process, and scatter the lead's receive buffer into each
group's after the transfer, on the second streams; where the process holds
one group its own buffers are the lead's and nothing is copied. Under NCCL
the transfer runs on the cards' tensors; under gloo through pinned host
buffers, copied out after the pack (and the staging) and in before the
unstaging and the unpack, the host waiting on the copy out before the
transfer. With the overlap the interior launches are enqueued before the
transfer; the halo parts and the pieces run after the unpack. In allgather
mode every process all-gathers its groups' local rows into the whole x of
each of its cards. ``to_host`` gathers every shard of every group of every
process (a collective: every process calls it and returns the whole y).
Under NCCL the pack, the staging, the all-to-all, its wait and the unpack
are captured with the rest of an SpMV into the CUDA graphs of a solve and of
the bench's batches, one graph per process over its cards
(runtime/operator.py); every process captures and replays in the same
order, and ``multihost.shutdown`` resets those graphs before the group goes
(NCCL does not destroy a communicator that a live graph uses). Over gloo a
solve and the bench run a loop of launches: a transfer through the host
cannot be captured in a CUDA graph. The metrics of the shards a process does
not hold come from the others' summaries, gathered once at build.

Not ported, as the ROADMAP lists: lane tiles and re-tiling, the
transpose-stream tier, the ±1 fold matrix and its prefix sums (the pieces
kernel folds), the df64 pairs (``-dp_emu`` runs native f64). Unlike the
JAX XLA path, heavy rows are split per shard, with the threshold of the
whole matrix.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import Config, dtype_for, host_values, numpy_dtype
from ..formats.coo import (
    MtxData,
    equilibrate_matrix,
    extract_matrix_min_mean_max,
    generate_inv_perm,
    jacobi_scale_matrix,
    split_heavy_rows,
)
from ..formats.scs import ScsData, convert_to_scs
from ..ops.device_format import (
    DevicePacked,
    DevicePieces,
    DeviceScs,
    build_device_packed,
    build_device_pieces,
    build_device_scs,
    vector_pass_count,
)
from ..ops.halo_exchange import (
    DeviceExchange,
    DeviceTransfer,
    PeerSlice,
    StagePlan,
    build_device_exchange,
    build_device_transfer,
    halo_exchange,
    halo_exchange_plain,
    halo_pack,
    halo_pack_plain,
    halo_unpack,
    halo_unpack_plain,
    peer_copy,
    peer_plan,
    stage_plan,
)
from ..ops.vectors import init_x_host
from ..precision.partition import partition_precisions
from ..runtime.operator import (
    OperatorBase,
    SOLVE_IMPLS,
    guard_scs_explosion,
    packed_tier,
    parts_of,
    real_rows,
    resolve_device,
    run_pieces,
    run_rows,
    split_threshold,
    write_sparsity,
)
from ..runtime import profiling
from . import multihost
from .halo import (
    HaloPlan,
    build_allgather_col_map,
    build_halo_plan,
    exchange_rows,
    group_pair_counts,
    split_exchange_rows,
)
from .partition import seg_work_sharing

Stream = Union[DeviceScs, DevicePacked]


def split_scs_for_overlap(scs: ScsData):
    """Split a halo-renumbered local SCS into (interior, halo) structs over
    the same permuted row space: the interior elements read local rows of
    x (column < n_rows_padded), the halo elements the halo rows. Port of
    the JAX ``_split_scs_for_overlap`` (distributed.py:121-142), bit for
    bit."""
    boundary = scs.n_rows_padded
    keep = ~scs.padding_mask()
    rows = scs.flat_row_idx()
    is_halo = keep & (scs.col_idxs >= boundary)
    is_int = keep & ~is_halo
    n_cols = max(int(scs.col_idxs.max(initial=0)) + 1, boundary)
    ident = np.arange(scs.n_rows_padded, dtype=np.int32)

    def build(mask):
        sub = MtxData.from_arrays(
            rows[mask], scs.col_idxs[mask], scs.values[mask],
            n_rows=scs.n_rows_padded, n_cols=n_cols,
        )
        return convert_to_scs(sub, scs.C, 1, fixed_permutation=ident)

    return build(is_int), build(is_halo)


@dataclasses.dataclass
class ShardStreams:
    """One shard's device streams of one precision."""

    main: Stream  # the interior part when overlapped, else every row
    halo: Optional[Stream] = None  # the halo-column part, when overlapped
    pieces: Optional[DevicePieces] = None  # its split heavy rows


@dataclasses.dataclass
class StreamSummary:
    """What the metrics read of one shard's streams of one precision. A
    process holds one for every shard: its own shards' from their device
    structs, the others' gathered from their processes at build."""

    packed: tuple  # per row stream (main, halo): packed row groups?
    nnz: int  # stored nonzeros of the row streams
    streamed: int  # elements they stream (packed: nnz; SELL: n_read)
    stream_bytes: int
    packed_bytes: int  # the packed streams' part of stream_bytes
    pieces_nnz: int = 0
    n_pieces: int = 0
    # the pieces' bytes per pass of <= 8 vectors and per vector
    # (DevicePieces.pass_bytes, vector_bytes)
    pieces_pass_bytes: int = 0
    pieces_vector_bytes: int = 0

    @classmethod
    def of(cls, sh: ShardStreams) -> "StreamSummary":
        devs = [d for d in (sh.main, sh.halo) if d is not None]
        pc = sh.pieces
        return cls(
            packed=tuple(isinstance(d, DevicePacked) for d in devs),
            nnz=sum(d.nnz for d in devs),
            streamed=sum(d.nnz if isinstance(d, DevicePacked)
                         else d.n_read for d in devs),
            stream_bytes=sum(d.stream_bytes() for d in devs),
            packed_bytes=sum(d.stream_bytes() for d in devs
                             if isinstance(d, DevicePacked)),
            pieces_nnz=pc.nnz if pc else 0,
            n_pieces=pc.n_pieces if pc else 0,
            pieces_pass_bytes=pc.pass_bytes() if pc else 0,
            pieces_vector_bytes=pc.vector_bytes() if pc else 0)


def shard_slots(R: int) -> int:
    """D, the shard slots of each process for R shards over the processes
    of the run (parallel/multihost.py): local_devices, or ceil(R / P);
    R outside a run of processes."""
    D = (multihost.info() or {}).get("n_local_devices")
    return D or -(-R // multihost.process_count())


def shard_owners(R: int) -> tuple:
    """(owner of each shard, this process's shards) for R shards over the
    processes of the run: shard r to process r // D (``shard_slots``); one
    process holds them all outside a run of processes. Raises where P * D
    < R (JAX: "need R devices") or a process would hold no shard."""
    P, me = multihost.process_count(), multihost.process_index()
    D = shard_slots(R)
    if R > P * D:
        raise ValueError(
            f"need {R} devices (shards), have {P * D}: {P} processes x "
            f"{D} (-local_devices)")
    owner = np.arange(R, dtype=np.int64) // D
    if int(owner[-1]) + 1 < P:
        raise ValueError(
            f"{R} shards at {D} per process leave processes "
            f"{int(owner[-1]) + 1}..{P - 1} without a shard")
    return owner, range(me * D, min((me + 1) * D, R))


def _allgather_cols(cols: np.ndarray, ws: np.ndarray,
                    perms: List[np.ndarray], stride: int) -> np.ndarray:
    """Global columns -> rows of the stacked x in allgather mode, as
    ``build_allgather_col_map`` maps the SCS columns."""
    owners = np.searchsorted(ws, cols, side="right") - 1
    out = np.zeros(cols.size, dtype=np.int64)
    for o in np.unique(owners):
        m = owners == o
        out[m] = o * stride + perms[o][cols[m] - ws[o]]
    return out


def _gather_summaries(own: Dict[str, Dict[int, StreamSummary]],
                      R: int) -> Dict[str, List[StreamSummary]]:
    """Per precision, every shard's summary: this process's own ``own``,
    merged with every other process's in a run of several (a
    collective)."""
    out = {p: [None] * R for p in own}
    for part in multihost.gather_object(own):
        for p, by_shard in part.items():
            for r, summ in by_shard.items():
                out[p][r] = summ
    return out


def _halo_cols(cols: np.ndarray, lo: int, hi: int, old_to_new: np.ndarray,
               n_rows_padded: int, halo_cols: np.ndarray) -> np.ndarray:
    """Global columns -> rows of one shard's halo-extended x, as
    ``build_halo_plan(renumber=True)`` maps the SCS columns."""
    local = (cols >= lo) & (cols < hi)
    out = np.empty(cols.size, dtype=np.int64)
    out[local] = old_to_new[cols[local] - lo]
    out[~local] = n_rows_padded + np.searchsorted(halo_cols, cols[~local])
    return out


def shard_cards(R: int, n_cards: int) -> np.ndarray:
    """The card group of each of R shards over ``n_cards`` cards of one
    process: G = min(R, n_cards), D = ceil(R / G), shard r on card r // D,
    the contiguous rule ``shard_owners`` applies to processes and the JAX
    mesh's order of its first R devices. Cards past the last shard stay
    idle (R=6 on 4 cards: D=2, cards 0-2)."""
    if R < 1 or n_cards < 1:
        raise ValueError(f"{R} shards over {n_cards} cards")
    D = -(-R // min(R, n_cards))
    return np.arange(R, dtype=np.int64) // D


def run_cards(owner: np.ndarray, D: int, n_cards: Sequence[int]
              ) -> np.ndarray:
    """The card group of each shard over the run, numbered across it: the
    shards ``owner`` gives process p (D shard slots each) spread over its
    ``n_cards[p]`` cards by ``shard_cards(D, n_cards[p])``, slot by slot
    (the JAX mesh's process-major order of its devices), and the groups of
    earlier processes counted first. In one process (owner all 0, D = R)
    this is ``shard_cards(R, n_cards[0])``."""
    card = np.empty(owner.size, dtype=np.int64)
    base = 0
    for p in range(int(owner[-1]) + 1):
        rows = np.flatnonzero(owner == p)
        local = shard_cards(D, n_cards[p])[rows - rows[0]]
        card[rows] = base + local
        base += int(local[-1]) + 1
    return card


def card_devices(config: Config, D: int,
                 devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of this process's card groups, which hold its D shard
    slots: ``devices`` as given (two groups may name the same device),
    else on the card the first min(D, cards) of its cards (in one process
    the visible cards, in a run of processes those ``multihost.initialize``
    gave it), else the one device ``config.backend`` names (which raises
    DeviceUnavailableError for backend "cuda" without a GPU, devices given
    or not)."""
    device = resolve_device(config)
    if devices is not None:
        if not devices:
            raise ValueError("devices= needs at least one device")
        return [torch.device(d) for d in devices]
    if device.type != "cuda":
        return [device]
    mh = multihost.info()
    cards = ([torch.device(d) for d in mh["devices"]] if mh is not None
             else [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())])
    cards = cards[:min(D, len(cards))]
    return cards if len(cards) > 1 else [device]


@dataclasses.dataclass
class CardGroup:
    """One card and the shards it holds: what one process holds in a run of
    processes, or one of several cards of one process."""

    index: int  # its number among the run's groups (the process's, across
    # processes)
    device: torch.device
    shards: range  # the shards it holds, stacked in this order
    # per precision, per shard of the group (in ``shards`` order)
    streams: Dict[str, List[ShardStreams]]
    # per precision: the pairs inside the group, and the rows that cross
    # groups (None where one group holds every shard)
    exchanges: Dict[str, Optional[DeviceExchange]]
    transfers: Dict[str, Optional[DeviceTransfer]]
    # x buffers of the precisions after the first (halo mode)
    xbufs: dict = dataclasses.field(default_factory=dict, repr=False)
    # per precision: the transfer's send and receive buffers
    tbufs: dict = dataclasses.field(default_factory=dict, repr=False)
    # allgather over several groups of one process: every shard's x
    whole: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                      repr=False)
    comm_stream: Optional[object] = dataclasses.field(default=None,
                                                      repr=False)

    def comm(self) -> "torch.cuda.Stream":
        """The card's second stream: the copies to and from other cards and
        the exchange, beside the interior launches."""
        if self.comm_stream is None:
            self.comm_stream = torch.cuda.Stream(device=self.device)
        return self.comm_stream

    def cur(self) -> "torch.cuda.Stream":
        return torch.cuda.current_stream(self.device)


@dataclasses.dataclass
class DistributedSpmvOperator(OperatorBase):
    """The sharded counterpart of ``SpmvOperator`` (same public surface)."""

    config: Config
    n_rows: int
    n_rows_padded: int  # n_loc: the largest local padded row count
    work_sharing: np.ndarray  # [R + 1] global row boundaries
    # per precision, per shard: the host SCS, columns renumbered
    scs: Dict[str, List[ScsData]]
    halo_plans: Dict[str, Optional[HaloPlan]]  # None in allgather mode
    lengths: Dict[str, int]  # L: rows of one shard's x buffer
    shard_perms: List[np.ndarray]  # per shard, old_to_new of its real rows
    global_perm: Optional[np.ndarray]  # seg-metis permutation, old -> new
    matrix_stats: tuple
    nnz: int
    device: torch.device  # the first group's
    # the card groups this process holds, in shard order
    groups: List[CardGroup] = dataclasses.field(default_factory=list)
    # per precision, per shard: what the metrics read of its streams
    summaries: Dict[str, List[StreamSummary]] = dataclasses.field(
        default_factory=dict)
    # the process of each shard, and its card group, numbered across the
    # run (the process, where every process holds one group)
    owner: Optional[np.ndarray] = None
    card: Optional[np.ndarray] = None
    # per precision: the moves between this process's groups
    peer: Dict[str, List[PeerSlice]] = dataclasses.field(
        default_factory=dict)
    # per precision, in a run of processes: the rows that cross processes,
    # staged through the lead card, and the lead's buffers for them
    stage: Dict[str, StagePlan] = dataclasses.field(default_factory=dict)
    lead: Dict[str, dict] = dataclasses.field(default_factory=dict,
                                              repr=False)
    overlap: bool = False
    split_threshold: int = 0
    n_dropped: int = 0
    jacobi_diag: Optional[np.ndarray] = None
    equilib: Optional[tuple] = None
    _solve_graphs: dict = dataclasses.field(default_factory=dict, repr=False)
    _batch_graphs: dict = dataclasses.field(default_factory=dict, repr=False)

    # ----------------------------------------------------------------- build

    @classmethod
    def from_mtx(cls, config: Config, mtx: MtxData,
                 devices: Optional[Sequence] = None
                 ) -> "DistributedSpmvOperator":
        """The operator of ``mtx`` under ``config``, its shards spread over
        the card groups of ``card_devices(config, D, devices)`` (D =
        ``shard_slots(R)``) and, in a run of processes, those of the
        others. Spans: ``dist.from_mtx`` and, inside it,
        ``dist.from_mtx.shard`` (each shard's host build: split, partition,
        conversion), ``dist.from_mtx.plan`` (the exchange plans) and
        ``dist.from_mtx.upload`` (the device streams)."""
        with profiling.span("dist.from_mtx"):
            return cls._from_mtx(config, mtx, devices)

    @classmethod
    def _from_mtx(cls, config: Config, mtx: MtxData,
                  devices: Optional[Sequence]) -> "DistributedSpmvOperator":
        config.validate()
        R = config.n_shards
        owner, shards = shard_owners(R)
        D = shard_slots(R)
        devs = card_devices(config, D, devices)
        # every process's cards (a collective in a run of processes), and
        # the group of each shard across the run
        card = run_cards(owner, D, multihost.gather_object(len(devs)))
        first = int(card[shards.start])
        placed = [(g, range(int(np.searchsorted(card, g)),
                            int(np.searchsorted(card, g, "right"))),
                   devs[g - first])
                  for g in range(first, int(card[shards.stop - 1]) + 1)]
        n_proc = int(owner[-1]) + 1
        n_groups = int(card[-1]) + 1  # over the whole run
        # the process of each group
        group_owner = owner[np.searchsorted(card, np.arange(n_groups))]
        mtx = mtx.copy()
        if not mtx.is_sorted:
            mtx = mtx.sort_by_row()
        stats = extract_matrix_min_mean_max(mtx)
        nnz = mtx.nnz

        ws, gperm = seg_work_sharing(mtx, R, config.seg_method)
        if gperm is not None:
            mtx = mtx.permute(gperm, None).sort_by_row()

        # scaling is per original row, global (the reference equilibrates
        # each rank's rows with local column maxima; the JAX operator and
        # this one scale the whole matrix: the same row scales)
        jac = jacobi_scale_matrix(mtx) if config.jacobi_scale else None
        equilib = lr = lc = None
        if config.equilibrate:
            lr, lc = equilibrate_matrix(mtx)
            equilib = (lr, lc)

        C = config.chunk_size if config.kernel_format == "scs" else 1
        sigma = config.sigma if config.kernel_format == "scs" else 1
        th = split_threshold(config, mtx, C)
        precs = config.ap_precisions

        # --- per shard: local rows (global columns) -> split -> AP -> SCS
        scs: Dict[str, List[ScsData]] = {p: [] for p in precs}
        # per precision, per shard: (piece ids, GLOBAL columns, values)
        pieces: Dict[str, List[Optional[tuple]]] = {p: [] for p in precs}
        parent_rows: List[Optional[np.ndarray]] = []
        shard_perms: List[np.ndarray] = []
        n_dropped = 0
        for r in range(R):
            with profiling.span("dist.from_mtx.shard"):
                lo, hi = int(ws[r]), int(ws[r + 1])
                local = mtx.slice_rows(lo, hi)
                n_real = local.n_rows
                lr_r = lr[lo:hi] if lr is not None else None
                parent = None
                if th:
                    local, parent = split_heavy_rows(local, th)
                    if lr_r is not None and parent is not None:
                        lr_r = np.concatenate([lr_r, lr_r[parent]])
                C_r, sigma_r = guard_scs_explosion(
                    real_rows(local, n_real), C, sigma)
                if config.is_ap:
                    subs, dropped = partition_precisions(
                        local,
                        config.value_type,
                        config.ap_threshold_1,
                        config.ap_threshold_2,
                        equilibrate=config.equilibrate,
                        largest_row_elems=lr_r,
                        largest_col_elems=lc,
                        dropout=config.dropout,
                        dropout_threshold=config.dropout_threshold,
                    )
                    n_dropped += dropped
                else:
                    subs = {precs[0]: dataclasses.replace(
                        local, values=host_values(local.values, precs[0]))}
                primary = convert_to_scs(real_rows(subs[precs[0]], n_real),
                                         C_r, sigma_r)
                scs[precs[0]].append(primary)
                for p in precs[1:]:
                    scs[p].append(convert_to_scs(
                        real_rows(subs[p], n_real), C_r, sigma_r,
                        fixed_permutation=primary.old_to_new_idx))
                for p, sub in subs.items():
                    cut = int(np.searchsorted(sub.I, n_real))
                    pieces[p].append(
                        (sub.I[cut:].astype(np.int64) - n_real,
                         sub.J[cut:].astype(np.int64), sub.values[cut:])
                        if parent is not None and cut < sub.nnz else None)
                parent_rows.append(None if parent is None
                                   else primary.old_to_new_idx[parent])
                shard_perms.append(primary.old_to_new_idx[:n_real])

        n_loc = max(s.n_rows_padded for s in scs[precs[0]])
        allgather = config.comm_mode == "allgather"

        # --- per precision: plan, column renumbering, exchange rows
        halo_plans: Dict[str, Optional[HaloPlan]] = {}
        lengths: Dict[str, int] = {}
        # per group (in ``placed`` order), per precision
        exchanges = [dict() for _ in placed]
        transfers = [dict() for _ in placed]
        stage: Dict[str, StagePlan] = {}
        with profiling.span("dist.from_mtx.plan"):
            for p in precs:
                for ex, tr in zip(exchanges, transfers):
                    ex[p] = tr[p] = None
                if allgather:
                    build_allgather_col_map(scs[p], ws, stride=n_loc)
                    halo_plans[p], lengths[p] = None, n_loc
                    pieces[p] = [
                        None if pc is None else (pc[0], _allgather_cols(
                            pc[1], ws, shard_perms, n_loc), pc[2])
                        for pc in pieces[p]]
                    continue
                hp = build_halo_plan(
                    scs[p], ws,
                    extra_cols=[None if pc is None else pc[1]
                                for pc in pieces[p]])
                halo_plans[p] = hp
                lengths[p] = max(hp.H, n_loc) + 1
                pieces[p] = [
                    None if pc is None else (pc[0], _halo_cols(
                        pc[1], int(ws[r]), int(ws[r + 1]), shard_perms[r],
                        scs[p][r].n_rows_padded, hp.halo_cols[r]), pc[2])
                    for r, pc in enumerate(pieces[p])]
                if n_groups == 1:
                    src, dst = exchange_rows(hp, lengths[p],
                                             no_pack=config.no_pack)
                    exchanges[0][p] = build_device_exchange(
                        src, dst, R, lengths[p], placed[0][2])
                    continue
                # the same answer for every group: the plan is global
                crossing = card[:, None] != card[None, :]
                active = bool(hp.recv_counts[crossing].any())
                for i, (g, shards, dev) in enumerate(placed):
                    src, dst, send, recv = split_exchange_rows(
                        hp, lengths[p], card, g, no_pack=config.no_pack)
                    exchanges[i][p] = build_device_exchange(
                        src, dst, len(shards), lengths[p], dev)
                    transfers[i][p] = build_device_transfer(
                        send, recv, len(shards), lengths[p], active, dev)
                if n_proc > 1 and active:
                    stage[p] = stage_plan(group_pair_counts(hp, card),
                                          group_owner,
                                          multihost.process_index())

        # --- device streams, the tier chosen per struct
        with profiling.span("dist.from_mtx.upload"):
            overlap = config.overlap_comm and not allgather
            bs = config.block_vec_size
            groups = []
            for i, (g, shards, dev) in enumerate(placed):
                streams: Dict[str, List[ShardStreams]] = {}
                for p in precs:
                    dt = dtype_for(p)

                    def put(s: ScsData) -> Stream:
                        build = (build_device_packed if packed_tier(config, s)
                                 else build_device_scs)
                        return build(s, dev, dt)

                    streams[p] = []
                    for r in shards:
                        s = scs[p][r]
                        if overlap:
                            interior, halo = split_scs_for_overlap(s)
                            sh = ShardStreams(
                                main=put(interior),
                                halo=put(halo) if halo.nnz else None)
                        else:
                            sh = ShardStreams(main=put(s))
                        pc = pieces[p][r]
                        if pc is not None:
                            sh.pieces = build_device_pieces(
                                pc[0], pc[1], pc[2], parent_rows[r],
                                s.n_rows_padded, dev, dt,
                                config.working_dtype(), bs)
                        streams[p].append(sh)
                groups.append(CardGroup(
                    index=g, device=dev, shards=shards, streams=streams,
                    exchanges=exchanges[i], transfers=transfers[i]))
        overlap = overlap and any(
            sh.halo is not None for grp in groups
            for lst in grp.streams.values() for sh in lst)
        summaries = _gather_summaries(
            {p: {r: StreamSummary.of(sh) for grp in groups
                 for r, sh in zip(grp.shards, grp.streams[p])}
             for p in precs}, R)

        op = cls(
            config=config,
            n_rows=mtx.n_rows,
            n_rows_padded=n_loc,
            work_sharing=ws,
            scs=scs,
            halo_plans=halo_plans,
            lengths=lengths,
            shard_perms=shard_perms,
            global_perm=gperm,
            matrix_stats=stats,
            nnz=nnz,
            device=groups[0].device,
            groups=groups,
            summaries=summaries,
            owner=owner,
            card=card,
            stage=stage,
            overlap=overlap,
            split_threshold=th,
            n_dropped=n_dropped,
            jacobi_diag=jac,
            equilib=equilib,
        )
        for grp in groups:
            for p in precs[1:]:
                if not allgather:
                    grp.xbufs[p] = torch.zeros(
                        op._shape(grp, p), dtype=op.working_dtype,
                        device=grp.device)
            for p, tr in grp.transfers.items():
                if tr is not None and tr.active:
                    grp.tbufs[p] = {
                        name: torch.zeros(tr.buffer_shape(n, bs),
                                          dtype=op.working_dtype,
                                          device=grp.device)
                        for name, n in (("send", tr.n_send),
                                        ("recv", tr.n_recv))}
            if allgather and len(groups) > 1:
                grp.whole = torch.zeros(op._shape(None, None, R),
                                        dtype=op.working_dtype,
                                        device=grp.device)
        if len(groups) > 1:
            op.peer = {p: peer_plan([grp.transfers[p] for grp in groups],
                                    first)
                       for p in precs if p in groups[0].tbufs}
        op.lead = {p: op._lead_buffers(p) for p in stage}
        return op

    # ------------------------------------------------------------- execution

    @property
    def R(self) -> int:
        return self.config.n_shards

    @property
    def shards(self) -> range:
        """The shards this process holds, every group's, in order."""
        return range(self.groups[0].shards.start, self.groups[-1].shards.stop)

    @property
    def n_local(self) -> int:
        """The shards this process holds."""
        return len(self.shards)

    @property
    def n_cards(self) -> int:
        """The card groups of this process."""
        return len(self.groups)

    @property
    def n_processes(self) -> int:
        return int(self.owner[-1]) + 1

    def devices(self) -> list:
        return [grp.device for grp in self.groups]

    def shard_counts(self) -> List[int]:
        """Shards per process."""
        return np.bincount(self.owner, minlength=self.n_processes).tolist()

    @property
    def precisions(self) -> tuple:
        return self.config.ap_precisions

    @property
    def streams(self) -> Dict[str, List[ShardStreams]]:
        """Per precision, the streams of every shard held here, in order."""
        return {p: [sh for grp in self.groups for sh in grp.streams[p]]
                for p in self.precisions}

    def _shape(self, grp: Optional[CardGroup], precision: Optional[str],
               n: Optional[int] = None) -> tuple:
        """The stacked x of ``n`` shards (default: the group's) of
        ``precision`` (default: the first), L rows each."""
        L = self.lengths[precision or self.precisions[0]]
        n = len(grp.shards) if n is None else n
        bs = self.config.block_vec_size
        if bs == 1:
            return (n, L)
        if self.config.vector_layout == "colwise":
            return (bs, n, L)
        return (n, L, bs)

    def x_shape(self, precision: Optional[str] = None):
        """Shape of the stacked x of ``precision`` (default: the first,
        whose buffer is the operator's x and y); with several groups, a
        tuple of their shapes."""
        shapes = tuple(self._shape(grp, precision) for grp in self.groups)
        return shapes[0] if len(shapes) == 1 else shapes

    def _stack_dim(self, t: torch.Tensor) -> int:
        """The dimension of a stacked tensor that runs over its shards."""
        return 1 if t.dim() == 3 and self.config.vector_layout == "colwise" \
            else 0

    def shard_view(self, t: torch.Tensor, r: int,
                    rows: Optional[int] = None) -> torch.Tensor:
        """The part of a stacked tensor at slot r (the group's r-th
        shard), its first ``rows`` rows: the x or y a shard's launches
        take."""
        if self.config.block_vec_size > 1 and \
                self.config.vector_layout == "colwise":
            return t[:, r, :rows]
        return t[r, :rows]

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """The stacked x of all R shards as one vector block, which every
        shard reads in allgather mode."""
        if t.dim() == 2:
            return t.view(-1)
        if self.config.vector_layout == "colwise":
            return t.view(t.shape[0], -1)
        return t.view(-1, t.shape[2])

    def x_for(self, p: str, x: torch.Tensor,
              grp: CardGroup) -> torch.Tensor:
        """The stacked x that precision p's streams of group ``grp`` read
        (x is the group's): x itself, or the precision's own buffer with
        the local rows of x copied in."""
        if p not in grp.xbufs:
            return x
        buf = grp.xbufs[p]
        n = self.n_rows_padded
        if buf.dim() == 3 and self.config.vector_layout == "colwise":
            buf[:, :, :n].copy_(x[:, :, :n])
        else:
            buf[:, :n].copy_(x[:, :n])
        return buf

    def _lead_buffers(self, p: str) -> dict:
        """The lead card's buffers of precision p's all-to-all in the
        working dtype: the lead group's own send and receive buffers where
        the process holds one group (its rows are already in the order of
        the all-to-all), else new ones of the ``StagePlan``'s sizes; under
        gloo from the card, their pinned host twins and the event the host
        waits on before the transfer reads them."""
        st, grp = self.stage[p], self.groups[0]
        if len(self.groups) == 1:
            bufs = dict(grp.tbufs[p])
        else:
            tr, bs = grp.transfers[p], self.config.block_vec_size
            bufs = {name: torch.zeros(tr.buffer_shape(n, bs),
                                      dtype=self.working_dtype,
                                      device=grp.device)
                    for name, n in (("send", st.n_send),
                                    ("recv", st.n_recv))}
        if grp.device.type == "cuda" and multihost.transport() != "nccl":
            for name in ("send", "recv"):
                bufs["host_" + name] = torch.zeros(
                    bufs[name].shape, dtype=self.working_dtype,
                    pin_memory=True)
            bufs["copied_out"] = torch.cuda.Event()
        return bufs

    def _on_cards(self) -> bool:
        """Whether the moves between groups run on the cards' second
        streams (kernels on the card), not on the current streams."""
        return not self.plain and self.device.type == "cuda"

    def _on_lead(self):
        """The stream context of the lead card's moves across processes:
        its second stream where the process holds several groups on the
        card (beside the interior launches, after the staging copies),
        else the current stream."""
        if len(self.groups) > 1 and self._on_cards():
            return torch.cuda.stream(self.groups[0].comm())
        return contextlib.nullcontext()

    def _send(self, p: str, xps) -> tuple:
        """Start precision p's transfer: every group packs the rows it
        sends from its x of ``xps`` (one tensor per group), and the copies
        between this process's groups start (``_copies``). Across
        processes the rows for the others are staged into the lead card's
        send buffer (``StagePlan``; in place where the process holds one
        group), then under NCCL the all-to-all starts on it, under gloo
        from the card it is copied out to the pinned host buffer (the host
        waits on it in ``_receive``). Returns (the NCCL work or None, the
        (current, second) stream pairs to join before the unpack)."""
        import torch.distributed as dist

        layout = self.config.vector_layout
        pack = halo_pack_plain if self.plain else halo_pack
        for grp, xp in zip(self.groups, parts_of(xps)):
            pack(grp.transfers[p], xp, grp.tbufs[p]["send"], layout)
        sends = [grp.tbufs[p]["send"] for grp in self.groups]
        recvs = [grp.tbufs[p]["recv"] for grp in self.groups]
        plans = [(self.peer.get(p, []), sends, recvs)]
        if self.n_processes == 1:
            return None, self._copies(plans)
        b, st = self.lead[p], self.stage[p]
        lead = self.groups[0]
        several = len(self.groups) > 1 and self._on_cards()
        if several:
            # every second stream after its card's packs and last unpack,
            # here, before the interior launches: the copies into the
            # receive buffers after the all-to-all need not wait for them
            for grp in self.groups:
                grp.comm().wait_stream(grp.cur())
        if len(self.groups) > 1:
            plans.append((st.stage, sends, [b["send"]]))
        joins = self._copies(plans, wait=not several)
        if several:
            # the lead's second stream carries the all-to-all: after the
            # staging copies that ran on the second stream of another
            # group on the lead's card
            for j in sorted({m.src for m in st.stage} - {0}):
                if self.groups[j].device == lead.device:
                    lead.comm().wait_stream(self.groups[j].comm())
            joins.append((lead.cur(), lead.comm()))
        with self._on_lead():
            if "host_send" in b:
                b["host_send"].copy_(b["send"], non_blocking=True)
                b["copied_out"].record()
            elif multihost.transport() == "nccl":
                return dist.all_to_all_single(
                    b["recv"], b["send"], st.recv_counts, st.send_counts,
                    async_op=True), joins
        return None, joins

    def _copies(self, plans, wait: bool = True) -> list:
        """Every move of ``plans``, a list of (``PeerSlice`` list, send
        buffers, receive buffers), the moves' ``src`` and ``dst``
        numbering this process's groups and indexing the buffer lists
        (``peer_copy``). On the cards each copy runs on the sender's
        second stream with the receiver's second stream current (PyTorch
        orders a copy between two cards after the receiver's current
        stream and makes it wait for the copy), each second stream having
        first waited for its card's current stream (the packs, the last
        unpack) where ``wait``, else earlier; elsewhere on the current
        streams. Returns the (current, second) stream pairs to join before
        the unpack: each card's own, and a sender's on the same card as
        its receiver."""
        plans = [(plan, s, r) for plan, s, r in plans if plan]
        if not plans:
            return []
        if not self._on_cards():
            for plan, sends, recvs in plans:
                peer_copy(plan, sends, recvs)
            return []
        moves = [m for plan, _, _ in plans for m in plan]
        busy = sorted({i for m in moves for i in (m.src, m.dst)})
        for i in busy if wait else ():
            self.groups[i].comm().wait_stream(self.groups[i].cur())
        for plan, sends, recvs in plans:
            peer_copy(plan, sends, recvs, [(self.groups[m.src].comm(),
                                            self.groups[m.dst].comm())
                                           for m in plan])
        pairs = [(i, i) for i in busy] + [
            (m.dst, m.src) for m in moves
            if self.groups[m.dst].device == self.groups[m.src].device]
        return [(self.groups[h].cur(), self.groups[g].comm())
                for h, g in dict.fromkeys(pairs)]

    def _receive(self, p: str, xps, work, joins=()) -> None:
        """Finish precision p's transfer: across processes wait for the
        NCCL all-to-all or run gloo's (copied in under gloo from the card)
        and copy the lead card's receive buffer into each group's
        (``StagePlan.unstage``); join the stream pairs of ``_send`` and of
        those copies. Then every group unpacks its rows into the halo rows
        of its x."""
        import torch.distributed as dist

        joins = list(joins)
        if self.n_processes > 1:
            b, st = self.lead[p], self.stage[p]
            with self._on_lead():
                if work is not None:
                    work.wait()
                elif "host_send" in b:
                    b["copied_out"].synchronize()
                    dist.all_to_all_single(b["host_recv"], b["host_send"],
                                           st.recv_counts, st.send_counts)
                    b["recv"].copy_(b["host_recv"], non_blocking=True)
                else:
                    dist.all_to_all_single(b["recv"], b["send"],
                                           st.recv_counts, st.send_counts)
            if len(self.groups) > 1:
                # the second streams waited in _send (before the interior
                # launches, which these copies need not follow)
                recvs = [grp.tbufs[p]["recv"] for grp in self.groups]
                joins += self._copies([(st.unstage, [b["recv"]], recvs)],
                                      wait=False)
        for cur, comm in dict.fromkeys(joins):
            cur.wait_stream(comm)
        layout = self.config.vector_layout
        unpack = halo_unpack_plain if self.plain else halo_unpack
        for grp, xp in zip(self.groups, parts_of(xps)):
            unpack(grp.transfers[p], grp.tbufs[p]["recv"], xp, layout)

    def _whole_xs(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Allgather mode: per group, the stacked x of all R shards as one
        vector block: across processes every process's local rows (its
        groups' stacked x, gathered on the lead card) all-gathered; over
        several groups, the whole x copied into each card's buffer."""
        dim = self._stack_dim(xs[0])
        if self.n_processes > 1:
            x = (xs[0] if len(xs) == 1
                 else torch.cat([t.to(self.device) for t in xs], dim))
            x = multihost.all_gather_blocks(x, dim, self.shard_counts())
            if len(self.groups) == 1:
                return [self.whole(x)]
            for grp in self.groups:
                grp.whole.copy_(x, non_blocking=True)
        elif len(self.groups) == 1:
            return [self.whole(xs[0])]
        else:
            for grp in self.groups:
                for src, x in zip(self.groups, xs):
                    grp.whole.narrow(dim, src.shards.start,
                                     len(src.shards)).copy_(
                        x, non_blocking=True)
        return [self.whole(grp.whole) for grp in self.groups]

    def _rows(self, p: str, part: str, xps: List[torch.Tensor],
              ys: List[torch.Tensor], accumulate: bool,
              xws: Optional[List[torch.Tensor]] = None) -> None:
        """Launch ``part`` (main, halo or pieces) of every shard of p held
        here, each group on its card; ``xws``: the whole x of allgather
        mode, per group."""
        layout = self.config.vector_layout
        for i, grp in enumerate(self.groups):
            for r, sh in enumerate(grp.streams[p]):
                dev = getattr(sh, part)
                if dev is None:
                    continue
                xr = xws[i] if xws is not None else \
                    self.shard_view(xps[i], r)
                yr = self.shard_view(ys[i], r, dev.n_rows_padded)
                if part == "pieces":
                    run_pieces(dev, xr, layout, yr, self.plain)
                elif accumulate:
                    run_rows(dev, xr, layout, self.plain, y=yr)
                else:
                    run_rows(dev, xr, layout, self.plain, out=yr)

    def _check(self, x, what: str) -> List[torch.Tensor]:
        """x (or out) as one stacked tensor per group, each checked."""
        parts = parts_of(x)
        want = [(self._shape(grp, None), grp.device) for grp in self.groups]
        if len(parts) != len(want) or any(
                tuple(t.shape) != s or t.dtype != self.working_dtype
                or t.device != d or not t.is_contiguous()
                for t, (s, d) in zip(parts, want)):
            raise ValueError(
                f"{what} must be contiguous {self.working_dtype} of shape "
                f"{self.x_shape()} on "
                f"{', '.join(str(d) for _, d in want)} (make_x), one tensor "
                f"per card group; got "
                f"{[(t.dtype, tuple(t.shape), str(t.device)) for t in parts]}")
        return list(parts)

    def spmv(self, x, out=None):
        """One y = A x on the stacked x (``x_shape()``: one tensor, or a
        tuple of one per card group), which it updates in place: the
        exchange fills its halo rows. Writes every shard's y into the local
        rows of ``out`` (default: new zeroed tensors of x's form; never x
        itself) and returns it.

        Spans (``runtime/profiling``), under ``dist.spmv``: ``dist.send``
        (the pack, the copies between cards, the all-to-all's start),
        ``dist.exchange`` (the halo rows inside a card; in allgather mode
        the gather of the whole x), ``dist.rows.main``, ``dist.receive``
        (the wait and the unpack), ``dist.rows.halo`` and
        ``dist.rows.pieces``. Off, the flag is checked once a call."""
        span = profiling.spans()
        with span("dist.spmv"):
            xs = self._check(x, "x")
            if out is None:
                out = (torch.zeros_like(x) if len(xs) == 1
                       else tuple(torch.zeros_like(t) for t in xs))
            ys = self._check(out, "out")
            if any(y.data_ptr() == t.data_ptr() for y, t in zip(ys, xs)):
                raise ValueError("out must not be x: rows read x while "
                                 "others write")
            layout = self.config.vector_layout
            exchange = halo_exchange_plain if self.plain else halo_exchange
            # kernels on the card: with the overlap, the exchange inside a
            # card runs on its second stream
            cuda = self._on_cards()
            written = False
            xws = None
            for p in self.precisions:
                xps = [self.x_for(p, t, grp)
                       for t, grp in zip(xs, self.groups)]
                if self.halo_plans[p] is None and xws is None:
                    with span("dist.exchange"):
                        xws = self._whole_xs(xs)
                exs = [grp.exchanges[p] if self.config.comm_halos else None
                       for grp in self.groups]
                exs = [None if ex is None or ex.n == 0 else ex for ex in exs]
                # the rows that cross groups: packed and on their way (the
                # copies between cards, or under NCCL the all-to-all)
                # before the interior launches
                crossing = (p in self.groups[0].tbufs
                            and self.config.comm_halos)
                work, moves = None, []
                if crossing:
                    with span("dist.send"):
                        work, moves = self._send(p, xps)
                if self.overlap:
                    with span("dist.exchange"):
                        joins = self._fork(exs, xps) if cuda else []
                        for ex, xp in zip(exs, xps):
                            if ex is not None and not cuda:
                                exchange(ex, xp, layout)
                    with span("dist.rows.main"):
                        self._rows(p, "main", xps, ys, written, xws)
                    with span("dist.receive"):
                        for cur, comm in joins:
                            cur.wait_stream(comm)
                        if crossing:
                            self._receive(p, xps, work, moves)
                    with span("dist.rows.halo"):
                        self._rows(p, "halo", xps, ys, True, xws)
                else:
                    with span("dist.exchange"):
                        for ex, xp in zip(exs, xps):
                            if ex is not None:
                                exchange(ex, xp, layout)
                    if crossing:
                        with span("dist.receive"):
                            self._receive(p, xps, work, moves)
                    with span("dist.rows.main"):
                        self._rows(p, "main", xps, ys, written, xws)
                with span("dist.rows.pieces"):
                    self._rows(p, "pieces", xps, ys, True, xws)
                written = True
            return out

    def _fork(self, exs: List[Optional[DeviceExchange]],
              xps: List[torch.Tensor]) -> list:
        """Start each card's exchange on its second stream, which first
        waits for what its current stream holds. Returns the (current,
        second) stream pairs to join after the interior launches."""
        layout = self.config.vector_layout
        joins = []
        for grp, ex, xp in zip(self.groups, exs, xps):
            if ex is None:
                continue
            comm = grp.comm()
            comm.wait_stream(grp.cur())
            with torch.cuda.stream(comm):
                halo_exchange(ex, xp, layout)
            joins.append((grp.cur(), comm))
        return joins

    def transport(self) -> Optional[str]:
        """How the rows that cross card groups travel: across processes
        the run's transport (parallel/multihost.py); between the cards of
        one process "peer" (device-to-device copies: every pair of cards
        that exchanges rows is one card or has peer access) or
        "host-staged" (a pair without peer access: CUDA stages its
        copies through the host); both, as "nccl+peer" say, where a
        process of a run holds several groups (its copies to and from the
        lead card count); None where one group holds every shard."""
        between = multihost.transport() if self.n_processes > 1 else None
        if len(self.groups) == 1:
            return between
        devs = [grp.device for grp in self.groups]
        if any(hp is None for hp in self.halo_plans.values()):
            pairs = {(a, b) for a in devs for b in devs}  # allgather
        else:
            moves = [m for plan in self.peer.values() for m in plan] + [
                m for st in self.stage.values()
                for m in st.stage + st.unstage]
            pairs = {(devs[m.src], devs[m.dst]) for m in moves}
        ok = all(a == b or (a.type == b.type == "cuda"
                            and torch.cuda.can_device_access_peer(a, b))
                 for a, b in pairs)
        inside = "peer" if ok else "host-staged"
        return inside if between is None else f"{between}+{inside}"

    def graph_capturable(self) -> bool:
        """Whether a whole SpMV can sit in one CUDA graph: across processes
        under NCCL; where a process holds several groups, where their
        copies are peer copies and every launch is a kernel (the plain
        versions allocate on every card, which a capture on one card cannot
        pool)."""
        if len(self.groups) > 1 and self.plain:
            return False
        return multihost.graph_capturable(self.transport())

    def solve_impl_name(self, n_repetitions: int = 2,
                        impl: Optional[str] = None) -> str:
        """"graph" (one CUDA graph of the k SpMVs, over every card of the
        process) on a CUDA device for more than one repetition, else
        "loop"; the fused solve kernel runs one SELL-C-sigma stream and
        takes no sharded operator. Across processes the graph holds the
        NCCL all-to-all; over gloo the operator runs the loop (its
        transfer crosses the host)."""
        capturable = self.graph_capturable()
        if impl is not None:
            if impl not in SOLVE_IMPLS:
                raise ValueError(
                    f"solve impl must be one of {SOLVE_IMPLS}, not {impl!r}")
            if impl == "fused":
                raise ValueError(
                    "the fused solve kernel takes one SELL-C-sigma stream; "
                    "a sharded operator solves by impl='graph' or 'loop'")
            if impl == "graph" and not capturable:
                where = ("spread over processes" if self.n_processes > 1
                         else "over several cards")
                why = ("through the plain version: it allocates on every "
                       "card" if multihost.graph_capturable(self.transport())
                       else "its transfer cannot be captured in a CUDA graph")
                raise ValueError(
                    f"an operator {where} solves by impl='loop': {why}")
            return impl
        if self.device.type == "cuda" and n_repetitions > 1 and capturable:
            return "graph"
        return "loop"

    def solve(self, x, n_repetitions: int,
              impl: Optional[str] = None) -> tuple:
        """Solve mode: n_repetitions of y = A x with the x <-> y swap
        (JAX distributed.py:1085-1103). Returns (x_last_input, y_result),
        stacked; both are the caller's to keep."""
        impl = self.solve_impl_name(n_repetitions, impl)
        if impl == "graph":
            return self._solve_graph(x, n_repetitions)
        prev = (torch.zeros_like(x) if isinstance(x, torch.Tensor)
                else tuple(torch.zeros_like(t) for t in x))
        for _ in range(n_repetitions):
            prev, x = x, self.spmv(x)
        return prev, x

    # --------------------------------------------------------------- vectors

    def make_x(self, x_in: Optional[np.ndarray] = None):
        """The stacked x (``x_shape()``) in the working dtype: each shard's
        rows of the (seg-metis permuted) x at its permuted local rows, the
        halo and padding rows zero; the shards of this process only, one
        tensor per card group (a tuple of them for several)."""
        host = init_x_host(self.config, self.n_rows, self.matrix_stats,
                           x_in=x_in, dtype=numpy_dtype(self.working_dtype))
        if self.global_perm is not None:
            host = host[generate_inv_perm(self.global_perm)]
        colwise = (self.config.block_vec_size > 1
                   and self.config.vector_layout == "colwise")
        parts = []
        ws = self.work_sharing
        for grp in self.groups:
            shape = self._shape(grp, None)
            out = np.zeros(shape[1:] + shape[:1] if colwise else shape,
                           dtype=host.dtype)
            for i, r in enumerate(grp.shards):
                out[i][self.shard_perms[r]] = host[ws[r]:ws[r + 1]]
            if colwise:
                out = np.ascontiguousarray(np.moveaxis(out, -1, 0))
            parts.append(torch.from_numpy(out).to(grp.device))
        return parts[0] if len(parts) == 1 else tuple(parts)

    def to_host(self, y) -> np.ndarray:
        """The stacked y (one tensor or one per group) -> [n_rows(, bs)] in
        the original row order. Every group's shards are gathered on the
        first group's device and, across processes, every process's (a
        collective: every process calls it, and every process gets the
        whole y)."""
        parts = parts_of(y)
        dim = self._stack_dim(parts[0])
        local = (parts[0] if len(parts) == 1 else
                 torch.cat([t.to(parts[0].device) for t in parts], dim))
        y = multihost.fetch_global(local, dim, self.shard_counts())
        if dim == 1:
            y = np.moveaxis(y, 0, -1)  # [R, L, bs]
        out = np.zeros((self.n_rows,) + y.shape[2:], dtype=y.dtype)
        ws = self.work_sharing
        for r in range(self.R):
            out[ws[r]:ws[r + 1]] = y[r][self.shard_perms[r]]
        if self.global_perm is not None:
            out = out[self.global_perm]
        return out

    # --------------------------------------------------------------- metrics

    def _devs(self, p: str) -> List[Stream]:
        return [d for sh in self.streams[p] for d in (sh.main, sh.halo)
                if d is not None]

    def _pieces(self, p: str) -> List[DevicePieces]:
        return [sh.pieces for sh in self.streams[p] if sh.pieces is not None]

    def bytes_per_spmv(self) -> int:
        """Minimum traffic, as ``SpmvOperator.bytes_per_spmv`` counts it over
        every shard's streams (the interior and halo parts both), + x + y
        over the R local row ranges (n_loc each) in the working dtype. The
        exchange is not counted, as in the JAX package."""
        bs = self.config.block_vec_size
        total = 0
        sell_passes, packed_passes = (self.matrix_passes(False),
                                      self.matrix_passes(True))
        pieces_passes = vector_pass_count(bs)
        for p in self.precisions:
            for sm in self.summaries[p]:
                total += (sell_passes * (sm.stream_bytes - sm.packed_bytes)
                          + packed_passes * sm.packed_bytes
                          + pieces_passes * sm.pieces_pass_bytes
                          + bs * sm.pieces_vector_bytes)
        xw = torch.empty((), dtype=self.working_dtype).element_size()
        return total + self.R * self.n_rows_padded * bs * xw * 2

    def comm_volume_per_spmv(self) -> dict:
        """Halo elements received per SpMV and precision (reference
        -print_comm_vol): real, padded (the JAX plan's max-count padded
        lanes) and per shard."""
        out = {}
        R, n = self.R, self.n_rows_padded
        for p, hp in self.halo_plans.items():
            if hp is not None:
                out[p] = {
                    "real": hp.comm_volume_per_spmv,
                    "padded": hp.padded_comm_volume_per_spmv,
                    "per_shard": list(map(int, hp.halo_counts)),
                }
            else:
                out[p] = {"real": R * n * (R - 1), "padded": R * n * (R - 1),
                          "per_shard": [n * (R - 1)] * R}
        return out

    def _grouped(self, by: np.ndarray) -> dict:
        """Per precision with a plan, the shards' halo counts summed by
        ``by`` (the process or the card group of each shard)."""
        out = {}
        for p, hp in self.halo_plans.items():
            if hp is None:
                continue
            acc: dict = {}
            for r, h in enumerate(hp.halo_counts):
                acc[int(by[r])] = acc.get(int(by[r]), 0) + int(h)
            out[p] = acc
        return out

    def comm_volume_per_host(self) -> dict:
        """Halo elements received per host (process) and SpMV: the shards'
        halo counts grouped by the process that holds them, as the JAX
        operator groups its mesh positions (distributed.py:1196-1208)."""
        return self._grouped(self.owner)

    def comm_volume_per_card(self) -> dict:
        """Halo elements received per card group and SpMV, counted where
        they land: the rows that cross cards and those a card's exchange
        copies between its own shards."""
        return self._grouped(self.card)

    def is_packed(self) -> bool:
        return any(any(sm.packed) for p in self.precisions
                   for sm in self.summaries[p])

    def impl_name(self) -> str:
        """cuda-dist<R>-<tiers>-<value type>: the tiers of the shards'
        streams (scs, packed or both, +pieces), on the CPU
        torch-plain-dist<R>-...; where a process holds several card
        groups, dist<R>-<G>cards, G the groups of the whole run."""
        where = ("cuda" if self.device.type == "cuda" and not self.plain
                 else "torch-plain")
        kinds = {k for p in self.precisions for sm in self.summaries[p]
                 for k in sm.packed}
        tier = "+".join(name for packed, name in ((False, "scs"),
                                                  (True, "packed"))
                        if packed in kinds)
        if self.n_pieces():
            tier += "+pieces"
        n_groups = int(self.card[-1]) + 1
        cards = f"-{n_groups}cards" if n_groups > self.n_processes else ""
        return f"{where}-dist{self.R}{cards}-{tier}-{self.config.value_type}"

    def per_shard_nnz(self) -> list:
        """Nonzeros per shard (reference per-rank perf, main.cpp:833-890)."""
        out = [0] * self.R
        for p in self.precisions:
            for r, (s, sm) in enumerate(zip(self.scs[p],
                                            self.summaries[p])):
                out[r] += s.nnz + sm.pieces_nnz
        return out

    def beta(self) -> Dict[str, float]:
        """Mean over the shards of each precision's SCS fill (the JAX
        operator's), the real rows as stored."""
        return {p: float(np.mean([s.beta for s in lst]))
                for p, lst in self.scs.items()}

    def device_beta(self) -> Dict[str, float]:
        """Nonzeros over the elements the kernels stream, every shard's
        streams and pieces together."""
        out = {}
        for p in self.precisions:
            sms = self.summaries[p]
            pieces = sum(sm.pieces_nnz for sm in sms)
            nz = sum(sm.nnz for sm in sms) + pieces
            streamed = sum(sm.streamed for sm in sms) + pieces
            out[p] = nz / streamed if streamed else 1.0
        return out

    def nnz_per_precision(self) -> Dict[str, int]:
        return {p: sum(s.nnz for s in self.scs[p])
                + sum(sm.pieces_nnz for sm in self.summaries[p])
                for p in self.precisions}

    def n_pieces(self) -> int:
        return sum(sm.n_pieces for p in self.precisions
                   for sm in self.summaries[p])

    def nnz_in_pieces(self) -> int:
        return sum(sm.pieces_nnz for p in self.precisions
                   for sm in self.summaries[p])

    def dump_sparsity(self, outdir: str) -> list:
        """-output_sparsity: per precision and shard the JAX operator's
        ``<precision>_local_scs_rank<r>.mtx`` (distributed.py:1252), the
        shard's nonzeros by its original local row, columns in its x
        numbering (local rows, then halo); the shard's heavy-row pieces
        folded back into their parents' rows (``write_sparsity``). Across
        processes each writes the files of its own shards, as each rank of
        the reference writes its own."""
        paths = []
        for p in self.precisions:
            for r, sh in zip(self.shards, self.streams[p]):
                s = self.scs[p][r]
                path = os.path.join(outdir, f"{p}_local_scs_rank{r}.mtx")
                write_sparsity(path, s, sh.pieces)
                paths.append(path)
        return paths
