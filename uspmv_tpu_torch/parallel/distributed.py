"""Row-sharded SpMV with a halo exchange: ``DistributedSpmvOperator``.

Port of ``uspmv_tpu/parallel/distributed.py`` (the reference's MPI
execution model, SURVEY.md §2): a 1-D row partition (seg-rows, seg-nnz,
seg-metis; parallel/partition.py) into R shards; each shard's remote x
entries are deduplicated and renumbered into a halo appended after its
local (padded) rows (parallel/halo.py), and every SpMV fills the halos
from their owners before the rows that read them run.

The JAX operator is one SPMD program over a mesh of R devices, its exchange
a ``ppermute`` per ring offset. Here the R shards run in one process on the
one device ``config.backend`` names, each with its own structs and
launches: the SELL-C-sigma or packed kernel of its rows (the tier chosen
per struct, as on one device), its heavy-row pieces, and, per precision,
one launch of the exchange kernel (ops/halo_exchange.py) that copies every
halo row of every shard from its owner's local rows. Nothing falls back to
the CPU: ``backend="cuda"`` without a GPU raises, where the JAX operator
may fall back to a virtual CPU mesh.

x lives in its halo-extended form. The shards' x buffers of L = H + 1
rows (H: the plan's common length, the dump slot at H) are stacked:

    one vector [R, L]; rowwise block vectors [R, L, bs]; colwise [bs, R, L]

``make_x`` returns that tensor, ``spmv(x)`` fills the halo rows of x in
place and writes each shard's y into the local rows of a tensor of the same
shape, so a solve swaps x and y with no copy, and ``to_host`` reads each
shard's local rows. Each adaptive precision has its own plan and L (its
streams have their own column sets); its buffer takes a copy of the local
rows of x on every SpMV. In ``comm_mode="allgather"`` there is no plan: x
is [R, n_loc(, bs)], every shard reads the whole stacked x, whose
concatenation ``build_allgather_col_map`` addresses, and no exchange runs.

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

impl='xla' (or use_pallas=False) runs every launch's plain PyTorch version,
the exchange's too, on the chosen device, in one stream.

Not ported, as the ROADMAP lists: lane tiles and re-tiling, the
transpose-stream tier, the ±1 fold matrix and its prefix sums (the pieces
kernel folds), the df64 pairs (``-dp_emu`` runs native f64). Unlike the
JAX XLA path, heavy rows are split per shard, with the threshold of the
whole matrix.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Union

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
)
from ..ops.halo_exchange import (
    DeviceExchange,
    build_device_exchange,
    halo_exchange,
    halo_exchange_plain,
)
from ..ops.vectors import init_x_host
from ..precision.partition import partition_precisions
from ..runtime.operator import (
    OperatorBase,
    SOLVE_IMPLS,
    guard_scs_explosion,
    packed_tier,
    real_rows,
    resolve_device,
    run_pieces,
    run_rows,
    split_threshold,
    write_sparsity,
)
from .halo import (
    HaloPlan,
    build_allgather_col_map,
    build_halo_plan,
    exchange_rows,
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


def _halo_cols(cols: np.ndarray, lo: int, hi: int, old_to_new: np.ndarray,
               n_rows_padded: int, halo_cols: np.ndarray) -> np.ndarray:
    """Global columns -> rows of one shard's halo-extended x, as
    ``build_halo_plan(renumber=True)`` maps the SCS columns."""
    local = (cols >= lo) & (cols < hi)
    out = np.empty(cols.size, dtype=np.int64)
    out[local] = old_to_new[cols[local] - lo]
    out[~local] = n_rows_padded + np.searchsorted(halo_cols, cols[~local])
    return out


@dataclasses.dataclass
class DistributedSpmvOperator(OperatorBase):
    """The sharded counterpart of ``SpmvOperator`` (same public surface)."""

    config: Config
    n_rows: int
    n_rows_padded: int  # n_loc: the largest local padded row count
    work_sharing: np.ndarray  # [R + 1] global row boundaries
    # per precision, per shard: the host SCS, columns renumbered
    scs: Dict[str, List[ScsData]]
    streams: Dict[str, List[ShardStreams]]
    halo_plans: Dict[str, Optional[HaloPlan]]  # None in allgather mode
    exchanges: Dict[str, Optional[DeviceExchange]]
    lengths: Dict[str, int]  # L: rows of one shard's x buffer
    shard_perms: List[np.ndarray]  # per shard, old_to_new of its real rows
    global_perm: Optional[np.ndarray]  # seg-metis permutation, old -> new
    matrix_stats: tuple
    nnz: int
    device: torch.device
    overlap: bool = False
    split_threshold: int = 0
    n_dropped: int = 0
    jacobi_diag: Optional[np.ndarray] = None
    equilib: Optional[tuple] = None
    # x buffers of the precisions after the first (halo mode)
    _xbufs: dict = dataclasses.field(default_factory=dict, repr=False)
    _comm_stream: Optional[object] = dataclasses.field(default=None,
                                                       repr=False)
    _solve_graphs: dict = dataclasses.field(default_factory=dict, repr=False)

    # ----------------------------------------------------------------- build

    @classmethod
    def from_mtx(cls, config: Config, mtx: MtxData
                 ) -> "DistributedSpmvOperator":
        config.validate()
        device = resolve_device(config)
        R = config.n_shards
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
        exchanges: Dict[str, Optional[DeviceExchange]] = {}
        for p in precs:
            if allgather:
                build_allgather_col_map(scs[p], ws, stride=n_loc)
                halo_plans[p], lengths[p], exchanges[p] = None, n_loc, None
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
            src, dst = exchange_rows(hp, lengths[p], no_pack=config.no_pack)
            exchanges[p] = build_device_exchange(src, dst, R, lengths[p],
                                                 device)

        # --- device streams, the tier chosen per struct
        overlap = config.overlap_comm and not allgather
        bs = config.block_vec_size
        streams: Dict[str, List[ShardStreams]] = {}
        for p in precs:
            dt = dtype_for(p)

            def put(s: ScsData) -> Stream:
                build = (build_device_packed if packed_tier(config, s)
                         else build_device_scs)
                return build(s, device, dt)

            streams[p] = []
            for r, s in enumerate(scs[p]):
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
                        s.n_rows_padded, device, dt,
                        config.working_dtype(), bs)
                streams[p].append(sh)
        overlap = overlap and any(sh.halo is not None
                                  for lst in streams.values() for sh in lst)

        op = cls(
            config=config,
            n_rows=mtx.n_rows,
            n_rows_padded=n_loc,
            work_sharing=ws,
            scs=scs,
            streams=streams,
            halo_plans=halo_plans,
            exchanges=exchanges,
            lengths=lengths,
            shard_perms=shard_perms,
            global_perm=gperm,
            matrix_stats=stats,
            nnz=nnz,
            device=device,
            overlap=overlap,
            split_threshold=th,
            n_dropped=n_dropped,
            jacobi_diag=jac,
            equilib=equilib,
        )
        for p in precs[1:]:
            if not allgather:
                op._xbufs[p] = torch.zeros(op.x_shape(p),
                                           dtype=op.working_dtype,
                                           device=device)
        return op

    # ------------------------------------------------------------- execution

    @property
    def R(self) -> int:
        return self.config.n_shards

    @property
    def precisions(self) -> tuple:
        return self.config.ap_precisions

    def x_shape(self, precision: Optional[str] = None) -> tuple:
        """Shape of the stacked x of ``precision`` (default: the first,
        whose buffer is the operator's x and y)."""
        L = self.lengths[precision or self.precisions[0]]
        bs = self.config.block_vec_size
        if bs == 1:
            return (self.R, L)
        if self.config.vector_layout == "colwise":
            return (bs, self.R, L)
        return (self.R, L, bs)

    def shard_view(self, t: torch.Tensor, r: int,
                    rows: Optional[int] = None) -> torch.Tensor:
        """Shard r's part of a stacked tensor, its first ``rows`` rows: the
        x or y a shard's launches take."""
        if self.config.block_vec_size > 1 and \
                self.config.vector_layout == "colwise":
            return t[:, r, :rows]
        return t[r, :rows]

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """The stacked x as one vector block, which every shard reads in
        allgather mode."""
        if t.dim() == 2:
            return t.view(-1)
        if self.config.vector_layout == "colwise":
            return t.view(t.shape[0], -1)
        return t.view(-1, t.shape[2])

    def x_for(self, p: str, x: torch.Tensor) -> torch.Tensor:
        """The stacked x that precision p's streams read: x itself, or the
        precision's own buffer with the local rows of x copied in."""
        if p not in self._xbufs:
            return x
        buf = self._xbufs[p]
        n = self.n_rows_padded
        if buf.dim() == 3 and self.config.vector_layout == "colwise":
            buf[:, :, :n].copy_(x[:, :, :n])
        else:
            buf[:, :n].copy_(x[:, :n])
        return buf

    def _comm(self) -> "torch.cuda.Stream":
        if self._comm_stream is None:
            self._comm_stream = torch.cuda.Stream(device=self.device)
        return self._comm_stream

    def _rows(self, p: str, part: str, xp: torch.Tensor, y: torch.Tensor,
              accumulate: bool) -> None:
        """Launch ``part`` (main, halo or pieces) of every shard of p."""
        layout = self.config.vector_layout
        allgather = self.halo_plans[p] is None
        for r, sh in enumerate(self.streams[p]):
            dev = getattr(sh, part)
            if dev is None:
                continue
            xr = self.whole(xp) if allgather else self.shard_view(xp, r)
            yr = self.shard_view(y, r, dev.n_rows_padded)
            if part == "pieces":
                run_pieces(dev, xr, layout, yr, self.plain)
            elif accumulate:
                run_rows(dev, xr, layout, self.plain, y=yr)
            else:
                run_rows(dev, xr, layout, self.plain, out=yr)

    def spmv(self, x: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One y = A x on the stacked x (``x_shape()``), which it updates
        in place: the exchange fills its halo rows. Writes every shard's y
        into the local rows of ``out`` (default: a new zeroed tensor of x's
        shape; never x itself) and returns it."""
        if tuple(x.shape) != self.x_shape() or x.dtype != self.working_dtype \
                or x.device != self.device or not x.is_contiguous():
            raise ValueError(
                f"x must be contiguous {self.working_dtype} of shape "
                f"{self.x_shape()} on {self.device} (make_x); got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
        if out is None:
            out = torch.zeros_like(x)
        elif out.shape != x.shape or out.dtype != x.dtype \
                or out.device != x.device or not out.is_contiguous():
            raise ValueError("out must be a contiguous tensor like x")
        elif out.data_ptr() == x.data_ptr():
            raise ValueError("out must not be x: rows read x while others "
                             "write")
        layout = self.config.vector_layout
        exchange = halo_exchange_plain if self.plain else halo_exchange
        written = False
        for p in self.precisions:
            xp = self.x_for(p, x)
            ex = self.exchanges[p] if self.config.comm_halos else None
            if ex is not None and ex.n == 0:
                ex = None
            if self.overlap:
                if ex is not None and xp.device.type == "cuda" \
                        and not self.plain:
                    # the interior launches read local rows only: the
                    # exchange runs beside them on the second stream
                    cur = torch.cuda.current_stream(xp.device)
                    comm = self._comm()
                    comm.wait_stream(cur)
                    with torch.cuda.stream(comm):
                        exchange(ex, xp, layout)
                    self._rows(p, "main", xp, out, written)
                    cur.wait_stream(comm)
                else:
                    if ex is not None:
                        exchange(ex, xp, layout)
                    self._rows(p, "main", xp, out, written)
                self._rows(p, "halo", xp, out, True)
            else:
                if ex is not None:
                    exchange(ex, xp, layout)
                self._rows(p, "main", xp, out, written)
            self._rows(p, "pieces", xp, out, True)
            written = True
        return out

    def solve_impl_name(self, n_repetitions: int = 2,
                        impl: Optional[str] = None) -> str:
        """"graph" (one CUDA graph of the k SpMVs) on a CUDA device for
        more than one repetition, else "loop"; the fused solve kernel runs
        one SELL-C-sigma stream and takes no sharded operator."""
        if impl is not None:
            if impl not in SOLVE_IMPLS:
                raise ValueError(
                    f"solve impl must be one of {SOLVE_IMPLS}, not {impl!r}")
            if impl == "fused":
                raise ValueError(
                    "the fused solve kernel takes one SELL-C-sigma stream; "
                    "a sharded operator solves by impl='graph' or 'loop'")
            return impl
        if self.device.type == "cuda" and n_repetitions > 1:
            return "graph"
        return "loop"

    def solve(self, x: torch.Tensor, n_repetitions: int,
              impl: Optional[str] = None) -> tuple:
        """Solve mode: n_repetitions of y = A x with the x <-> y swap
        (JAX distributed.py:1085-1103). Returns (x_last_input, y_result),
        stacked; both are the caller's to keep."""
        impl = self.solve_impl_name(n_repetitions, impl)
        if impl == "graph":
            return self._solve_graph(x, n_repetitions)
        prev = torch.zeros_like(x)
        for _ in range(n_repetitions):
            prev, x = x, self.spmv(x)
        return prev, x

    # --------------------------------------------------------------- vectors

    def make_x(self, x_in: Optional[np.ndarray] = None) -> torch.Tensor:
        """The stacked x (``x_shape()``) in the working dtype: each shard's
        rows of the (seg-metis permuted) x at its permuted local rows, the
        halo and padding rows zero."""
        host = init_x_host(self.config, self.n_rows, self.matrix_stats,
                           x_in=x_in, dtype=numpy_dtype(self.working_dtype))
        if self.global_perm is not None:
            host = host[generate_inv_perm(self.global_perm)]
        colwise = (self.config.block_vec_size > 1
                   and self.config.vector_layout == "colwise")
        shape = self.x_shape()
        stacked = shape[1:] + shape[:1] if colwise else shape
        out = np.zeros(stacked, dtype=host.dtype)
        ws = self.work_sharing
        for r in range(self.R):
            out[r][self.shard_perms[r]] = host[ws[r]:ws[r + 1]]
        if colwise:
            out = np.ascontiguousarray(np.moveaxis(out, -1, 0))
        return torch.from_numpy(out).to(self.device)

    def to_host(self, y: torch.Tensor) -> np.ndarray:
        """The stacked y -> [n_rows(, bs)] in the original row order."""
        y = y.detach().cpu().numpy()
        if y.ndim == 3 and self.config.vector_layout == "colwise":
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
        for p in self.precisions:
            total += self.matrix_passes() * sum(
                d.stream_bytes() for d in self._devs(p))
            total += bs * sum(pc.stream_bytes() for pc in self._pieces(p))
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

    def comm_volume_per_host(self) -> dict:
        """Halo elements received per host and SpMV; all shards of this
        operator live in one process, host 0."""
        return {p: {0: int(sum(hp.halo_counts))}
                for p, hp in self.halo_plans.items() if hp is not None}

    def is_packed(self) -> bool:
        return any(isinstance(d, DevicePacked)
                   for p in self.precisions for d in self._devs(p))

    def impl_name(self) -> str:
        """cuda-dist<R>-<tiers>-<value type>: the tiers of the shards'
        streams (scs, packed or both, +pieces), on the CPU
        torch-plain-dist<R>-..."""
        where = ("cuda" if self.device.type == "cuda" and not self.plain
                 else "torch-plain")
        kinds = {isinstance(d, DevicePacked)
                 for p in self.precisions for d in self._devs(p)}
        tier = "+".join(name for packed, name in ((False, "scs"),
                                                  (True, "packed"))
                        if packed in kinds)
        if self.n_pieces():
            tier += "+pieces"
        return f"{where}-dist{self.R}-{tier}-{self.config.value_type}"

    def per_shard_nnz(self) -> list:
        """Nonzeros per shard (reference per-rank perf, main.cpp:833-890)."""
        out = [0] * self.R
        for p in self.precisions:
            for r, (s, sh) in enumerate(zip(self.scs[p], self.streams[p])):
                out[r] += s.nnz + (sh.pieces.nnz if sh.pieces else 0)
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
            nz = sum(d.nnz for d in self._devs(p)) + sum(
                pc.nnz for pc in self._pieces(p))
            streamed = sum(d.nnz if isinstance(d, DevicePacked)
                           else d.n_elements for d in self._devs(p)) + sum(
                pc.nnz for pc in self._pieces(p))
            out[p] = nz / streamed if streamed else 1.0
        return out

    def nnz_per_precision(self) -> Dict[str, int]:
        return {p: sum(s.nnz for s in self.scs[p])
                + sum(pc.nnz for pc in self._pieces(p))
                for p in self.precisions}

    def n_pieces(self) -> int:
        return sum(pc.n_pieces for p in self.precisions
                   for pc in self._pieces(p))

    def nnz_in_pieces(self) -> int:
        return sum(pc.nnz for p in self.precisions for pc in self._pieces(p))

    def dump_sparsity(self, outdir: str) -> list:
        """-output_sparsity: per precision and shard the JAX operator's
        ``<precision>_local_scs_rank<r>.mtx`` (distributed.py:1252), the
        shard's nonzeros by its original local row, columns in its x
        numbering (local rows, then halo); the shard's heavy-row pieces
        folded back into their parents' rows (``write_sparsity``)."""
        paths = []
        for p in self.precisions:
            for r, (s, sh) in enumerate(zip(self.scs[p], self.streams[p])):
                path = os.path.join(outdir, f"{p}_local_scs_rank{r}.mtx")
                write_sparsity(path, s, sh.pieces)
                paths.append(path)
        return paths
