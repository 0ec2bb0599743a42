"""Halo exchange of the row-sharded SpMV: the CUDA kernel's wrapper and its
plain version.

Port of the exchange of ``DistributedSpmvOperator._exchange``
(uspmv_tpu/parallel/distributed.py:917-944), which packs each shard's send
buffer with ``jnp.take``, moves it with one ``ppermute`` per ring offset and
scatters it into the receiver's halo region: XLA ops, not a Pallas kernel.
In this package the shards an operator holds on one card (a card group)
have their x buffers stacked into one tensor (parallel/distributed.py):

    one vector [R_g, L]; rowwise block vectors [R_g, L, bs]; colwise
    [bs, R_g, L]

So the exchange between the shards of a card is one copy inside that
tensor, ``x[dst[i]] = x[src[i]]`` over the rows of its flat view
(``[R_g * L]``, ``[R_g * L, bs]`` or ``[bs, R_g * L]``), the pairs of
``parallel.halo.exchange_rows``. ``halo_exchange`` does it in place: for
CUDA tensors one launch of the kernel of ``csrc/halo_exchange.cu`` covers
every offset, shard and vector; for CPU tensors it runs
``halo_exchange_plain``, ``index_copy_(index_select)``. A failure to build
or launch raises. Sources and destinations never share a row, so both give
the same bits.

The rows that cross card groups go through a buffer of rows per group
(``DeviceTransfer``): ``halo_pack`` gathers the rows a group sends,
``halo_unpack`` scatters the rows it receives, each one launch of its
kernel in ``csrc/halo_exchange.cu`` for CUDA tensors and
``halo_pack_plain`` (``index_select``) / ``halo_unpack_plain``
(``index_copy_``) for CPU tensors. A buffer row holds every value of its x
row: ``[n]`` for one vector, ``[n, bs]`` for block vectors of either
layout, so the transfer splits it by rows. Between the groups of one
process, ``peer_copy`` moves each sender's slice for each receiver into the
receiver's buffer (``peer_plan``: the ``send_counts``/``recv_counts`` split
of ``all_to_all_single``), a device-to-device copy of PyTorch's; across
processes ``all_to_all_single`` moves them (parallel/multihost.py), on
each process's lead card, where ``peer_copy`` stages the rows of the
process's other groups (``StagePlan``).

The three are one kernel template on the card (``csrc/halo_exchange.cu``):
a thread copies a pair, rows of a multiple of 16 bytes move as 16-byte
units, the grid is at most one wave with a grid-stride loop beyond it, and
each launch is a programmatic dependent launch: it reads its index arrays
before it waits for the kernel before it on the stream, so they are
written once, when the plan is built (copies from the host in
``build_device_exchange`` and ``build_device_transfer``), never by a
kernel just launched. ``launch_geometry`` mirrors the source's choices in
Python, and ``device_geometry`` asks the library what a launch of given
tensors takes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from . import scs_spmv
from .scs_spmv import MAX_VECTORS, book_launch

_ENTRY_POINTS = {
    torch.float32: "uspmv_halo_exchange_f32",
    torch.float64: "uspmv_halo_exchange_f64",
}
PACK_ENTRY_POINTS = {
    torch.float32: "uspmv_halo_pack_f32",
    torch.float64: "uspmv_halo_pack_f64",
}
UNPACK_ENTRY_POINTS = {
    torch.float32: "uspmv_halo_unpack_f32",
    torch.float64: "uspmv_halo_unpack_f64",
}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
             + [ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
GEOMETRY_ENTRY = "uspmv_halo_geometry"
_GEOMETRY_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                      + [ctypes.c_int64] * 2
                      + [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_void_p])
# the launch geometry of csrc/halo_exchange.cu
THREADS = 256
VECTOR_BYTES = 16
KINDS = ("exchange", "pack", "unpack")
_GEOMETRY_KEYS = ("threads", "unit_bytes", "row_units", "grid", "n_vec",
                  "n_sm", "blocks_per_sm")

# one count per entry point: the exchange, the pack and the unpack
_launches: Dict[str, int] = {
    name: 0 for table in (_ENTRY_POINTS, PACK_ENTRY_POINTS,
                          UNPACK_ENTRY_POINTS) for name in table.values()}
_lib = None


def launch_counts() -> Dict[str, int]:
    """Kernel launches per instantiation (entry point name)."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


@dataclasses.dataclass
class DeviceExchange:
    """The (src, dst) row pairs of one precision's exchange on a device."""

    src: torch.Tensor  # int32 [n]
    dst: torch.Tensor  # int32 [n]
    n_shards: int
    length: int  # L, the rows of one shard's x buffer

    @property
    def n(self) -> int:
        return int(self.src.shape[0])

    def bound_bytes(self, x_itemsize: int, n_values: int = 1) -> int:
        """Bytes of the function per call on rows of ``n_values`` values
        (bs of a block of vectors): both indices of every pair read once,
        each source value read and each destination value written once."""
        return self.n * (8 + 2 * x_itemsize * n_values)


def build_device_exchange(src: np.ndarray, dst: np.ndarray, n_shards: int,
                          length: int, device: torch.device
                          ) -> DeviceExchange:
    """The host's (src, dst) rows (``parallel.halo.exchange_rows``) on
    ``device`` as int32; raises for a row outside the R * L stacked rows
    or one that is both a source and a destination."""
    rows = n_shards * length
    if rows > np.iinfo(np.int32).max:
        raise OverflowError(f"{rows} stacked rows exceed int32 indices")
    if src.size and not (0 <= min(src.min(), dst.min())
                         and max(src.max(), dst.max()) < rows):
        raise ValueError("an exchange row lies outside the stacked buffer")
    if np.intersect1d(src, dst).size:
        raise ValueError("an exchange row is both a source and a destination")

    def put(a):
        return torch.from_numpy(a.astype(np.int32)).to(device)

    return DeviceExchange(src=put(src), dst=put(dst), n_shards=n_shards,
                          length=length)


def flat_view(ex: DeviceExchange, x: torch.Tensor, layout: str):
    """(the flat view of the stacked buffer x, the dimension of its rows):
    [R*L] or [R*L, bs] (dim 0), colwise [bs, R*L] (dim 1)."""
    rows = ex.n_shards * ex.length
    if x.dim() == 2 and x.shape == (ex.n_shards, ex.length):
        return x.view(rows), 0
    if x.dim() == 3 and layout == "rowwise" and x.shape[:2] == (
            ex.n_shards, ex.length):
        return x.view(rows, x.shape[2]), 0
    if x.dim() == 3 and layout == "colwise" and x.shape[1:] == (
            ex.n_shards, ex.length):
        return x.view(x.shape[0], rows), 1
    raise ValueError(
        f"x must be the stacked buffer [R, L], rowwise [R, L, bs] or "
        f"colwise [bs, R, L] with R={ex.n_shards}, L={ex.length}; got "
        f"{tuple(x.shape)} {layout}")


def halo_exchange_plain(ex: DeviceExchange, x: torch.Tensor,
                        layout: str = "rowwise") -> torch.Tensor:
    """Plain PyTorch version, in place: the rows ``dst`` of the flat view
    take the rows ``src``. Returns x."""
    flat, dim = flat_view(ex, x, layout)
    flat.index_copy_(dim, ex.dst.long(), flat.index_select(dim, ex.src))
    return x


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = scs_spmv._kernel_lib()  # one library; binds the error string
        for name in _launches:
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        query = getattr(lib, GEOMETRY_ENTRY)
        query.argtypes = _GEOMETRY_ARGTYPES
        query.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch_geometry(n: int, n_vec: int, ld: int, ncols: int, itemsize: int,
                    n_sm: int, per_sm: int, vstride: int = 0,
                    aligned: bool = True) -> Dict[str, int]:
    """How csrc/halo_exchange.cu launches a copy of n pairs (rows of
    ``ncols`` values of ``itemsize`` bytes, ``ld`` values apart, ``n_vec``
    colwise vectors ``vstride`` apart) on a card of ``n_sm`` SMs holding
    ``per_sm`` of its blocks each: thread t of the grid takes pairs t,
    t + grid * threads, ...; a row moves in units of ``unit_bytes`` (16
    where its bytes, ``ld`` and ``vstride`` are multiples of 16 and the
    buffers are 16-byte ``aligned``, else one value), ``row_units`` of
    them; the grid is ``grid`` x ``n_vec`` blocks of ``threads``, at most
    one wave (at least one block per vector)."""
    if n < 1 or n_vec < 1 or ncols < 1 or ld < 1:
        raise ValueError("a launch copies n >= 1 rows of ncols >= 1 values "
                         "for n_vec >= 1 vectors, ld >= 1")
    row_bytes = ncols * itemsize
    vec = (aligned and row_bytes % VECTOR_BYTES == 0
           and ld * itemsize % VECTOR_BYTES == 0
           and (n_vec == 1 or vstride * itemsize % VECTOR_BYTES == 0))
    unit = VECTOR_BYTES if vec else itemsize
    wave = max(n_sm * per_sm // n_vec, 1)
    return dict(threads=THREADS, unit_bytes=unit, row_units=row_bytes // unit,
                grid=min(-(-n // THREADS), wave), n_vec=n_vec, n_sm=n_sm,
                blocks_per_sm=per_sm)


def device_geometry(kind: str, plan, x: torch.Tensor,
                    buf: Optional[torch.Tensor] = None,
                    layout: str = "rowwise") -> Dict[str, int]:
    """The geometry (``launch_geometry``'s keys) the library gives one
    launch of ``kind`` on the stacked CUDA x, without launching: the
    exchange of a ``DeviceExchange``, or the pack into (unpack from)
    ``buf`` of a ``DeviceTransfer``."""
    if kind == "exchange":
        rows, dst = plan.src, plan.dst
    else:
        rows, dst = (plan.send if kind == "pack" else plan.recv), None
    flat, dim = flat_view(plan, x, layout)
    out = (ctypes.c_int64 * len(_GEOMETRY_KEYS))()
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        rc = getattr(lib, GEOMETRY_ENTRY)(
            KINDS.index(kind), x.element_size(), x.data_ptr(),
            None if buf is None else buf.data_ptr(), rows.data_ptr(),
            None if dst is None else dst.data_ptr(), int(rows.shape[0]),
            *_geometry(flat, dim), out)
    scs_spmv.raise_for(lib, rc, f"halo {kind} geometry query")
    return dict(zip(_GEOMETRY_KEYS, (int(v) for v in out)))


def halo_exchange(ex: DeviceExchange, x: torch.Tensor,
                  layout: str = "rowwise") -> torch.Tensor:
    """Fill the halo rows of the stacked buffer x in place (see the module
    docstring). An exchange without pairs launches nothing. Returns x."""
    try:
        name = _ENTRY_POINTS[x.dtype]
    except KeyError:
        raise TypeError(f"the halo exchange takes float32 or float64 x, "
                        f"not {x.dtype}") from None
    flat, dim = flat_view(ex, x, layout)
    if x.device != ex.src.device:
        raise ValueError(f"x is on {x.device}, the exchange on "
                         f"{ex.src.device}")
    if ex.n == 0:
        return x
    if x.device.type == "cpu":
        return halo_exchange_plain(ex, x, layout)
    if x.device.type != "cuda":
        raise ValueError(
            f"halo_exchange runs on cuda or cpu tensors, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("halo_exchange needs a contiguous buffer")
    _launch(name, x, ex.src, ex.dst, ex.n, _geometry(flat, dim))
    return x


def _geometry(flat: torch.Tensor, dim: int) -> tuple:
    """(ld, ncols, vstride, n_vec) of the kernels' layout for the flat view
    of a stacked buffer whose rows lie along ``dim``."""
    if dim == 1:
        geo = (1, 1, flat.shape[1], flat.shape[0])
    else:
        ncols = 1 if flat.dim() == 1 else flat.shape[1]
        geo = (ncols, ncols, 0, 1)
    if geo[3] > MAX_VECTORS:
        raise ValueError(f"colwise block vectors take at most {MAX_VECTORS} "
                         f"vectors in one launch, not {geo[3]}")
    return geo


def _launch(name: str, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            n: int, geo: tuple) -> None:
    """One launch of entry point ``name`` on x's device and current stream,
    booked in its count."""
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        rc = getattr(lib, name)(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), n, *geo,
            torch.cuda.current_stream(x.device).cuda_stream)
    book_launch(lib, rc, name, _launches)


# ---------------------------------------- rows that cross card groups


@dataclasses.dataclass
class DeviceTransfer:
    """One card group's rows of one precision's exchange that cross groups
    (the groups of one process, or processes of one group each): the local
    rows it sends, grouped by destination group, and the halo rows it
    receives, grouped by source group, as rows of its stacked x
    (``n_shards`` shards of ``length`` rows); per group, the counts of
    both. ``active`` is whether any group of the run sends a row: across
    processes the transfer is a collective, so every process takes part or
    none."""

    send: torch.Tensor  # int32 [n_send]
    recv: torch.Tensor  # int32 [n_recv]
    send_counts: List[int]  # per destination group
    recv_counts: List[int]  # per source group
    n_shards: int
    length: int
    active: bool

    @property
    def n_send(self) -> int:
        return int(self.send.shape[0])

    @property
    def n_recv(self) -> int:
        return int(self.recv.shape[0])

    def buffer_shape(self, n: int, n_values: int) -> tuple:
        """The buffer of n rows of ``n_values`` values (bs of a block)."""
        return (n,) if n_values == 1 else (n, n_values)

    def bound_bytes(self, x_itemsize: int, n_values: int = 1,
                    pack: bool = True) -> int:
        """Bytes of the pack (or unpack) per call: the index of each row
        read once, its values read once and written once."""
        n = self.n_send if pack else self.n_recv
        return n * (4 + 2 * x_itemsize * n_values)


def build_device_transfer(send: List[np.ndarray], recv: List[np.ndarray],
                          n_shards: int, length: int, active: bool,
                          device: torch.device) -> DeviceTransfer:
    """The host's per-group row lists (``parallel.halo.split_exchange_rows``
    with the groups as its processes) on ``device``, concatenated in group
    order as int32."""
    rows = n_shards * length
    if rows > np.iinfo(np.int32).max:
        raise OverflowError(f"{rows} stacked rows exceed int32 indices")

    def put(parts):
        a = (np.concatenate(parts) if parts else np.zeros(0, np.int64))
        if a.size and not (0 <= a.min() and a.max() < rows):
            raise ValueError("a transfer row lies outside the stacked buffer")
        return torch.from_numpy(a.astype(np.int32)).to(device)

    return DeviceTransfer(
        send=put(send), recv=put(recv),
        send_counts=[int(a.size) for a in send],
        recv_counts=[int(a.size) for a in recv],
        n_shards=n_shards, length=length, active=active)


@dataclasses.dataclass(frozen=True)
class PeerSlice:
    """One move of a transfer between the card groups of one process: rows
    [send_lo, send_lo + n) of group ``src``'s send buffer land in rows
    [recv_lo, recv_lo + n) of group ``dst``'s receive buffer."""

    src: int
    dst: int
    send_lo: int
    recv_lo: int
    n: int


def peer_plan(transfers: List[DeviceTransfer], first: int = 0
              ) -> List[PeerSlice]:
    """The moves between the card groups of one process whose G transfers
    are ``transfers`` (group g's ``DeviceTransfer`` built with the groups
    of the run as its "processes", this process's groups numbered from
    ``first`` among them): the ``send_counts``/``recv_counts`` split of
    ``all_to_all_single`` as one slice per pair of this process's groups
    that exchanges rows, senders in order, ``src`` and ``dst`` numbered
    from 0. A sender's slice for group h starts after its rows for groups
    < h; a receiver's slice from group g after its rows from groups < g."""
    send_at = [np.concatenate([[0], np.cumsum(t.send_counts)])
               for t in transfers]
    recv_at = [np.concatenate([[0], np.cumsum(t.recv_counts)])
               for t in transfers]
    out = []
    for g, t in enumerate(transfers):
        for h in range(len(transfers)):
            n = t.send_counts[first + h]
            if h == g or n == 0:
                continue
            if transfers[h].recv_counts[first + g] != n:
                raise ValueError(
                    f"group {g} sends {n} rows to group {h}, which expects "
                    f"{transfers[h].recv_counts[first + g]}")
            out.append(PeerSlice(g, h, int(send_at[g][first + h]),
                                 int(recv_at[h][first + g]), int(n)))
    return out


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """The rows of one process's card groups that cross processes, staged
    through its lead card (its first group's) for one
    ``all_to_all_single``: ``stage`` copies each group's rows for each
    other process from the group's send buffer into the lead's (``dst``
    0), ordered by destination process, then by sending group, then by
    receiving group; ``unstage`` copies the lead's receive buffer (``src``
    0), ordered by source process, then by sending group, then by
    receiving group, into each group's receive buffer. ``send_counts`` and
    ``recv_counts``: the all-to-all's split, per process."""

    send_counts: List[int]
    recv_counts: List[int]
    stage: List[PeerSlice]
    unstage: List[PeerSlice]

    @property
    def n_send(self) -> int:
        return sum(self.send_counts)

    @property
    def n_recv(self) -> int:
        return sum(self.recv_counts)


def _merged(moves: List[PeerSlice]) -> List[PeerSlice]:
    """``moves`` with each run of slices that continue one another at both
    ends (same groups, consecutive rows) merged into one copy."""
    out: List[PeerSlice] = []
    for m in moves:
        last = out[-1] if out else None
        if (last is not None and (last.src, last.dst) == (m.src, m.dst)
                and last.send_lo + last.n == m.send_lo
                and last.recv_lo + last.n == m.recv_lo):
            out[-1] = dataclasses.replace(last, n=last.n + m.n)
        else:
            out.append(m)
    return out


def stage_plan(counts: np.ndarray, process_of: np.ndarray,
               me: int) -> StagePlan:
    """The ``StagePlan`` of process ``me`` from ``counts`` [G, G], the rows
    each group of the run sends each other group (``parallel.halo.
    group_pair_counts``), and ``process_of`` [G], each group's process
    (ascending). Group g's send buffer holds its rows by destination group,
    group h's receive buffer its rows by source group
    (``split_exchange_rows``), so a group's rows for one other process
    leave in one copy; what one sending group sends to one receiving group
    arrives in one copy, merged with the next where both ends continue."""
    counts = np.asarray(counts, dtype=np.int64)
    process_of = np.asarray(process_of, dtype=np.int64)
    P = int(process_of[-1]) + 1
    first = np.searchsorted(process_of, np.arange(P + 1))
    mine = range(int(first[me]), int(first[me + 1]))
    send_counts, recv_counts = [0] * P, [0] * P
    stage, unstage = [], []
    at = 0
    for q in range(P):
        if q == me:
            continue
        for j, g in enumerate(mine):
            n = int(counts[g, first[q]:first[q + 1]].sum())
            if n:
                stage.append(PeerSlice(j, 0, int(counts[g, :first[q]].sum()),
                                       at, n))
                at += n
        send_counts[q] = at - sum(send_counts)
    at = 0
    for p in range(P):
        if p == me:
            continue
        start = at
        for g in range(int(first[p]), int(first[p + 1])):
            for j, h in enumerate(mine):
                n = int(counts[g, h])
                if n:
                    unstage.append(PeerSlice(0, j, at,
                                             int(counts[:g, h].sum()), n))
                    at += n
        recv_counts[p] = at - start
    return StagePlan(send_counts=send_counts, recv_counts=recv_counts,
                     stage=_merged(stage), unstage=_merged(unstage))


def peer_copy(plan: List[PeerSlice], sends: List[torch.Tensor],
              recvs: List[torch.Tensor], streams=None) -> None:
    """Every move of ``plan``: ``recvs[dst][rows].copy_(sends[src][rows],
    non_blocking=True)``, a device-to-device copy (a peer copy where the
    groups' cards differ and have peer access). PyTorch runs it on the
    current stream of the sender's card, after the current stream of the
    receiver's card has reached it, and that stream waits for the copy.
    ``streams``: per move, the (sender's, receiver's) CUDA streams to make
    current for its copy; where both lie on one card, the sender's."""
    from contextlib import ExitStack

    for i, m in enumerate(plan):
        with ExitStack() as stack:
            if streams is not None:
                stack.enter_context(torch.cuda.stream(streams[i][1]))
                stack.enter_context(torch.cuda.stream(streams[i][0]))
            recvs[m.dst][m.recv_lo:m.recv_lo + m.n].copy_(
                sends[m.src][m.send_lo:m.send_lo + m.n], non_blocking=True)


def _check_buffer(tr: DeviceTransfer, x: torch.Tensor, buf: torch.Tensor,
                  n: int, layout: str) -> tuple:
    flat, dim = flat_view(tr, x, layout)
    n_val = x.numel() // (tr.n_shards * tr.length)
    if tuple(buf.shape) != tr.buffer_shape(n, n_val) or buf.dtype != x.dtype \
            or buf.device != x.device or not buf.is_contiguous():
        raise ValueError(
            f"the buffer must be contiguous {x.dtype} "
            f"{tr.buffer_shape(n, n_val)} on {x.device}; got {buf.dtype} "
            f"{tuple(buf.shape)} on {buf.device}")
    return flat, dim


def halo_pack_plain(tr: DeviceTransfer, x: torch.Tensor, buf: torch.Tensor,
                    layout: str = "rowwise") -> torch.Tensor:
    """Plain PyTorch version of the pack: buffer row i takes the row
    ``tr.send[i]`` of the stacked x. Returns buf."""
    flat, dim = _check_buffer(tr, x, buf, tr.n_send, layout)
    rows = flat.index_select(dim, tr.send)
    return buf.copy_(rows.t() if dim == 1 else rows)


def halo_unpack_plain(tr: DeviceTransfer, buf: torch.Tensor, x: torch.Tensor,
                      layout: str = "rowwise") -> torch.Tensor:
    """Plain PyTorch version of the unpack: row ``tr.recv[i]`` of the
    stacked x takes buffer row i. Returns x."""
    flat, dim = _check_buffer(tr, x, buf, tr.n_recv, layout)
    flat.index_copy_(dim, tr.recv.long(), buf.t() if dim == 1 else buf)
    return x


def _buffer_kernel(table: dict, tr: DeviceTransfer, x: torch.Tensor,
                   buf: torch.Tensor, rows: torch.Tensor, layout: str,
                   plain) -> None:
    try:
        name = table[x.dtype]
    except KeyError:
        raise TypeError(f"the halo pack and unpack take float32 or float64 "
                        f"x, not {x.dtype}") from None
    n = int(rows.shape[0])
    flat, dim = _check_buffer(tr, x, buf, n, layout)
    if rows.device != x.device:
        raise ValueError(f"x is on {x.device}, the transfer on "
                         f"{rows.device}")
    if n == 0:
        return
    if x.device.type == "cpu":
        plain()
        return
    if x.device.type != "cuda":
        raise ValueError(f"the halo pack and unpack run on cuda or cpu "
                         f"tensors, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("the halo pack and unpack need a contiguous x")
    _launch(name, x, buf, rows, n, _geometry(flat, dim))


def halo_pack(tr: DeviceTransfer, x: torch.Tensor, buf: torch.Tensor,
              layout: str = "rowwise") -> torch.Tensor:
    """Gather the rows this group sends into ``buf`` (``[n_send]`` or
    ``[n_send, bs]``): one launch of the pack kernel for CUDA tensors, the
    plain version for CPU tensors; nothing to send launches nothing.
    Returns buf."""
    _buffer_kernel(PACK_ENTRY_POINTS, tr, x, buf, tr.send, layout,
                   lambda: halo_pack_plain(tr, x, buf, layout))
    return buf


def halo_unpack(tr: DeviceTransfer, buf: torch.Tensor, x: torch.Tensor,
                layout: str = "rowwise") -> torch.Tensor:
    """Scatter the received rows of ``buf`` into the halo rows of the
    stacked x, in place: one launch of the unpack kernel for CUDA tensors,
    the plain version for CPU tensors. Returns x."""
    _buffer_kernel(UNPACK_ENTRY_POINTS, tr, x, buf, tr.recv, layout,
                   lambda: halo_unpack_plain(tr, buf, x, layout))
    return x
