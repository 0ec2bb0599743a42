"""SpmvOperator — the kernel dispatch / execution object.

Port of ``uspmv_tpu/runtime/operator.py`` (reference ``SpmvKernel``,
classes_structs.hpp:280-1166) for one device: SCS or CRS at the user's
(C, sigma), dp/sp/hp values, the four adaptive-precision (AP) splits, one
vector or a block of vectors (SpMMV, rowwise or colwise). Pipeline
(reference init_local_structs, main.cpp:1074-1334):

  ingest COO -> [jacobi | equilibrate] -> [split heavy rows] ->
  SCS-explosion guard on the real part -> [AP partition] -> convert_to_scs
  (the highest precision defines the row permutation, the rest reuse it)
  -> symmetric column permutation -> device tensors, by tier -> spmv (the
  CUDA kernels per precision stream, or their plain versions on the CPU)

Tiers, per precision stream. The real rows (each clamped to the split
threshold) run as SELL-C-sigma at the user's (C, sigma) (ops/scs_spmv.py)
or, when that layout would stream mostly padding, as packed row groups in
the same row order (ops/scs_packed.py; ``Config.mixed_tiles`` forces or
forbids it, None chooses by the fill beta). The virtual rows cut off heavy
rows (``Config.split_rows_threshold``: N, 0 = auto, -1 = off) are a CSR
stream of pieces whose sums are folded into their parents' rows
(ops/scs_pieces.py). Unlike the JAX operator, which sorts its virtual rows
into the SCS and folds them afterwards, the pieces never enter the SCS, so
``old_to_new`` and the SCS arrays cover the real rows only.

Unlike the JAX package, the port does not re-tile (C, sigma) into
1024-row lane-tile chunks: the CUDA kernel runs the user's layout as it
is. -dp_emu runs native f64 (the TPU's df64 pairs are not needed), and
rows are split under it too. Solve mode (k repetitions of y = A x with a swap) runs
as a Python loop of launches, as one CUDA graph of those launches (the
counterpart of the JAX operator's jitted ``lax.scan``) or as one launch of
the fused solve kernel (ops/scs_solve.py, the counterpart of its opt-in
``solve_lane_tiles``). impl='xla' or use_pallas=False runs the plain
PyTorch version of every stream on the chosen device (the counterpart of
the JAX package's ops/spmv_xla.py); impl='auto' never does on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..config import Config, dtype_for, host_values, numpy_dtype
from ..formats.coo import (
    MtxData,
    equilibrate_matrix,
    extract_matrix_min_mean_max,
    jacobi_scale_matrix,
    split_heavy_rows,
)
from ..formats.scs import ScsData, convert_to_scs, permute_scs_cols
from ..ops.device_format import (
    GROUP_MAX_ELEMS,
    DevicePacked,
    DevicePieces,
    DeviceScs,
    build_device_packed,
    build_device_pieces,
    build_device_scs,
    vector_pass_count,
)
from ..ops.scs_packed import spmv_packed, spmv_packed_plain
from ..ops.scs_pieces import spmv_pieces, spmv_pieces_plain
from ..ops.scs_solve import solve_fits, solve_scs
from ..ops.scs_spmv import (
    record_captured_launches,
    spmv_scs,
    spmv_scs_plain,
)
from ..ops.vectors import from_device_layout, init_x_host, to_device_layout
from ..parallel import multihost
from ..precision.partition import partition_precisions
from . import profiling


class DeviceUnavailableError(RuntimeError):
    """backend='cuda' was asked for on a host where torch sees no GPU."""


def resolve_device(config: Config) -> torch.device:
    """The execution device named by ``config.backend``; never a silent
    fallback to the CPU."""
    if config.backend == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "backend 'cuda' requested but torch sees no CUDA device "
            f"(torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda}); use -backend cpu to run the plain "
            "PyTorch version on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def uses_kernels(config: Config) -> bool:
    """Whether the operator launches the hand-written kernels (impl='auto'
    with use_pallas, the default) or runs their plain PyTorch versions on
    the device ``config.backend`` names: impl='xla' or use_pallas=False,
    the user's explicit choice of the JAX package's XLA path
    (uspmv_tpu/runtime/operator.py:86, ops/spmv_xla.py), and impl='bcoo'
    on this operator, which the JAX operator runs there too (the CLI
    builds ``ops.spmv_bcoo.BcooSpmvOperator`` for it)."""
    return config.use_pallas and config.impl == "auto"


def run_rows(dev, x: torch.Tensor, layout: str, plain: bool,
             y: Optional[torch.Tensor] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One SELL-C-sigma or packed stream: y = A x, y += A x with ``y``,
    written into ``out`` with ``out``; through its kernel, or with
    ``plain`` through its plain PyTorch version on x's device."""
    packed = isinstance(dev, DevicePacked)
    if not plain:
        run = spmv_packed if packed else spmv_scs
        return run(dev, x, layout, y=y, out=out)
    run = spmv_packed_plain if packed else spmv_scs_plain
    if out is not None:
        return out.copy_(run(dev, x, layout))
    return run(dev, x, layout, y)


def run_pieces(dev: DevicePieces, x: torch.Tensor, layout: str,
               y: torch.Tensor, plain: bool) -> torch.Tensor:
    """y += the heavy-row pieces' products, by kernel or plain version."""
    return (spmv_pieces_plain if plain else spmv_pieces)(dev, x, layout, y)


def write_sparsity(path: str, scs: ScsData,
                   pieces: Optional[DevicePieces] = None,
                   col_unperm=None) -> None:
    """One precision's -output_sparsity file: ``scs`` as
    ``ScsData.write_to_mtx_file`` writes it; with the heavy-row pieces of
    that precision, their nonzeros folded back into their parents' rows
    (in the SCS's row and column numbering, then through its
    ``new_to_old_idx`` and ``col_unperm``) and the whole sorted by row."""
    if pieces is None:
        scs.write_to_mtx_file(path, col_unperm=col_unperm)
        return
    from ..io.mmio import write_mtx

    m = scs.to_mtx(col_unperm)
    rows = pieces.piece_rows.cpu().numpy()[pieces.piece_idxs.cpu().numpy()]
    cols = pieces.col_idxs.cpu().numpy()
    vals = pieces.values.to(torch.float64).cpu().numpy().astype(
        scs.values.dtype)
    keep = vals != 0.0
    cols = cols[keep]
    if col_unperm is not None:
        cols = np.asarray(col_unperm, dtype=np.int32)[cols]
    write_mtx(path, MtxData.from_arrays(
        np.concatenate([m.I, scs.new_to_old_idx[rows[keep]]]),
        np.concatenate([m.J, cols]),
        np.concatenate([m.values, vals[keep]]),
        n_rows=m.n_rows, n_cols=m.n_cols).sort_by_row())


def check_one_shard(config: Config) -> None:
    """``SpmvOperator`` runs the whole matrix on one device; a sharded
    configuration belongs to ``parallel.distributed``."""
    if config.n_shards > 1:
        raise ValueError(
            f"SpmvOperator runs one shard; n_shards={config.n_shards} runs "
            "through parallel.distributed.DistributedSpmvOperator")


MAX_SCS_EXPANSION = 16.0  # n_elements / nnz beyond which SCS is refused


# the packed tier is chosen (Config.mixed_tiles None) when the SELL-C-sigma
# fill beta of the real part at the user's (C, sigma) is below this
PACKED_BETA_CUTOFF = 0.5


def packed_tier(config: Config, scs: ScsData) -> bool:
    """Whether the rows of ``scs`` run as packed row groups: as
    ``config.mixed_tiles`` says (True raises later for a row no row group
    can stage), or, with None, when the fill beta is under
    PACKED_BETA_CUTOFF and every row fits a group. Adaptive-precision
    streams stay SELL-C-sigma, as in the JAX operator."""
    if config.is_ap:
        return False
    if config.mixed_tiles is not None:
        return config.mixed_tiles
    return (scs.beta < PACKED_BETA_CUTOFF
            and scs.row_counts_new is not None
            and int(scs.row_counts_new.max(initial=0)) <= GROUP_MAX_ELEMS)


def split_threshold(config: Config, mtx: MtxData, C: int) -> int:
    """The heavy-row split threshold in effect, 0 for none:
    ``config.split_rows_threshold`` as given when positive; for 0 the JAX
    operator's rule min(max(4 * mean row length, 32), 1024) (its packer
    probes measure TPU tiles and have no counterpart); none when negative
    or without chunks (C <= 1) whose padding a split would bound."""
    th = config.split_rows_threshold
    if th < 0 or C <= 1:
        return 0
    if th == 0:
        mean = max(mtx.nnz // max(mtx.n_rows, 1), 1)
        th = int(min(max(4 * mean, 32), 1024))
    return th


def real_rows(m: MtxData, n_real: int) -> MtxData:
    """The first ``n_real`` (real) rows of a row-sorted matrix whose
    further rows are the virtual rows of ``split_heavy_rows``."""
    if m.n_rows == n_real:
        return m
    cut = int(np.searchsorted(m.I, n_real))
    return dataclasses.replace(m, n_rows=n_real, nnz=cut, I=m.I[:cut],
                               J=m.J[:cut], values=m.values[:cut])


def guard_scs_explosion(mtx: MtxData, C: int, sigma: int,
                        row_counts: Optional[np.ndarray] = None):
    """Estimate SCS padding before converting; degrade to CRS when (C,
    sigma) would explode (e.g. one 17k-nnz row at C=1024 inflates its
    whole chunk to 17M elements). Port of the JAX operator's
    ``_guard_scs_explosion``: same rule, same warning. ``row_counts``:
    ``mtx.row_counts()``, where the caller has them."""
    if C <= 1 or mtx.nnz == 0:
        return C, sigma
    counts = mtx.row_counts() if row_counts is None else row_counts
    n_pad = ((mtx.n_rows + C - 1) // C) * C
    counts = np.pad(counts, (0, n_pad - counts.size))
    if sigma > 1:
        # sigma-window descending sort, window-aligned like the converter
        n_sig = ((n_pad + sigma - 1) // sigma) * sigma
        w = np.pad(counts, (0, n_sig - counts.size)).reshape(-1, sigma)
        counts = -np.sort(-w, axis=1).reshape(-1)[:n_pad]
    est = int(counts.reshape(-1, C).max(axis=1).sum()) * C
    if est > mtx.nnz * MAX_SCS_EXPANSION and est > (1 << 24):
        warnings.warn(
            f"SCS with C={C}, sigma={sigma} would pad {mtx.nnz} nonzeros to "
            f"{est} elements ({est / mtx.nnz:.0f}x); falling back to CRS. "
            "Increase sigma (row sorting) or use a smaller C for this "
            "matrix.",
            stacklevel=3,
        )
        return 1, 1
    return C, sigma


SOLVE_IMPLS = ("fused", "graph", "loop")
# captured solve graphs and bench batches an operator keeps, least recent out
MAX_SOLVE_GRAPHS = 4
MAX_BATCH_GRAPHS = 4

# kernel nodes replayed by the CUDA graphs of this process (solves and bench
# batches), per SpMV entry point: bookkeeping from capture time times the
# replays, kept apart from the wrappers' launch counts, which hold launches
# they made themselves
_graph_nodes_replayed: Dict[str, int] = {}


def graph_nodes_replayed() -> Dict[str, int]:
    """Kernel nodes replayed by ``SpmvOperator.solve(impl="graph")`` and by
    the captured batches of ``runtime.bench``, per SpMV entry point. A
    replay launches its nodes on the card without passing through
    ``spmv_scs``, so they are no part of its launch count."""
    return dict(_graph_nodes_replayed)


def reset_graph_nodes_replayed() -> None:
    _graph_nodes_replayed.clear()


def parts_of(x) -> tuple:
    """The tensors of a vector: x itself, or the per-card tensors of a
    sharded operator over several card groups (a tuple)."""
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def each(fn, x):
    """``fn`` applied to every tensor of a vector, in the vector's form."""
    return tuple(fn(t) for t in x) if isinstance(x, (tuple, list)) \
        else fn(x)


def join_cards(devices) -> None:
    """Make the current stream of the first of ``devices`` wait for the
    current streams of the others: what follows on it (a graph's replay,
    an event that ends a timed batch) comes after the work of every card."""
    cur = torch.cuda.current_stream(devices[0])
    for d in devices[1:]:
        if d != devices[0]:
            cur.wait_stream(torch.cuda.current_stream(d))


def fork_cards(devices) -> None:
    """Make the current streams of the others of ``devices`` wait for the
    first's: what follows on them (reading a replayed graph's output, the
    next copy into its input) comes after what the first card's stream
    holds."""
    cur = torch.cuda.current_stream(devices[0])
    for d in devices[1:]:
        if d != devices[0]:
            torch.cuda.current_stream(d).wait_stream(cur)


@contextlib.contextmanager
def capture_over(graph: "torch.cuda.CUDAGraph", devices: list):
    """Capture the launches of the block into ``graph`` (thread-local
    mode). On one card: on the default capture stream. Over several: on a
    new stream of the first card, the current stream of each other card a
    stream forked from it by an event and joined back into it at the end,
    so that one graph holds every card's nodes and its replay on the first
    card's stream ends after all of them. The block allocates nothing on
    the other cards: a capture pools the first card's memory only."""
    if len(devices) == 1:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            yield
        return
    cap = torch.cuda.Stream(device=devices[0])
    forks = [torch.cuda.Stream(device=d) for d in devices[1:]]
    with torch.cuda.device(devices[0]), torch.cuda.graph(
            graph, stream=cap, capture_error_mode="thread_local"), \
            contextlib.ExitStack() as stack:
        for s in forks:
            s.wait_stream(cap)
            stack.enter_context(torch.cuda.stream(s))
        yield
        for s in forks:
            cap.wait_stream(s)


@dataclasses.dataclass
class CapturedGraph:
    """Captured launches of ``spmv`` over static vectors: a solve's k
    iterations with the x <-> y swap (iteration i writes bufs[i & 1]), or a
    bench batch of n SpMVs that each read x_in and write bufs[0]. A vector
    of several card groups is a tuple of tensors, and the graph holds the
    nodes of every card."""

    graph: "torch.cuda.CUDAGraph"
    x_in: object  # the first (a batch: every) SpMV reads it
    bufs: tuple
    nodes: Dict[str, int]  # kernel nodes per replay, by entry point
    # the cards of its nodes, the capture's (and the replay's) first
    devices: list = dataclasses.field(default_factory=list)


class OperatorBase:
    """What ``SpmvOperator``, the sharded
    ``parallel.distributed.DistributedSpmvOperator`` and the vendor
    ``ops.spmv_bcoo.BcooSpmvOperator`` share, for an operator with
    ``config``, ``nnz``, ``nnz_per_precision()``, ``spmv(x, out=...)`` and
    ``_solve_graphs`` and ``_batch_graphs`` dicts: the metrics below; solve
    impl "graph", k iterations of ``spmv`` with the x <-> y swap captured
    once per (k, x shape, x dtype) into a CUDA graph over static vectors and
    replayed; and the bench's batch of n SpMVs captured the same way (the
    counterpart of the JAX harness's jitted runner). The vectors start
    zeroed, so rows that ``spmv(out=...)`` does not write (a sharded
    operator's halo rows) hold no garbage."""

    @property
    def working_dtype(self) -> torch.dtype:
        return self.config.working_dtype()

    @property
    def plain(self) -> bool:
        """Whether every stream runs its plain PyTorch version (impl='xla'
        or use_pallas=False; ``uses_kernels``), on the CPU or the card."""
        return not uses_kernels(self.config)

    def flops_per_spmv(self) -> int:
        """Useful flops only, padding excluded (reference main.cpp:521-526)."""
        return 2 * self.nnz * self.config.block_vec_size

    def matrix_passes(self, packed: bool = False) -> int:
        """Reads of one row stream from device memory per SpMV, in either
        layout: a SELL-C-sigma stream one per pass of <= 8 block vectors
        (``vector_pass_count``), a packed stream (``packed``) one, its column
        loop reading each group again from L1/L2."""
        if packed:
            return 1
        return vector_pass_count(self.config.block_vec_size)

    def transport(self) -> Optional[str]:
        """The transport of the operator's transfer between processes
        (parallel/multihost.py); None: it runs in one process."""
        return None

    def devices(self) -> list:
        """The devices of the operator's vectors: one, or one per card
        group of a sharded operator."""
        return [self.device]

    def graph_capturable(self) -> bool:
        """Whether a whole SpMV of this operator can sit in one CUDA graph
        (on a card): where its transfer, if any, stays on the cards."""
        return multihost.graph_capturable(self.transport())

    def hp_nnz_fraction(self) -> float:
        """Share of the stored nonzeros in bf16, which sets the validation
        bound of hp mixes (runtime/validate.compare); 1.0 unless AP."""
        if not self.config.is_ap:
            return 1.0
        npp = self.nnz_per_precision()
        return npp.get("hp", 0) / max(sum(npp.values()), 1)

    # ------------------------------------------------------- CUDA graphs

    def solve_graph(self, x, k: int) -> CapturedGraph:
        """The graph of k >= 1 solve iterations for x's shape and dtype
        (captured at the first call, then kept), with x copied into its
        static input; ``replay`` runs it. After a replay the result is
        bufs[(k - 1) & 1] and the last input bufs[k & 1] (x for k = 1)."""
        def capture(x_in, bufs):
            src = x_in
            for it in range(k):
                src = self.spmv(src, out=bufs[it & 1])

        return self._graph(self._solve_graphs, MAX_SOLVE_GRAPHS, (k,), x, 2,
                           capture)

    def batch_graph(self, x, n: int) -> CapturedGraph:
        """The graph of a bench batch for x's shape and dtype: n SpMVs
        ``spmv(x_in, out=bufs[0])``, each reading the same x as the JAX
        runner's ``x + y_prev[0] * 0`` does (so A^k x cannot overflow over
        a long batch); captured at the first call, then kept, with x copied
        into x_in."""
        def capture(x_in, bufs):
            for _ in range(n):
                self.spmv(x_in, out=bufs[0])

        return self._graph(self._batch_graphs, MAX_BATCH_GRAPHS, (n,), x, 1,
                           capture)

    @staticmethod
    def replay(g: CapturedGraph, times: int = 1) -> None:
        """Replay ``g`` ``times`` times, its kernel nodes counted in
        ``graph_nodes_replayed``. A replay runs on the current stream of
        the first card; over several cards that stream first waits for the
        others' current streams (the copies into x_in), and theirs wait
        for it after (what reads bufs there)."""
        join_cards(g.devices)
        for _ in range(times):
            g.graph.replay()
        fork_cards(g.devices)
        for name, n in g.nodes.items():
            _graph_nodes_replayed[name] = (_graph_nodes_replayed.get(name, 0)
                                           + n * times)

    def _graph(self, cache: dict, limit: int, key: tuple, x,
               n_bufs: int, body) -> CapturedGraph:
        """The cached graph of ``key`` and x's shape and dtype, captured
        by ``body(x_in, bufs)`` over new static vectors where there is none
        (the least recent of ``limit`` graphs goes); x copied into x_in."""
        parts = parts_of(x)
        if any(t.device.type != "cuda" for t in parts):
            raise ValueError(
                f"a CUDA graph needs a CUDA device, x is on "
                f"{parts[0].device}; use impl='loop'")
        key = (*key, tuple(tuple(t.shape) for t in parts), parts[0].dtype)
        g = cache.pop(key, None)
        if g is None:
            while len(cache) >= limit:
                del cache[next(iter(cache))]
            g = self._capture(x, n_bufs, body)
        cache[key] = g
        for dst, src in zip(parts_of(g.x_in), parts):
            dst.copy_(src)
        return g

    def _capture(self, x, n_bufs: int, body) -> CapturedGraph:
        """Capture ``body(x_in, bufs)`` over static vectors shaped like x.
        The kernels are built, loaded and launched once first (on a side
        stream for one card): none of that is legal inside a capture. The
        capture is thread-local: a process group's watchdog thread may
        query its events meanwhile. Over several cards one graph holds
        every card's nodes (``capture_over``); every buffer exists before
        the capture. A capture that fails raises, naming the operator;
        nothing falls back to a loop."""
        x_in = each(torch.clone, x)
        bufs = tuple(each(torch.zeros_like, x) for _ in range(n_bufs))
        devices = list(dict.fromkeys(t.device for t in parts_of(x)))
        if len(devices) == 1:
            cur = torch.cuda.current_stream(devices[0])
            side = torch.cuda.Stream(device=devices[0])
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.spmv(x_in, out=bufs[0])
            cur.wait_stream(side)
        else:
            self.spmv(x_in, out=bufs[0])
            for d in devices:
                torch.cuda.synchronize(d)
        graph = torch.cuda.CUDAGraph()
        try:
            with record_captured_launches() as nodes, \
                    capture_over(graph, devices):
                body(x_in, bufs)
        except Exception as e:
            raise RuntimeError(
                f"CUDA-graph capture of {self.impl_name()} failed: {e}"
            ) from e
        if multihost.is_multiprocess():
            multihost.hold_graph(graph)  # its collectives: reset first
        return CapturedGraph(graph=graph, x_in=x_in, bufs=bufs,
                             nodes=dict(nodes), devices=devices)

    def _solve_graph(self, x, k: int) -> tuple:
        if any(t.device.type != "cuda" for t in parts_of(x)):
            raise ValueError(
                f"solve impl 'graph' needs a CUDA device, x is on "
                f"{parts_of(x)[0].device}; use impl='loop'"
            )
        if k < 1:
            return each(torch.zeros_like, x), x
        g = self.solve_graph(x, k)
        self.replay(g)
        prev = x if k == 1 else each(torch.clone, g.bufs[k & 1])
        return prev, each(torch.clone, g.bufs[(k - 1) & 1])


@dataclasses.dataclass
class SpmvOperator(OperatorBase):
    config: Config
    n_rows: int
    n_rows_padded: int
    # host struct per precision, highest first: the real rows, each
    # clamped to the split threshold
    scs: Dict[str, ScsData]
    # device stream of those rows per precision, same order: SELL-C-sigma
    # or packed row groups
    devs: Dict[str, Union[DeviceScs, DevicePacked]]
    old_to_new: np.ndarray
    matrix_stats: tuple
    nnz: int  # the whole matrix's nnz (dropped elements included)
    device: torch.device
    # the virtual rows of split heavy rows, per precision that has any
    pieces: Dict[str, DevicePieces] = dataclasses.field(default_factory=dict)
    split_threshold: int = 0  # the threshold in effect, 0: rows not split
    n_dropped: int = 0
    jacobi_diag: Optional[np.ndarray] = None
    equilib: Optional[tuple] = None
    # captured solve graphs by (k, x shape, x dtype) and bench batches by
    # (n, x shape, x dtype), most recent last, at most MAX_SOLVE_GRAPHS and
    # MAX_BATCH_GRAPHS of them
    _solve_graphs: dict = dataclasses.field(default_factory=dict, repr=False)
    _batch_graphs: dict = dataclasses.field(default_factory=dict, repr=False)

    # ----------------------------------------------------------------- build

    @classmethod
    def from_mtx(cls, config: Config, mtx: MtxData) -> "SpmvOperator":
        """The operator of ``mtx`` under ``config``, in the spans
        ``from_mtx`` and, inside it, ``from_mtx.prepare`` (sort, stats,
        scaling, row counts, split, explosion guard, precision partition),
        ``from_mtx.convert`` (``convert_to_scs`` of every precision),
        ``from_mtx.permute`` (the symmetric column permutation, the
        pieces' columns) and ``from_scs.upload``. ``mtx`` is left as it
        was, its arrays and its attributes."""
        with profiling.span("from_mtx"):
            return cls._from_mtx(config, mtx)

    @classmethod
    def _from_mtx(cls, config: Config, mtx: MtxData) -> "SpmvOperator":
        config.validate()
        check_one_shard(config)
        device = resolve_device(config)
        with profiling.span("from_mtx.prepare"):
            # the sort, the scalings and the split make new arrays and
            # rebind them; nothing writes into an array of ``mtx``, so its
            # arrays are shared and only the record is copied
            mtx = dataclasses.replace(mtx)
            if not mtx.is_sorted:
                mtx = mtx.sort_by_row()
            stats = extract_matrix_min_mean_max(mtx)

            # scaling is per original row, before partitioning
            jac = jacobi_scale_matrix(mtx) if config.jacobi_scale else None
            equilib = lr = lc = None
            if config.equilibrate:
                lr, lc = equilibrate_matrix(mtx)
                equilib = (lr, lc)

            C = config.chunk_size if config.kernel_format == "scs" else 1
            sigma = config.sigma if config.kernel_format == "scs" else 1

            # heavy-row splitting: after scaling, which is per original
            # row; before conversion, whose padding it is there to bound.
            # Virtual row n_real + v of the split matrix is piece v.
            n_real, nnz = mtx.n_rows, mtx.nnz
            parent = None
            th = split_threshold(config, mtx, C)
            # nonzeros per row, counted once for the split and the guard
            # (neither runs without chunks)
            counts = mtx.row_counts() if C > 1 else None
            if th:
                mtx, parent = split_heavy_rows(mtx, th, counts)
                if parent is not None:
                    counts = np.minimum(counts, th)  # the real rows' share
                    if lr is not None:
                        lr = np.concatenate([lr, lr[parent]])

            C, sigma = guard_scs_explosion(real_rows(mtx, n_real), C, sigma,
                                           counts)

            n_dropped = 0
            if config.is_ap:
                subs, n_dropped = partition_precisions(
                    mtx,
                    config.value_type,
                    config.ap_threshold_1,
                    config.ap_threshold_2,
                    equilibrate=config.equilibrate,
                    largest_row_elems=lr,
                    largest_col_elems=lc,
                    dropout=config.dropout,
                    dropout_threshold=config.dropout_threshold,
                )
            else:
                prec = config.value_type
                subs = {prec: dataclasses.replace(
                    mtx, values=host_values(mtx.values, prec))}
        # the highest precision defines the permutation; the rest reuse it
        # (reference main.cpp:1170-1221)
        with profiling.span("from_mtx.convert"):
            precs = list(subs)
            primary = convert_to_scs(real_rows(subs[precs[0]], n_real), C,
                                     sigma)
            scs = {precs[0]: primary}
            for p in precs[1:]:
                scs[p] = convert_to_scs(
                    real_rows(subs[p], n_real), C, sigma,
                    fixed_permutation=primary.old_to_new_idx,
                )
        # symmetric column permutation so x can live in permuted order
        # (reference main.cpp:1308 -> permute_scs_cols); the pieces' columns
        # go through the same one. The identity (sigma = 1) moves nothing.
        with profiling.span("from_mtx.permute"):
            full_perm = np.arange(primary.n_rows_padded, dtype=np.int32)
            if not np.array_equal(primary.old_to_new_idx,
                                  full_perm[: primary.n_rows]):
                full_perm[: primary.n_rows] = primary.old_to_new_idx
                for s in scs.values():
                    permute_scs_cols(s, full_perm)
            pieces = None
            if parent is not None:
                pieces = {}
                for p, sub in subs.items():
                    cut = int(np.searchsorted(sub.I, n_real))
                    if cut < sub.nnz:
                        pieces[p] = (sub.I[cut:].astype(np.int64) - n_real,
                                     full_perm[sub.J[cut:]], sub.values[cut:])
        op = cls.from_scs(
            config, scs, stats, nnz, device, pieces=pieces,
            piece_parent_row=(None if parent is None
                              else primary.old_to_new_idx[parent]))
        op.split_threshold = th
        op.n_dropped = n_dropped
        op.jacobi_diag = jac
        op.equilib = equilib
        return op

    @classmethod
    def from_scs(
        cls,
        config: Config,
        scs,
        matrix_stats: tuple,
        nnz: int,
        device: Optional[torch.device] = None,
        pieces: Optional[Dict[str, tuple]] = None,
        piece_parent_row: Optional[np.ndarray] = None,
    ) -> "SpmvOperator":
        """Operator over given host ``ScsData`` (one, or a dict per
        precision in ``config.ap_precisions`` order sharing one row
        permutation) whose columns are already symmetrically permuted
        (``permute_scs_cols``). ``device`` defaults to the one
        ``config.backend`` names. ``pieces``: per precision, the (piece id,
        permuted column, value) arrays of the virtual rows split off heavy
        rows, with ``piece_parent_row[v]`` the permuted row of piece v's
        parent. The tier of the SCS rows follows ``config.mixed_tiles``:
        True packs them (raising for a row no row group can stage), False
        keeps SELL-C-sigma, None packs when the fill beta is under
        PACKED_BETA_CUTOFF and every row fits a group; adaptive-precision
        streams stay SELL-C-sigma, as in the JAX operator."""
        config.validate()
        check_one_shard(config)
        if device is None:
            device = resolve_device(config)
        if isinstance(scs, ScsData):
            scs = {config.value_type: scs}
        if tuple(scs) != config.ap_precisions:
            raise ValueError(
                f"{config.value_type} needs SCS for {config.ap_precisions}, "
                f"got {tuple(scs)}"
            )
        for p, s in scs.items():
            expect = host_values(np.zeros(0), p).dtype
            if s.values.dtype != expect:
                raise TypeError(
                    f"{p} needs {expect} host values, got {s.values.dtype}"
                )
        primary = next(iter(scs.values()))
        build = (build_device_packed if packed_tier(config, primary)
                 else build_device_scs)
        bs = config.block_vec_size
        # the device streams; while spans are on, the card drained at the
        # end, so that the span holds the copies
        with profiling.span("from_scs.upload"):
            devs = {p: build(s, device, dtype_for(p)) for p, s in scs.items()}
            dev_pieces = {
                p: build_device_pieces(
                    ids, cols, vals, piece_parent_row, primary.n_rows_padded,
                    device, dtype_for(p), config.working_dtype(), bs)
                for p, (ids, cols, vals) in (pieces or {}).items()
            }
            if profiling.enabled() and device.type == "cuda":
                torch.cuda.synchronize(device)
        op = cls(
            config=config,
            n_rows=primary.n_rows,
            n_rows_padded=primary.n_rows_padded,
            scs=scs,
            devs=devs,
            old_to_new=primary.old_to_new_idx[: primary.n_rows],
            matrix_stats=matrix_stats,
            nnz=nnz,
            device=device,
            pieces=dev_pieces,
        )
        profiling.count(profiling.UPLOAD_BYTES,
                        sum(op.device_bytes().values()))
        return op

    # ------------------------------------------------------------- execution

    def spmv(self, x: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One y = A x in device layout (permuted/padded). Adaptive
        precision sums the streams in order, highest precision first: the
        first writes y, each later one adds into it (the JAX closure's
        y = y + y_k); after each stream its heavy-row pieces, if any, add
        into their parents' rows. With ``out`` given, y is written into
        that buffer (not x itself) instead of a new tensor. Span ``spmv``:
        the launches inside it are booked to it."""
        with profiling.span("spmv"):
            layout = self.config.vector_layout
            plain = self.plain
            y = None
            for p, dev in self.devs.items():
                if y is None:
                    y = run_rows(dev, x, layout, plain, out=out)
                else:
                    run_rows(dev, x, layout, plain, y=y)
                if p in self.pieces:
                    run_pieces(self.pieces[p], x, layout, y, plain)
            return y

    def is_packed(self) -> bool:
        """Whether the real rows run as packed row groups."""
        return any(isinstance(d, DevicePacked) for d in self.devs.values())

    def fused_solve_eligible(self) -> bool:
        """Whether solve mode can run k iterations in ONE launch of the
        fused solve kernel (ops/scs_solve.solve_scs): a single
        SELL-C-sigma stream (no adaptive-precision sum, no heavy-row pieces,
        not the packed tier), one vector or rowwise block
        vectors of at most 8 columns, a square operator. The counterpart of
        the JAX operator's ``_fused_solve_eligible`` without its VMEM and
        df64 limits; the opt-in (``USPMV_FUSED_SOLVE``) is read by
        ``solve_impl_name``, not here."""
        if (len(self.devs) != 1 or self.pieces or self.is_packed()
                or self.plain):
            return False
        (dev,) = self.devs.values()
        bs = self.config.block_vec_size
        shape = ((self.n_rows_padded,) if bs == 1
                 else (self.n_rows_padded, bs)
                 if self.config.vector_layout == "rowwise"
                 else (bs, self.n_rows_padded))
        return solve_fits(dev, shape, self.working_dtype,
                          self.config.vector_layout)

    def solve_impl_name(self, n_repetitions: int = 2,
                        impl: Optional[str] = None) -> str:
        """Which implementation ``solve(x, n_repetitions, impl)`` runs:
        "fused", "graph" or "loop". With impl=None, the JAX package's own
        rule: the fused kernel only when ``USPMV_FUSED_SOLVE`` is set and
        the operator is eligible, else one CUDA graph of the launches on a
        CUDA device for more than one repetition, else the loop."""
        if impl is not None:
            if impl not in SOLVE_IMPLS:
                raise ValueError(
                    f"solve impl must be one of {SOLVE_IMPLS}, not {impl!r}")
            return impl
        if os.environ.get("USPMV_FUSED_SOLVE") and self.fused_solve_eligible():
            return "fused"
        if self.device.type == "cuda" and n_repetitions > 1:
            return "graph"
        return "loop"

    def solve(self, x: torch.Tensor, n_repetitions: int,
              impl: Optional[str] = None) -> tuple:
        """Solve mode: n_repetitions of y = A x with x<->y swap (reference
        main.cpp:528-607 + swap_local_vectors). Returns (x_last_input,
        y_result) after the final iteration, device layout; both are the
        caller's to keep (the graph path copies them out of its static
        buffers, which the next solve overwrites; it keeps the graphs of
        the MAX_SOLVE_GRAPHS most recent (n_repetitions, x shape, dtype),
        each with three vectors of x's size, so a caller who varies
        n_repetitions widely pays a capture per new value).

        ``impl``: "loop", a Python loop of launches; "graph", the same
        launches captured once per (n_repetitions, x shape, dtype) into a
        CUDA graph and replayed (CUDA devices only); "fused", one launch of
        the fused solve kernel, which raises on an operator that
        ``fused_solve_eligible`` refuses. None picks by ``solve_impl_name``.
        All three give the same bits on a CUDA device."""
        impl = self.solve_impl_name(n_repetitions, impl)
        if impl == "fused":
            if not self.fused_solve_eligible():
                raise ValueError(
                    "the fused solve kernel takes one SELL-C-sigma stream "
                    "without heavy-row pieces, with one vector or rowwise "
                    "block vectors of <= 8 columns; this operator is "
                    f"{self.impl_name()}, "
                    f"block_vec_size={self.config.block_vec_size} "
                    f"{self.config.vector_layout}. Use impl='graph' or "
                    "'loop'."
                )
            if n_repetitions < 1:
                return torch.zeros_like(x), x
            (dev,) = self.devs.values()
            return solve_scs(dev, x, n_repetitions, self.config.vector_layout)
        if impl == "graph":
            return self._solve_graph(x, n_repetitions)
        prev = torch.zeros_like(x)
        for _ in range(n_repetitions):
            prev, x = x, self.spmv(x)
        return prev, x

    # ------------------------------------------------------------- vectors

    def make_x(self, x_in: Optional[np.ndarray] = None) -> torch.Tensor:
        """x in the working dtype (f64 for dp and ap[dp_*], f32 for sp, hp
        and ap[sp_hp]), permuted and padded into the device layout."""
        host = init_x_host(
            self.config,
            self.n_rows,
            self.matrix_stats,
            x_in=x_in,
            dtype=numpy_dtype(self.working_dtype),
        )
        dev = to_device_layout(
            host, self.config.vector_layout, self.n_rows_padded, self.old_to_new
        )
        return torch.from_numpy(dev).to(self.device)

    def to_host(self, y: torch.Tensor) -> np.ndarray:
        return from_device_layout(
            y.detach().cpu().numpy(), self.config.vector_layout, self.old_to_new
        )

    # ------------------------------------------------------------- metrics

    def bytes_per_spmv(self) -> int:
        """Minimum traffic: each precision's matrix stream (values +
        int32 columns of the slots the kernel reads, chunk pointers and
        group lengths or row-group metadata), once per matrix pass
        (``matrix_passes``), its pieces (CSR stream, parents' runs, records,
        counters) once per pass of <= 8 vectors and the long parents'
        partial sums once per vector (``DevicePieces.stream_bytes``), + x +
        y in the working dtype. Not comparable with the JAX package's
        count, whose lane tiles stream int16 gather tables."""
        total = sum(
            self.matrix_passes(isinstance(dev, DevicePacked))
            * dev.stream_bytes() for dev in self.devs.values()
        ) + sum(
            pc.stream_bytes(self.config.block_vec_size)
            for pc in self.pieces.values()
        )
        xw = torch.empty((), dtype=self.working_dtype).element_size()
        total += self.n_rows_padded * self.config.block_vec_size * xw * 2
        return total

    def beta(self) -> Dict[str, float]:
        """Fill efficiency of the user's (C, sigma) format per precision
        (reference main.cpp:693), over the real rows as they are stored:
        clamped to the split threshold, the pieces left out."""
        return {p: s.beta for p, s in self.scs.items()}

    def device_beta(self) -> Dict[str, float]:
        """Nonzeros over the elements the kernels stream, pieces included
        (they and the packed tier stream no padding; the SELL kernel the
        slots below each group's length)."""
        out = {}
        for p, d in self.devs.items():
            extra = self.pieces[p].nnz if p in self.pieces else 0
            streamed = (d.nnz if isinstance(d, DevicePacked)
                        else d.n_read) + extra
            out[p] = (d.nnz + extra) / streamed if streamed else 1.0
        return out

    def nnz_per_precision(self) -> Dict[str, int]:
        return {p: s.nnz + (self.pieces[p].nnz if p in self.pieces else 0)
                for p, s in self.scs.items()}

    def device_bytes(self) -> Dict[str, int]:
        """Bytes of each device buffer, read from the tensors when asked:
        ``<precision>.<field>`` of each row stream (values, col_idxs and
        the chunk and group tables, or the packed tier's row pointers,
        groups and row_idxs; a SELL-C-sigma stream's row_idxs once read)
        and ``<precision>.pieces.<field>`` of its heavy-row pieces."""
        streams = [*self.devs.items(),
                   *((f"{p}.pieces", pc) for p, pc in self.pieces.items())]
        return {f"{prefix}.{f.name.lstrip('_')}": getattr(dev, f.name).nbytes
                for prefix, dev in streams for f in dataclasses.fields(dev)
                if isinstance(getattr(dev, f.name), torch.Tensor)}

    def n_pieces(self) -> int:
        """Virtual rows split off heavy rows, over all precisions."""
        return sum(pc.n_pieces for pc in self.pieces.values())

    def nnz_in_pieces(self) -> int:
        return sum(pc.nnz for pc in self.pieces.values())

    def impl_name(self) -> str:
        """Which implementation executes, by tier and value type:
        cuda-scs, cuda-scs+pieces, cuda-packed or cuda-packed+pieces (the
        CUDA kernels) or torch-plain-... (their plain PyTorch versions: on
        the CPU, and on the card for impl='xla')."""
        where = ("cuda" if self.device.type == "cuda" and not self.plain
                 else "torch-plain")
        tier = ("packed" if self.is_packed() else "scs") + (
            "+pieces" if self.pieces else "")
        return f"{where}-{tier}-{self.config.value_type}"

    def dump_sparsity(self, outdir: str) -> list:
        """-output_sparsity (reference OUTPUT_SPARSITY, main.cpp:1225-1254):
        each precision's nonzeros in original row and column indices, into
        ``<precision>_local_scs.mtx``; its heavy-row pieces, which this
        port keeps out of the SCS, are folded back as entries of their
        parents' rows (``write_sparsity``). Without pieces the JAX
        operator's files byte for byte."""
        unperm = next(iter(self.scs.values())).new_to_old_idx
        paths = []
        for p, s in self.scs.items():
            path = os.path.join(outdir, f"{p}_local_scs.mtx")
            write_sparsity(path, s, self.pieces.get(p), col_unperm=unperm)
            paths.append(path)
        return paths
