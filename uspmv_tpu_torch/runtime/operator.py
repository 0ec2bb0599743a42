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

import dataclasses
import os
import warnings
from typing import Dict, Optional, Tuple, Union

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
)
from ..ops.scs_packed import spmv_packed, spmv_packed_plain
from ..ops.scs_pieces import spmv_pieces, spmv_pieces_plain
from ..ops.scs_solve import solve_fits, solve_scs
from ..ops.scs_spmv import record_captured_launches, spmv_scs, spmv_scs_plain
from ..ops.vectors import from_device_layout, init_x_host, to_device_layout
from ..precision.partition import partition_precisions


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


def guard_scs_explosion(mtx: MtxData, C: int, sigma: int):
    """Estimate SCS padding before converting; degrade to CRS when (C,
    sigma) would explode (e.g. one 17k-nnz row at C=1024 inflates its
    whole chunk to 17M elements). Port of the JAX operator's
    ``_guard_scs_explosion``: same rule, same warning."""
    if C <= 1 or mtx.nnz == 0:
        return C, sigma
    counts = np.bincount(mtx.I, minlength=mtx.n_rows).astype(np.int64)
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
MAX_SOLVE_GRAPHS = 4  # captured graphs an operator keeps, least recent out

# kernel nodes replayed by the graph solves of this process, per SpMV entry
# point: bookkeeping from capture time times the replays, kept apart from
# the wrappers' launch counts, which hold launches they made themselves
_graph_nodes_replayed: Dict[str, int] = {}


def graph_nodes_replayed() -> Dict[str, int]:
    """Kernel nodes replayed by ``SpmvOperator.solve(impl="graph")``, per
    SpMV entry point. A replay launches its nodes on the card without
    passing through ``spmv_scs``, so they are no part of its launch
    count."""
    return dict(_graph_nodes_replayed)


def reset_graph_nodes_replayed() -> None:
    _graph_nodes_replayed.clear()


@dataclasses.dataclass
class _SolveGraph:
    """k captured iterations of ``SpmvOperator.spmv`` over static vectors."""

    graph: "torch.cuda.CUDAGraph"
    x_in: torch.Tensor  # iteration 0 reads it
    bufs: Tuple[torch.Tensor, torch.Tensor]  # iteration i writes bufs[i & 1]
    nodes: Dict[str, int]  # kernel nodes per replay, by entry point


class OperatorBase:
    """What ``SpmvOperator`` and the sharded
    ``parallel.distributed.DistributedSpmvOperator`` share, for an operator
    with ``config``, ``nnz``, ``nnz_per_precision()``, ``spmv(x, out=...)``
    and a ``_solve_graphs`` dict: the metrics below, and solve impl
    "graph", k iterations of ``spmv`` with the x <-> y swap captured once
    per (k, x shape, x dtype) into a CUDA graph over static vectors and
    replayed. The vectors start zeroed, so rows that ``spmv(out=...)``
    does not write (a sharded operator's halo rows) hold no garbage."""

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

    def matrix_passes(self) -> int:
        """Matrix streams per SpMV and precision: one, or one per vector
        for colwise block vectors."""
        if self.config.vector_layout == "colwise":
            return self.config.block_vec_size
        return 1

    def hp_nnz_fraction(self) -> float:
        """Share of the stored nonzeros in bf16, which sets the validation
        bound of hp mixes (runtime/validate.compare); 1.0 unless AP."""
        if not self.config.is_ap:
            return 1.0
        npp = self.nnz_per_precision()
        return npp.get("hp", 0) / max(sum(npp.values()), 1)

    def _solve_graph(self, x: torch.Tensor, k: int) -> tuple:
        if x.device.type != "cuda":
            raise ValueError(
                f"solve impl 'graph' needs a CUDA device, x is on {x.device}; "
                "use impl='loop'"
            )
        if k < 1:
            return torch.zeros_like(x), x
        key = (k, tuple(x.shape), x.dtype)
        g = self._solve_graphs.pop(key, None)
        if g is None:
            while len(self._solve_graphs) >= MAX_SOLVE_GRAPHS:
                del self._solve_graphs[next(iter(self._solve_graphs))]
            g = self._capture_solve(x, k)
        self._solve_graphs[key] = g
        g.x_in.copy_(x)
        g.graph.replay()
        for name, n in g.nodes.items():
            _graph_nodes_replayed[name] = _graph_nodes_replayed.get(name, 0) + n
        prev = x if k == 1 else g.bufs[k & 1].clone()
        return prev, g.bufs[(k - 1) & 1].clone()

    def _capture_solve(self, x: torch.Tensor, k: int) -> _SolveGraph:
        """Capture k iterations of ``spmv`` over static vectors. The
        kernels are built, loaded and launched once on a side stream
        first: none of that is legal inside a capture."""
        x_in = torch.empty_like(x)
        bufs = (torch.zeros_like(x), torch.zeros_like(x))
        x_in.copy_(x)
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            self.spmv(x_in, out=bufs[0])
        torch.cuda.current_stream(x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with record_captured_launches() as nodes:
            with torch.cuda.graph(graph):
                src = x_in
                for it in range(k):
                    src = self.spmv(src, out=bufs[it & 1])
        return _SolveGraph(graph=graph, x_in=x_in, bufs=bufs,
                           nodes=dict(nodes))


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
    # captured solve graphs by (k, x shape, x dtype), most recent last,
    # at most MAX_SOLVE_GRAPHS of them
    _solve_graphs: dict = dataclasses.field(default_factory=dict, repr=False)

    # ----------------------------------------------------------------- build

    @classmethod
    def from_mtx(cls, config: Config, mtx: MtxData) -> "SpmvOperator":
        config.validate()
        check_one_shard(config)
        device = resolve_device(config)
        mtx = mtx.copy()
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

        # heavy-row splitting: after scaling, which is per original row;
        # before conversion, whose padding it is there to bound. Virtual
        # row n_real + v of the split matrix is piece v.
        n_real, nnz = mtx.n_rows, mtx.nnz
        parent = None
        th = split_threshold(config, mtx, C)
        if th:
            mtx, parent = split_heavy_rows(mtx, th)
            if lr is not None and parent is not None:
                lr = np.concatenate([lr, lr[parent]])

        C, sigma = guard_scs_explosion(real_rows(mtx, n_real), C, sigma)

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
        # go through the same one
        full_perm = np.arange(primary.n_rows_padded, dtype=np.int32)
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
        return cls(
            config=config,
            n_rows=primary.n_rows,
            n_rows_padded=primary.n_rows_padded,
            scs=scs,
            devs={p: build(s, device, dtype_for(p)) for p, s in scs.items()},
            old_to_new=primary.old_to_new_idx[: primary.n_rows],
            matrix_stats=matrix_stats,
            nnz=nnz,
            device=device,
            pieces={
                p: build_device_pieces(
                    ids, cols, vals, piece_parent_row, primary.n_rows_padded,
                    device, dtype_for(p), config.working_dtype(), bs)
                for p, (ids, cols, vals) in (pieces or {}).items()
            },
        )

    # ------------------------------------------------------------- execution

    def spmv(self, x: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One y = A x in device layout (permuted/padded). Adaptive
        precision sums the streams in order, highest precision first: the
        first writes y, each later one adds into it (the JAX closure's
        y = y + y_k); after each stream its heavy-row pieces, if any, add
        into their parents' rows. With ``out`` given, y is written into
        that buffer (not x itself) instead of a new tensor."""
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
        int32 columns + chunk or row-group metadata), once per matrix pass,
        its pieces (CSR stream, parents' runs, partial sums) once per
        vector, + x + y in the working dtype. Not comparable with the JAX
        package's count, whose lane tiles stream int16 gather tables."""
        total = self.matrix_passes() * sum(
            dev.stream_bytes() for dev in self.devs.values()
        ) + self.config.block_vec_size * sum(
            pc.stream_bytes() for pc in self.pieces.values()
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
        (they and the packed tier stream no padding)."""
        out = {}
        for p, d in self.devs.items():
            extra = self.pieces[p].nnz if p in self.pieces else 0
            streamed = (d.nnz if isinstance(d, DevicePacked)
                        else d.n_elements) + extra
            out[p] = (d.nnz + extra) / streamed if streamed else 1.0
        return out

    def nnz_per_precision(self) -> Dict[str, int]:
        return {p: s.nnz + (self.pieces[p].nnz if p in self.pieces else 0)
                for p, s in self.scs.items()}

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
