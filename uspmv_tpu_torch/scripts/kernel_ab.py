"""Two or more versions of the port's kernels, timed in turns on the same
inputs in one process on one card: the paired comparison of a kernel change
(the parent's sources against the change's).

    python -m uspmv_tpu_torch.scripts.kernel_ab --lib NAME=CSRC_DIR
        [--lib NAME=CSRC_DIR ...]
        [--cases sell,padded,packed,solve,pieces,gather,halo]
        [--reps R] [--rounds N] [--out PATH]

Each CSRC_DIR is a copy of ``uspmv_tpu_torch/csrc`` (the parent commit's,
unpacked by ``git archive``, or an edited copy). Every one is built with the
flags of ``ops/_build.py`` into a library of its own, all builds at once,
and cuobjdump's registers per kernel are printed for each. The cases:

    sell    Laplace3D-128 at C=1024, sigma=1 (the headline) with every
            (values, x) pair of scs_spmv.cu, its all-ones pattern as a
            unit stream, sp with rowwise bs 4, 8 and 12 (passes of 8
            and 4) and colwise bs 4 and 8, and each pair with f64 x at
            rowwise bs 4 (cuSPARSE's SpMM beside them where the types
            agree: A @ X, colwise A @ X.t());
            Laplace3D-160, sp. The bound reads the matrix once: the
            least any design of the kernel streams
    padded  the SELL-C-sigma streams with padding to skip, at C=1024,
            sigma=1, each as the operator of its path builds it: path E's
            three (WideSpectrum-55 ap[dp_sp_hp] -dp_emu, thresholds 1e-2 /
            1e-5: f64, f32 and bf16 values with f64 x), Hubbard-13/6 sp
            and FemTet3D-55 sp; then streams whose groups skip a few
            percent, read by group lengths in the change's tree whatever
            GROUP_SKIP_PER_ROW says: FemTet3D-55 sp at sigma 8192, 16384,
            32768 and 65536, StokesSaddle-64 sp and the headline. The
            bound is the function's own bytes (each nonzero's value and
            column, x and y once over the real rows); each row carries the
            slots its version reads and the share the groups skip
    packed  RandomImbalanced-500k at C=1024, sigma=1, split at the
            operator's automatic threshold: its packed rows as dp, sp, hp,
            and sp with colwise bs 4 and 8
    solve   the fused solve (scs_solve.cu), k=32, on the headline's matrix
            scaled by 1/16 (row sums of |A| <= 1), sp, one vector and
            rowwise bs 4
    pieces  the heavy-row pieces (scs_pieces.cu) of the same
            RandomImbalanced-500k operators as dp, sp, hp, added into a
            random y; then sp with rowwise and colwise bs 4 and 8, slots
            and counters sized for a row per vector (what a tree that
            reads the pieces once per vector needs, more than one per
            pass), cuSPARSE's SpMM on the pieces' sub-matrix beside them
    gather  x_access.cu's gather_store against index_select: 2^24
            banded and random indices into an x of 8.4 MB, and the
            columns of RandomImbalanced-500k's packed rows and pieces (sp,
            as the packed and pieces cases), the indices of chip_smoke.py's
            gather floors
    halo    halo_exchange.cu on Laplace3D-128 (values / 16, so a solve
            stays finite), sp, C=1024, sigma=1, split into R shards by
            rows: the exchange of the R=4 plan (98,304 rows) in f32, f64
            and rowwise bs 8, and on the plan's first pair alone (the
            launch floor); the pack and unpack of process 0's 16,384 rows
            of that plan over 2 processes, f32 and f64, and on one row;
            the sharded op.spmv at R=4 and R=8 with the overlap off and
            on, and the graph solve (k=64) at R=4, each with the exchange
            of the library version under test

On a case every library's kernel runs on the same tensors, in the order
first..last then last..first, --rounds times; each turn is one replay of a
CUDA graph of R launches (the solve: R launches timed by CUDA events).
cuSPARSE (``torch.sparse_csr_tensor @ x``) on the same matrix, where the
value and x types agree, or ``torch.index_select`` for the gather, takes
its turns among them, timed by CUDA events; for the halo cases
``index_select`` + ``index_copy_`` (the op.spmv and the solve with that
pair as their exchange) takes them, by replayed graph as the versions.
The op.spmv and solve cases swap only the halo library: every other
kernel is the package's own build. One row per (case, library)
gives the median ms, the samples, the byte bound, whether y equals the
first library's bit for bit, and the error against the plain version. A
tree whose pieces kernel is the pair of a piece pass and a fold pass (the
design before the work records) takes that design's arguments (parent
runs and rows, one partial per piece); so does a tree whose SELL row loop
walks each chunk to its length (no ``kGroupRows`` in scs_row.cuh): its
SpMV and solve entry points take no group lengths. The entry points of
older designs are not bound.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..io import generators
from ..ops import (
    _build,
    halo_exchange,
    scs_packed,
    scs_pieces,
    scs_solve,
    scs_spmv,
    x_access,
)
from ..ops.device_format import DeviceScs, build_device_scs, group_table
from ..runtime import card
from ..runtime.operator import SpmvOperator
from . import _common, gather_probe

NAME = "kernel_ab"
CASES = ("sell", "padded", "packed", "solve", "pieces", "gather", "halo")
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
SOLVE_K = 32
# the pieces entry points of the two-pass design: (n_pieces, piece_ptr,
# col_idxs, values, n_parents, parent_ptr, parent_row, x, x_ld, x_vstride,
# partials, y, y_ld, y_vstride, n_vec)
_PIECES_ARGTYPES_TWO_PASS = (
    [ctypes.c_int64] + [ctypes.c_void_p] * 3 + [ctypes.c_int64]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2
    + [ctypes.c_int64] * 2 + [ctypes.c_int, ctypes.c_void_p]
)
# the SpMV and solve entry points of a row loop to each chunk's length: the
# matrix arguments without group_lengths and their bytes
_SCS_ARGTYPES_CHUNKS = (scs_spmv._ARGTYPES[:4] + scs_spmv._ARGTYPES[6:])
_SOLVE_ARGTYPES_CHUNKS = (scs_solve._ARGTYPES[:4] + scs_solve._ARGTYPES[6:])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"uspmv_tpu_torch.scripts.{NAME}",
                                description=__doc__.split("\n")[0])
    p.add_argument("--lib", action="append", required=True,
                   metavar="NAME=CSRC_DIR",
                   help="a version of the kernels' sources (repeat)")
    p.add_argument("--cases", default=",".join(CASES),
                   help=f"comma-separated, of {CASES}")
    p.add_argument("--reps", type=int, default=100)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--out", default=None,
                   help=f"JSON rows are appended here (default "
                        f"{_common.default_out(NAME)})")
    return p


def parse_libs(specs: List[str]) -> Dict[str, Path]:
    """NAME=CSRC_DIR arguments, in order; names must differ."""
    libs = {}
    for spec in specs:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            raise ValueError(f"--lib takes NAME=CSRC_DIR, not {spec!r}")
        if name in libs:
            raise ValueError(f"--lib {name} given twice")
        libs[name] = Path(path)
    return libs


def turns(names: List[str], rounds: int) -> List[str]:
    """first..last, last..first, ``rounds`` times: every version runs as
    often early as late."""
    return [n for _ in range(rounds) for n in (*names, *reversed(names))]


def has_group_lengths(csrc: Path) -> bool:
    """Whether the tree's SELL row loop takes group lengths (else it walks
    each chunk to its length: the design before them)."""
    return "kGroupRows" in (csrc / "scs_row.cuh").read_text()


def with_every_group(dev: DeviceScs, host, device) -> DeviceScs:
    """``dev`` with the table of group lengths whatever share of its slots
    they skip (GROUP_SKIP_PER_ROW passes none under a quarter of a slot
    per row)."""
    table, n_read = group_table(host, skip_per_row=0)
    return dataclasses.replace(
        dev, group_lengths=torch.as_tensor(table, device=device),
        n_read=n_read)


def pieces_abi(csrc: Path) -> str:
    """'records' where the tree's pieces kernel walks work records, else
    'two_pass' (a piece pass, then a fold pass)."""
    text = (csrc / "scs_pieces.cu").read_text()
    return "records" if "arrivals" in text else "two_pass"


class Version:
    """One tree's library with its argument types bound."""

    def __init__(self, name: str, csrc: Path, lib_path: Path):
        self.name, self.path = name, lib_path
        self.lib = ctypes.CDLL(str(lib_path))
        self.pieces_abi = pieces_abi(csrc)
        self.groups = has_group_lengths(csrc)
        chunks = not self.groups
        for entry in [*scs_spmv._ENTRY_POINTS.values(), scs_spmv.UNIT_ENTRY]:
            self._bind(entry, _SCS_ARGTYPES_CHUNKS if chunks
                       else scs_spmv._ARGTYPES)
        for entry in scs_packed._ENTRY_POINTS.values():
            self._bind(entry, scs_packed._ARGTYPES)
        for entry in scs_solve._ENTRY_POINTS.values():
            self._bind(entry, _SOLVE_ARGTYPES_CHUNKS if chunks
                       else scs_solve._ARGTYPES)
        for entry in scs_pieces._ENTRY_POINTS.values():
            self._bind(entry, scs_pieces._ARGTYPES
                       if self.pieces_abi == "records"
                       else _PIECES_ARGTYPES_TWO_PASS)
        for entry, argtypes in x_access._ARGTYPES.items():
            self._bind(entry, argtypes)
        for entry in halo_exchange.launch_counts():
            self._bind(entry, halo_exchange._ARGTYPES)
        self.lib.uspmv_cuda_error_string.argtypes = [ctypes.c_int]
        self.lib.uspmv_cuda_error_string.restype = ctypes.c_char_p

    def _bind(self, entry: str, argtypes) -> None:
        fn = getattr(self.lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int

    def matrix_args(self, dev: DeviceScs) -> tuple:
        """``dev``'s arguments to this tree's SpMV or solve entry point:
        the wrapper's, or for a tree before group lengths those without
        them."""
        if self.groups:
            return scs_spmv.matrix_args(dev)
        return (dev.n_rows_padded, dev.C, dev.chunk_ptrs.data_ptr(),
                dev.chunk_lengths.data_ptr(), dev.col_idxs.data_ptr(),
                dev.values.data_ptr())

    def slots_read(self, dev: DeviceScs) -> int:
        """The slots this tree's row loop reads of ``dev``."""
        return dev.n_read if self.groups else dev.n_elements

    def call(self, entry: str, *args) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        scs_spmv.raise_for(self.lib, getattr(self.lib, entry)(*args, stream),
                           f"{self.name} {entry}")


def build_all(libs: Dict[str, Path]) -> Dict[str, Version]:
    """Every tree into build/uspmv_tpu_torch/kernel_ab/<name>/, at once
    (each tree an nvcc per source, ``_build.compile_library``)."""
    t0 = time.perf_counter()
    outs = {}
    for name, csrc in libs.items():
        sources = sorted(csrc.glob("*.cu"))
        if not sources:
            raise _build.KernelBuildError(f"no CUDA sources under {csrc}")
        out = _build.BUILD_DIR / NAME / name / "lib.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        outs[name] = (sources, out)
    with ThreadPoolExecutor(max_workers=len(outs)) as pool:
        done = dict(zip(outs, pool.map(
            lambda so: _build.compile_library(*so), outs.values())))
    for name, (_, steps) in done.items():
        print(f"{name}: slowest source "
              f"{max(v for k, v in steps.items() if k != 'link'):.1f} s, "
              f"link {steps['link']:.1f} s")
    print(f"built {len(outs)} libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    return {name: Version(name, libs[name], out)
            for name, (_, out) in outs.items()}


def resources(versions: Dict[str, Version]) -> List[dict]:
    """Registers of the row-sum, pieces and gather-store kernels of every
    version."""
    rows = []
    for v in versions.values():
        for r in _build.kernel_resources(v.path):
            if any(k in r["function"] for k in (
                    "scs_spmv_kernel", "scs_ones_kernel", "scs_packed_kernel",
                    "scs_solve_kernel", "scs_probe_kernel",
                    "scs_pieces_", "gather_store_kernel",
                    "halo_")):
                rows.append(dict(kind="resources", lib=v.name, **r))
    return rows


def csr_call(rows, cols, vals, n, x) -> Callable[[], torch.Tensor]:
    """``A @ x`` by cuSPARSE for the given triples (device tensors)."""
    A = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]),
                                vals.to(x.dtype), size=(n, n)
                                ).coalesce().to_sparse_csr()
    A = torch.sparse_csr_tensor(A.crow_indices().int(),
                                A.col_indices().int(), A.values(),
                                size=(n, n), check_invariants=False)
    return lambda: A @ x


def events_ms(fn: Callable[[], object], reps: int) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls, CUDA events
    around a loop on the host."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired(case: str, versions: Dict[str, Version], run, plain_y,
           nbytes: int, reps: int, rounds: int, library=None,
           timer=None, y0=None, library_name="cusparse",
           tol=None, library_timer=None) -> List[dict]:
    """One case: ``run(version, y)`` writes y = the product (or, with
    ``y0``, adds it into y = a copy of y0); each version is checked against
    ``plain_y`` (to ``tol``, default TOL of its dtype) and the first
    version's y, then timed in turns with ``library`` (a call, or None;
    timed by ``library_timer``, default CUDA events around a loop)."""
    device = plain_y.device
    tol = TOL[plain_y.dtype] if tol is None else tol
    ys, rows = {}, {}
    for name, v in versions.items():
        y = torch.empty_like(plain_y) if y0 is None else y0.clone()
        run(v, y)
        torch.cuda.synchronize()
        ys[name] = y
        first = next(iter(ys.values()))
        rows[name] = dict(
            kind="case", case=case, lib=name, bit_equal_to_first=bool(
                torch.equal(y, first)),
            bound_bytes=nbytes, bound_ms=_common.bound_ms(nbytes, device),
            **_common.check_close(y, plain_y, tol, f"{case} {name}"))
    timer = timer or (lambda fn: _common.device_ms(fn, reps, device))
    names = list(versions) + ([library_name] if library else [])
    samples = {n: [] for n in names}
    for n in turns(names, rounds):
        if n == library_name:  # allocates its result: events by default
            samples[n].append(library_timer(library) if library_timer
                              else events_ms(library, reps))
        else:
            y = ys[n]
            samples[n].append(timer(lambda v=versions[n], y=y: run(v, y)))
    if library:
        rows[library_name] = dict(kind="case", case=case, lib=library_name,
                                  bound_bytes=nbytes,
                                  bound_ms=_common.bound_ms(nbytes, device))
    out = []
    for n in names:
        ms = float(np.median(samples[n]))
        rows[n].update(ms=ms, samples_ms=samples[n],
                       share_of_bound=rows[n]["bound_ms"] / ms, reps=reps)
        out.append(rows[n])
    for r in out:
        print(f"{case:28s} {r['lib']:10s} {r['ms']:.5f} ms  bound "
              f"{r['bound_ms']:.5f} ({100 * r['share_of_bound']:.0f}%)"
              f"  bit-equal to first: {r.get('bit_equal_to_first', '-')}")
    return out


def sell_cases(versions, device, reps, rounds) -> List[dict]:
    rows = []
    f32 = (torch.float32, torch.float32)
    for spec in ("Laplace3D,128", "Laplace3D,160"):
        mtx = generators.generate_matrix(spec)
        op = SpmvOperator.from_mtx(
            Config(kernel_format="scs", chunk_size=1024, sigma=1,
                   value_type="sp", backend="cuda", split_rows_threshold=-1,
                   mixed_tiles=False), mtx)
        host = op.scs["sp"]
        n = host.n_rows_padded
        # (values, x), layout, bs; values None: the unit stream
        runs = [(f32, "rowwise", 1)]
        if spec.endswith("128"):
            runs = [(pair, "rowwise", 1) for pair in scs_spmv._ENTRY_POINTS]
            runs += [((None, torch.float32), "rowwise", 1),
                     (f32, "rowwise", 4), (f32, "rowwise", 8),
                     (f32, "rowwise", 12),
                     (f32, "colwise", 4), (f32, "colwise", 8)]
            # rowwise bs 4 with f64 x: 16-byte loads of x, as bs 8 f32
            runs += [(pair, "rowwise", 4) for pair in scs_spmv._ENTRY_POINTS
                     if pair[1] == torch.float64]
        rng = np.random.default_rng(0)
        for (vdt, xdt), layout, bs in runs:
            if vdt is None:  # the all-ones pattern without values
                ones = dataclasses.replace(host, values=(
                    host.values != 0).astype(np.float32))
                dev = build_device_scs(ones, device, unit_values=True)
            else:
                dev = build_device_scs(host, device, vdt)
            entry = scs_spmv.entry_for(dev, xdt)
            shape = ((n,) if bs == 1 else (n, bs) if layout == "rowwise"
                     else (bs, n))
            x = torch.as_tensor(rng.standard_normal(shape),
                                device=device).to(xdt)
            esize = x.element_size()
            # per launch of the wrapper: column offset, x_ld, x_vstride,
            # y_ld, y_vstride, ncols, n_vec (rowwise: a launch per pass)
            launches = ([(0, 1, 0, 1, 0, 1, 1)] if bs == 1 else
                        [(c0, bs, 0, bs, 0, k, 1)
                         for c0, k in scs_spmv.vector_passes(bs)]
                        if layout == "rowwise" else [(0, 1, n, 1, n, 1, bs)])

            def run(v, y, dev=dev, x=x, entry=entry, launches=launches,
                    esize=esize):
                for c0, x_ld, x_vs, y_ld, y_vs, ncols, n_vec in launches:
                    v.call(entry, *v.matrix_args(dev),
                           x.data_ptr() + c0 * esize, x_ld, x_vs,
                           y.data_ptr() + c0 * esize, y_ld, y_vs, ncols,
                           n_vec, 0)

            library = None
            if vdt == xdt:
                keep = dev.values != 0
                library = csr_call(dev.row_idxs[keep], dev.col_idxs[keep],
                                   dev.values[keep], n,
                                   x.t() if layout == "colwise" else x)
            case = f"{spec} {entry.replace('uspmv_scs_spmv_', '')}" + (
                f" {layout} bs={bs}" if bs > 1 else "")
            rows += paired(case, versions, run,
                           scs_spmv.spmv_scs_plain(dev, x, layout),
                           dev.stream_bytes() + 2 * x.numel() * esize,
                           reps, rounds, library)
            del dev
        del op, mtx
        torch.cuda.empty_cache()
    return rows


# label, matrix, configuration beyond C=1024, sp, sigma, and the streams
PADDED = (
    ("E", "WideSpectrum,55",
     dict(value_type="ap[dp_sp_hp]", dp_emulation=True, ap_threshold_1=1e-2,
          ap_threshold_2=1e-5), 1, ("dp", "sp", "hp")),
    ("Hubbard-13/6", "Hubbard,n_sites=13,n_fermions=6,U=1.3", {}, 1,
     ("sp",)),
    ("FemTet3D-55", "FemTet3D,55", dict(mixed_tiles=False), 1, ("sp",)),
)
# streams whose groups skip little, around GROUP_SKIP_PER_ROW slots per
# row: the change's tree reads them by group lengths whatever the rule
# says (``with_every_group``), a tree before them by chunk lengths.
# FemTet3D-55 (rows of about 55) sorted over ever larger windows,
# StokesSaddle-64 and the headline (rows of 7 or fewer) as they are
NEAR_CUTOFF = (
    *(("FemTet3D-55", "FemTet3D,55", dict(mixed_tiles=False), sigma,
       ("sp",)) for sigma in (8192, 16384, 32768, 65536)),
    ("StokesSaddle-64", "StokesSaddle,64", {}, 1, ("sp",)),
    ("Laplace3D-128", "Laplace3D,128",
     dict(split_rows_threshold=-1, mixed_tiles=False), 1, ("sp",)),
)


def padded_cases(versions, device, reps, rounds) -> List[dict]:
    rows = []
    rng = np.random.default_rng(5)
    for forced, table in ((False, PADDED), (True, NEAR_CUTOFF)):
        for label, spec, fields, sigma, streams in table:
            mtx = generators.generate_matrix(spec)
            op = SpmvOperator.from_mtx(
                Config(kernel_format="scs", chunk_size=1024, sigma=sigma,
                       backend="cuda", **{"value_type": "sp", **fields}),
                mtx)
            x = op.make_x(rng.standard_normal(op.n_rows))
            if sigma > 1:
                label = f"{label} sigma={sigma}"
            for p in streams:
                rows += padded_stream(versions, op, p, x, label, forced,
                                      device, reps, rounds)
            del op, mtx, x
            torch.cuda.empty_cache()
    return rows


def padded_stream(versions, op, p, x, label, forced, device, reps,
                  rounds) -> List[dict]:
    """Stream ``p`` of ``op``, one vector, every version in turns with
    cuSPARSE; the bound is the function's own bytes (each nonzero's value
    and column, x and y once over the real rows). ``forced``: with the
    group lengths whatever share they skip."""
    dev, host = op.devs[p], op.scs[p]
    if not isinstance(dev, DeviceScs):
        raise RuntimeError(f"padded case {label} {p}: "
                           f"{op.impl_name()} is not SELL")
    by_rule = bool(dev.group_length_bytes)
    if forced:
        dev = with_every_group(dev, host, device)
    entry = scs_spmv.entry_point(dev.values.dtype, x.dtype)

    def run(v, y):
        v.call(entry, *v.matrix_args(dev), x.data_ptr(), 1, 0, y.data_ptr(),
               1, 0, 1, 1, 0)

    keep = dev.values != 0
    library = csr_call(dev.row_idxs[keep], dev.col_idxs[keep],
                       dev.values[keep], op.n_rows_padded, x)
    own = (dev.nnz * (dev.values.element_size() + 4)
           + 2 * op.n_rows * x.element_size())
    case = f"{label} {p} {entry.replace('uspmv_scs_spmv_', '')}"
    out = paired(case, versions, run, scs_spmv.spmv_scs_plain(dev, x), own,
                 reps, rounds, library)
    skipped = 1 - dev.n_read / dev.n_elements
    per_row = (dev.n_elements - dev.n_read) / dev.n_rows_padded
    for r in out:
        r.update(nnz=dev.nnz, n_elements=dev.n_elements,
                 n_rows_padded=dev.n_rows_padded, skipped_share=skipped,
                 skipped_per_row=per_row, groups_by_rule=by_rule,
                 forced=forced)
        if r["lib"] in versions:
            read = versions[r["lib"]].slots_read(dev)
            r.update(slots_read=read, device_beta=dev.nnz / read)
            print(f"{'':28s} {r['lib']:10s} slots read {read:,} "
                  f"(beta {dev.nnz / read:.4f})")
    print(f"{'':28s} groups skip {100 * skipped:.2f}% of the slots, "
          f"{per_row:.3f} per row; "
          f"by the rule: {'group' if by_rule else 'chunk'} lengths"
          + ("; read by group lengths here" if forced else ""))
    return out


def packed_cases(versions, device, reps, rounds) -> List[dict]:
    rows = []
    mtx = generators.random_imbalanced(500_000, 8)
    for value_type, bs in (("dp", 1), ("sp", 1), ("hp", 1), ("sp", 4),
                           ("sp", 8)):
        op = SpmvOperator.from_mtx(
            Config(kernel_format="scs", chunk_size=1024, sigma=1,
                   value_type=value_type, backend="cuda"), mtx)
        (dev,) = op.devs.values()
        if not op.is_packed():
            raise RuntimeError(f"packed case: {op.impl_name()} is not packed")
        xdt = torch.float64 if value_type == "dp" else torch.float32
        n = dev.n_rows_padded
        x = torch.as_tensor(np.random.default_rng(1).standard_normal(
            (bs, n) if bs > 1 else n), device=device).to(xdt)
        entry = scs_packed.entry_point(dev.values.dtype, xdt)
        # x_ld, x_vstride, y_ld, y_vstride, n_vec of one vector or colwise
        strides = (1, n, 1, n, bs) if bs > 1 else (1, 0, 1, 0, 1)

        def run(v, y, dev=dev, x=x, entry=entry, strides=strides):
            x_ld, x_vs, y_ld, y_vs, n_vec = strides
            v.call(entry, dev.n_groups, dev.groups.data_ptr(),
                   dev.row_ptr.data_ptr(), dev.col_idxs.data_ptr(),
                   dev.values.data_ptr(), x.data_ptr(), x_ld, x_vs,
                   y.data_ptr(), y_ld, y_vs, 1, n_vec, 0,
                   scs_packed.stage_bytes(dev, x.dtype))

        library = None
        if dev.values.dtype == xdt:
            library = csr_call(dev.row_idxs, dev.col_idxs, dev.values, n,
                               x.t() if bs > 1 else x)
        layout = "colwise" if bs > 1 else "rowwise"
        case = f"RandomImbalanced-500k packed {value_type}" + (
            f" colwise bs={bs}" if bs > 1 else "")
        rows += paired(case, versions, run,
                       scs_packed.spmv_packed_plain(dev, x, layout),
                       dev.stream_bytes() + 2 * x.numel() * x.element_size(),
                       reps, rounds, library)
        del op, dev
        torch.cuda.empty_cache()
    return rows


def pieces_cases(versions, device, reps, rounds) -> List[dict]:
    rows = []
    mtx = generators.random_imbalanced(500_000, 8)
    for value_type in ("dp", "sp", "hp"):
        op = SpmvOperator.from_mtx(
            Config(kernel_format="scs", chunk_size=1024, sigma=1,
                   value_type=value_type, backend="cuda"), mtx)
        (pc,) = op.pieces.values()
        xdt = torch.float64 if value_type == "dp" else torch.float32
        n = pc.n_rows_padded
        rng = np.random.default_rng(3)
        x, y0 = (torch.as_tensor(rng.standard_normal(n), device=device
                                 ).to(xdt) for _ in range(2))
        entry = scs_pieces.entry_point(pc.values.dtype, xdt)
        # the two-pass design's buffer: one partial per piece
        two_pass = torch.zeros(pc.n_pieces, dtype=xdt, device=device)

        def run(v, y, pc=pc, x=x, entry=entry, two_pass=two_pass):
            if v.pieces_abi == "records":
                v.call(entry, pc.records.shape[0], pc.records.data_ptr(),
                       pc.longs.shape[0], pc.longs.data_ptr(),
                       pc.piece_ptr.data_ptr(), pc.parent_ptr.data_ptr(),
                       pc.parent_row.data_ptr(), pc.col_idxs.data_ptr(),
                       pc.values.data_ptr(), x.data_ptr(), 1, 0,
                       pc.slots.data_ptr(), pc.slots[0].numel(),
                       pc.arrivals.data_ptr(), y.data_ptr(), 1, 0, 1)
            else:
                v.call(entry, pc.n_pieces, pc.piece_ptr.data_ptr(),
                       pc.col_idxs.data_ptr(), pc.values.data_ptr(),
                       pc.n_parents, pc.parent_ptr.data_ptr(),
                       pc.parent_row.data_ptr(), x.data_ptr(), 1, 0,
                       two_pass.data_ptr(), y.data_ptr(), 1, 0, 1)

        library = None
        if pc.values.dtype == xdt:
            library = csr_call(pc.piece_rows[pc.piece_idxs.long()],
                               pc.col_idxs, pc.values, n, x)
        # as chip_smoke.py path G: the function's own stream, x at the
        # columns the pieces read, the parents' rows of y read and written
        nbytes = pc.function_bytes(1, x.element_size())
        rows += paired(
            f"RandomImbalanced-500k pieces {value_type}", versions, run,
            scs_pieces.spmv_pieces_plain(pc, x, "rowwise", y0.clone()),
            nbytes, reps, rounds, library, y0=y0)
        if value_type == "sp":
            for layout, bs in (("rowwise", 4), ("rowwise", 8),
                               ("colwise", 4), ("colwise", 8)):
                rows += pieces_block_case(versions, pc, layout, bs, device,
                                          reps, rounds)
        del op, pc
        torch.cuda.empty_cache()
    return rows


def pieces_block_case(versions, pc, layout, bs, device, reps,
                      rounds) -> List[dict]:
    """The pieces ``pc`` (sp) for ``bs`` block vectors of ``layout``,
    added into a random y, with slots and counters of a row per vector
    (zero before and after every launch, in either design); cuSPARSE's
    SpMM on the pieces' sub-matrix in turns. The bound reads the pieces
    once, and x at their columns and the parents' rows of y once per
    vector (``DevicePieces.function_bytes``)."""
    n = pc.n_rows_padded
    rng = np.random.default_rng(7)
    shape = (n, bs) if layout == "rowwise" else (bs, n)
    x, y0 = (torch.as_tensor(rng.standard_normal(shape), device=device,
                             dtype=torch.float32) for _ in range(2))
    slots = torch.zeros((bs, *pc.slots.shape[1:]), dtype=pc.slots.dtype,
                        device=device)
    arrivals = torch.zeros((bs, pc.longs.shape[0]), dtype=torch.int32,
                           device=device)
    entry = scs_pieces.entry_point(pc.values.dtype, x.dtype)
    # x_ld, x_vstride (y alike)
    ld, vs = (bs, 1) if layout == "rowwise" else (1, n)

    def run(v, y):
        if v.pieces_abi != "records":
            raise RuntimeError(f"{v.name}: block vectors need work records")
        v.call(entry, pc.records.shape[0], pc.records.data_ptr(),
               pc.longs.shape[0], pc.longs.data_ptr(),
               pc.piece_ptr.data_ptr(), pc.parent_ptr.data_ptr(),
               pc.parent_row.data_ptr(), pc.col_idxs.data_ptr(),
               pc.values.data_ptr(), x.data_ptr(), ld, vs, slots.data_ptr(),
               slots[0].numel(), arrivals.data_ptr(), y.data_ptr(), ld, vs,
               bs)

    library = csr_call(pc.piece_rows[pc.piece_idxs.long()], pc.col_idxs,
                       pc.values, n, x.t() if layout == "colwise" else x)
    nbytes = pc.function_bytes(bs, x.element_size())
    out = paired(
        f"RandomImbalanced-500k pieces sp {layout} bs={bs}", versions, run,
        scs_pieces.spmv_pieces_plain(pc, x, layout, y0.clone()), nbytes,
        reps, rounds, library, y0=y0)
    if slots.any() or arrivals.any():
        raise RuntimeError(f"pieces {layout} bs={bs}: slots or counters "
                           "left non-zero")
    return out


def gather_cases(versions, device, reps, rounds) -> List[dict]:
    n, n_x = 2**24, 2**21
    gen = torch.Generator(device=device).manual_seed(4)
    sets = {f"{pattern} x 8.4 MB": (gather_probe.sweep_index(
        pattern, n, n_x, gen, device), n_x)
        for pattern in ("banded", "random")}
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=1024, sigma=1,
               value_type="sp", backend="cuda"),
        generators.random_imbalanced(500_000, 8))
    for tier, dev in (("packed", op.devs["sp"]), ("pieces", op.pieces["sp"])):
        sets[f"RandomImbalanced-500k {tier} columns"] = (dev.col_idxs,
                                                         op.n_rows_padded)
    rows = []
    for name, (idx, n_x) in sets.items():
        x = torch.randn(n_x, generator=gen, device=device)

        def run(v, y, x=x, idx=idx):
            v.call(x_access.ENTRIES["gather_store"], x.data_ptr(),
                   idx.data_ptr(), y.data_ptr(), idx.numel())

        nbytes = 8 * idx.numel() + 4 * torch.unique(idx).numel()
        rows += paired(
            f"gather_store {name}", versions, run,
            x_access.gather_store_plain(x, idx), nbytes, reps, rounds,
            lambda x=x, idx=idx: torch.index_select(x, 0, idx),
            library_name="index_select", tol=0.0)
    return rows


def solve_cases(versions, device, reps, rounds) -> List[dict]:
    mtx = generators.generate_matrix("Laplace3D,128")
    mtx.values[:] = mtx.values / 16.0  # exact: row sums of |A| <= 12/16
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=1024, sigma=1,
               value_type="sp", backend="cuda", split_rows_threshold=-1,
               mixed_tiles=False), mtx)
    dev = op.devs["sp"]
    n = dev.n_rows_padded
    entry = scs_solve.entry_point(torch.float32, torch.float32)
    rng = np.random.default_rng(2)
    rows = []
    # one vector, and rowwise bs 4 (16-byte loads of x)
    for bs in (1, 4):
        shape = (n,) if bs == 1 else (n, bs)
        x0 = torch.as_tensor(rng.standard_normal(shape), device=device,
                             dtype=torch.float32)
        buf = torch.empty(2, *shape, dtype=torch.float32, device=device)

        def run(v, y, x0=x0, buf=buf, bs=bs):
            v.call(entry, *v.matrix_args(dev), x0.data_ptr(),
                   buf[0].data_ptr(), buf[1].data_ptr(), bs, bs, SOLVE_K)
            y.copy_(buf[(SOLVE_K - 1) & 1])

        def timer(fn):  # a cooperative launch of ~2 ms: events, few calls
            return events_ms(fn, max(reps // 20, 1))

        _, want = scs_solve.solve_scs_plain(dev, x0, SOLVE_K)
        nbytes = SOLVE_K * dev.stream_bytes() + 3 * n * bs * 4
        rows += paired(f"Laplace3D-128 fused solve sp k={SOLVE_K}"
                       + (f" rowwise bs={bs}" if bs > 1 else ""), versions,
                       run, want, nbytes, reps, rounds, None, timer)
    return rows


@contextlib.contextmanager
def halo_library(v: Optional[Version]):
    """The package's halo wrappers launch ``v``'s kernels inside (the
    exchange by ``index_select`` + ``index_copy_`` where v is None); every
    other kernel stays the package's own."""
    from ..parallel import distributed

    lib, exchange = halo_exchange._lib, distributed.halo_exchange
    if v is None:
        distributed.halo_exchange = halo_exchange.halo_exchange_plain
    else:
        halo_exchange._lib = v.lib
    try:
        yield
    finally:
        halo_exchange._lib, distributed.halo_exchange = lib, exchange


HALO_SOLVE_K = 64
HALO_LIBRARY = "index_select+index_copy_"


def halo_cases(versions, device, reps, rounds) -> List[dict]:
    from ..parallel.distributed import DistributedSpmvOperator
    from ..parallel.halo import split_exchange_rows

    mtx = generators.generate_matrix("Laplace3D,128")
    mtx.values[:] = mtx.values / 16.0  # exact: row sums of |A| <= 12/16
    base = dict(kernel_format="scs", chunk_size=1024, sigma=1,
                value_type="sp", backend="cuda")
    rng = np.random.default_rng(6)
    x_host = rng.standard_normal(mtx.n_rows)
    graph = dict(library_timer=lambda fn: _common.device_ms(fn, reps, device),
                 library_name=HALO_LIBRARY, tol=0.0)
    rows = []
    # every shard on the one card, on a host with several too
    ops = {(4, True): DistributedSpmvOperator.from_mtx(
        Config(**base, n_shards=4), mtx, devices=[device])}
    op4 = ops[(4, True)]
    ex, L = op4.groups[0].exchanges["sp"], op4.lengths["sp"]

    # the exchange kernel alone, in place on a stacked x whose halo rows
    # start at zero; its launch floor on the plan's first pair
    one = dataclasses.replace(ex, src=ex.src[:1], dst=ex.dst[:1])
    for label, plan, dtype, bs in (
            ("R=4 sp", ex, torch.float32, 1),
            ("R=4 dp", ex, torch.float64, 1),
            ("R=4 sp rowwise bs=8", ex, torch.float32, 8),
            ("one pair (launch floor) sp", one, torch.float32, 1)):
        shape = (4, L) if bs == 1 else (4, L, bs)
        x0 = torch.as_tensor(rng.standard_normal(shape), device=device
                             ).to(dtype)
        x0.view(4 * L, -1).index_fill_(0, ex.dst.long(), 0)
        entry = halo_exchange._ENTRY_POINTS[dtype]
        geo = halo_exchange._geometry(x0.view(4 * L, -1).squeeze(1), 0)
        xl = x0.clone()
        flat, dst64 = xl.view(4 * L, -1).squeeze(1), plan.dst.long()

        def run(v, y, plan=plan, entry=entry, geo=geo):
            v.call(entry, y.data_ptr(), plan.src.data_ptr(),
                   plan.dst.data_ptr(), plan.n, *geo)

        rows += paired(
            f"halo exchange {label}", versions, run,
            halo_exchange.halo_exchange_plain(plan, x0.clone()),
            plan.bound_bytes(x0.element_size(), bs), reps, rounds,
            lambda flat=flat, dst64=dst64, plan=plan: flat.index_copy_(
                0, dst64, flat.index_select(0, plan.src)), y0=x0, **graph)

    # pack and unpack: process 0's rows of the plan over 2 processes
    _, _, send, recv = split_exchange_rows(op4.halo_plans["sp"], L,
                                           np.array([0, 0, 1, 1]), 0)
    tr = halo_exchange.build_device_transfer(send, recv, 2, L, True, device)
    row = dataclasses.replace(tr, send=tr.send[:1], recv=tr.recv[:1],
                              send_counts=[1], recv_counts=[1])
    for dtype in (torch.float32, torch.float64):
        x = torch.as_tensor(rng.standard_normal((2, L)), device=device
                            ).to(dtype)
        inc = torch.as_tensor(rng.standard_normal(tr.n_recv), device=device
                              ).to(dtype)
        for plan in (tr, row):
            n, buf = plan.n_send, torch.empty(plan.n_send, dtype=dtype,
                                              device=device)
            pack = halo_exchange.PACK_ENTRY_POINTS[dtype]
            unpack = halo_exchange.UNPACK_ENTRY_POINTS[dtype]
            xu, incn = x.clone(), inc[:n]
            rec64 = plan.recv.long()

            def run_pack(v, y, plan=plan, x=x, pack=pack, n=n):
                v.call(pack, x.data_ptr(), y.data_ptr(),
                       plan.send.data_ptr(), n, 1, 1, 0, 1)

            def run_unpack(v, y, plan=plan, incn=incn, unpack=unpack, n=n):
                v.call(unpack, y.data_ptr(), incn.data_ptr(),
                       plan.recv.data_ptr(), n, 1, 1, 0, 1)

            name = (f"{n:,} rows" if plan is tr else "one row (launch "
                    "floor)") + f" {str(dtype).replace('torch.', '')}"
            rows += paired(
                f"halo pack {name}", versions, run_pack,
                halo_exchange.halo_pack_plain(plan, x, buf.clone()),
                plan.bound_bytes(x.element_size()), reps, rounds,
                lambda x=x, plan=plan, buf=buf: torch.index_select(
                    x.view(-1), 0, plan.send, out=buf), **graph)
            rows += paired(
                f"halo unpack {name}", versions, run_unpack,
                halo_exchange.halo_unpack_plain(plan, incn, x.clone()),
                plan.bound_bytes(x.element_size(), pack=False), reps, rounds,
                lambda xu=xu, rec64=rec64, incn=incn: xu.view(-1).index_copy_(
                    0, rec64, incn), y0=x, **graph)

    # the sharded op.spmv by replayed graph, and the graph solve
    for R in (4, 8):
        for overlap in (False, True):
            if (R, overlap) not in ops:
                ops[(R, overlap)] = DistributedSpmvOperator.from_mtx(
                    Config(**base, n_shards=R, overlap_comm=overlap), mtx,
                    devices=[device])
            op = ops[(R, overlap)]
            x = op.make_x(x_host)
            want, yl = torch.zeros_like(x), torch.zeros_like(x)
            with halo_library(None):
                op.spmv(x, out=want)

            def run_spmv(v, y, op=op, x=x):
                with halo_library(v):
                    op.spmv(x, out=y)

            def lib_spmv(op=op, x=x, yl=yl):
                with halo_library(None):
                    op.spmv(x, out=yl)

            rows += paired(
                f"sharded op.spmv R={R} overlap "
                f"{'on' if overlap else 'off'}", versions, run_spmv, want,
                op.bytes_per_spmv(), reps, rounds, lib_spmv,
                y0=torch.zeros_like(x), **graph)
    caches = {}
    x = op4.make_x(x_host)

    def solve(v):
        key = HALO_LIBRARY if v is None else v.name
        with halo_library(v):
            op4._solve_graphs = caches.setdefault(key, {})
            return op4.solve(x, HALO_SOLVE_K, "graph")[1]

    def solve_timer(fn):  # each call replays a graph of k SpMVs
        return events_ms(fn, max(reps // 10, 1)) / HALO_SOLVE_K

    out = paired(f"sharded graph solve R=4 per iteration k={HALO_SOLVE_K}",
                 versions, lambda v, y: y.copy_(solve(v)), solve(None),
                 op4.bytes_per_spmv(), reps, rounds,
                 lambda: solve(None), timer=solve_timer,
                 library_name=HALO_LIBRARY, library_timer=solve_timer,
                 tol=0.0)
    del ops, op4, caches
    torch.cuda.empty_cache()
    return rows + out


def run(args: argparse.Namespace) -> List[dict]:
    """Build every --lib, time the cases; returns the rows, also appended
    to --out. Needs a GPU: the kernels have no CPU form to compare."""
    libs = parse_libs(args.lib)
    cases = [c for c in args.cases.split(",") if c]
    unknown = set(cases) - set(CASES)
    if unknown:
        raise ValueError(f"--cases: unknown {sorted(unknown)}; of {CASES}")
    device = _common.device_for("cuda")
    versions = build_all(libs)
    rows = resources(versions)
    for r in rows:
        print(f"{r['lib']:10s} REG {r['registers']:3d} LOCAL {r['local']:4d} "
              f"STACK {r['stack']:4d} SASS {r['sass_instructions']} "
              f"{r['function']}")
    card_line = card.card_name_and_power_limit()
    print(card_line)
    for case in cases:
        fn = {"sell": sell_cases, "padded": padded_cases,
              "packed": packed_cases,
              "solve": solve_cases, "pieces": pieces_cases,
              "gather": gather_cases, "halo": halo_cases}[case]
        rows += fn(versions, device, args.reps, args.rounds)
    for r in rows:
        r.update(platform=_common.platform_of(device), card=card_line)
    path = _common.write_rows(args.out or _common.default_out(NAME), rows)
    print(f"\n{len(rows)} rows appended to {path}")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
