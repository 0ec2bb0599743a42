"""Two or more versions of the SELL-C-sigma and packed-row kernels, timed in
turns on the same inputs in one process on one card: the paired comparison
of a kernel change (the parent's sources against the change's).

    python -m uspmv_tpu_torch.scripts.kernel_ab --lib NAME=CSRC_DIR
        [--lib NAME=CSRC_DIR ...] [--cases sell,packed,solve] [--reps R]
        [--rounds N] [--out PATH]

Each CSRC_DIR is a copy of ``uspmv_tpu_torch/csrc`` (the parent commit's,
unpacked by ``git archive``, or an edited copy). Every one is built with the
flags of ``ops/_build.py`` into a library of its own, all builds at once,
and cuobjdump's registers per kernel are printed for each. The cases:

    sell    Laplace3D-128 at C=1024, sigma=1 (the headline) with every
            (values, x) pair of scs_spmv.cu, its all-ones pattern as a
            unit stream, and sp with rowwise bs 4 and 8 and colwise bs 8;
            Laplace3D-160, sp
    packed  RandomImbalanced-500k at C=1024, sigma=1, split at the
            operator's automatic threshold: its packed rows as dp, sp, hp
    solve   the fused solve (scs_solve.cu), k=32, on the headline's matrix
            scaled by 1/16 (row sums of |A| <= 1), sp

On a case every library's kernel runs on the same tensors, in the order
first..last then last..first, --rounds times; each turn is one replay of a
CUDA graph of R launches (the solve: R launches timed by CUDA events).
cuSPARSE (``torch.sparse_csr_tensor @ x``) on the same matrix, where the
value and x types agree, takes its turns among them. One row per (case,
library) gives the median ms, the samples, the byte bound, whether y
equals the first library's bit for bit, and the error against the plain
version. A tree whose packed kernel predates the group records takes the
packed arguments of that design: group_ptr, no stage size.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..io import generators
from ..ops import _build, scs_packed, scs_solve, scs_spmv
from ..ops.device_format import build_device_scs
from ..runtime.operator import SpmvOperator
from . import _common

NAME = "kernel_ab"
CASES = ("sell", "packed", "solve")
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
SOLVE_K = 32
# the packed entry points before the group records: no stage size
_PACKED_ARGTYPES_GROUP_PTR = (scs_packed._ARGTYPES[:-2]
                              + scs_packed._ARGTYPES[-1:])


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


def packed_abi(csrc: Path) -> str:
    """'records' where the tree's packed kernel reads group records and a
    stage size, else 'group_ptr' (the design before the records)."""
    text = (csrc / "scs_packed.cu").read_text()
    return "records" if "stage_bytes" in text else "group_ptr"


class Version:
    """One tree's library with its argument types bound."""

    def __init__(self, name: str, csrc: Path, lib_path: Path):
        self.name, self.path = name, lib_path
        self.lib = ctypes.CDLL(str(lib_path))
        self.abi = packed_abi(csrc)
        for entry in [*scs_spmv._ENTRY_POINTS.values(), scs_spmv.UNIT_ENTRY]:
            self._bind(entry, scs_spmv._ARGTYPES)
        for entry in scs_packed._ENTRY_POINTS.values():
            self._bind(entry, scs_packed._ARGTYPES if self.abi == "records"
                       else _PACKED_ARGTYPES_GROUP_PTR)
        for entry in scs_solve._ENTRY_POINTS.values():
            self._bind(entry, scs_solve._ARGTYPES)
        self.lib.uspmv_cuda_error_string.argtypes = [ctypes.c_int]
        self.lib.uspmv_cuda_error_string.restype = ctypes.c_char_p

    def _bind(self, entry: str, argtypes) -> None:
        fn = getattr(self.lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int

    def call(self, entry: str, *args) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        scs_spmv.raise_for(self.lib, getattr(self.lib, entry)(*args, stream),
                           f"{self.name} {entry}")


def build_all(libs: Dict[str, Path]) -> Dict[str, Version]:
    """Every tree into build/uspmv_tpu_torch/kernel_ab/<name>/, at once."""
    procs = {}
    t0 = time.perf_counter()
    for name, csrc in libs.items():
        sources = sorted(csrc.glob("*.cu"))
        if not sources:
            raise _build.KernelBuildError(f"no CUDA sources under {csrc}")
        out = _build.BUILD_DIR / NAME / name / "lib.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        procs[name] = (out, subprocess.Popen(
            _build.nvcc_command(sources, out), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    versions = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise _build.KernelBuildError(f"{name}: nvcc failed\n{log}")
        versions[name] = Version(name, libs[name], out)
    print(f"built {len(procs)} libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    return versions


def resources(versions: Dict[str, Version]) -> List[dict]:
    """Registers of the row-sum kernels of every version."""
    rows = []
    for v in versions.values():
        for r in _build.kernel_resources(v.path):
            if any(k in r["function"] for k in (
                    "scs_spmv_kernel", "scs_ones_kernel", "scs_packed_kernel",
                    "scs_solve_kernel", "scs_probe_kernel")):
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
           timer=None) -> List[dict]:
    """One case: ``run(version, y)`` writes y = the product; each version
    is checked against ``plain_y`` and the first version's y, then timed in
    turns with ``library`` (a call, or None)."""
    device = plain_y.device
    tol = TOL[plain_y.dtype]
    ys, rows = {}, {}
    for name, v in versions.items():
        y = torch.empty_like(plain_y)
        run(v, y)
        torch.cuda.synchronize()
        ys[name] = y
        first = next(iter(ys.values()))
        rows[name] = dict(
            kind="case", case=case, lib=name, bit_equal_to_first=bool(
                torch.equal(y, first)),
            bound_bytes=nbytes, bound_ms=_common.bound_ms(nbytes),
            **_common.check_close(y, plain_y, tol, f"{case} {name}"))
    timer = timer or (lambda fn: _common.device_ms(fn, reps, device))
    names = list(versions) + (["cusparse"] if library else [])
    samples = {n: [] for n in names}
    for n in turns(names, rounds):
        if n == "cusparse":  # allocates its result: events, not a graph
            samples[n].append(events_ms(library, reps))
        else:
            y = ys[n]
            samples[n].append(timer(lambda v=versions[n], y=y: run(v, y)))
    if library:
        rows["cusparse"] = dict(kind="case", case=case, lib="cusparse",
                                bound_bytes=nbytes,
                                bound_ms=_common.bound_ms(nbytes))
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
                     (f32, "colwise", 8)]
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
            # x_ld, x_vstride, y_ld, y_vstride, ncols, n_vec of the wrapper
            strides = ((1, 0, 1, 0, 1, 1) if bs == 1 else
                       (bs, 0, bs, 0, bs, 1) if layout == "rowwise" else
                       (1, n, 1, n, 1, bs))

            def run(v, y, dev=dev, x=x, entry=entry, strides=strides):
                x_ld, x_vs, y_ld, y_vs, ncols, n_vec = strides
                v.call(entry, dev.n_rows_padded, dev.C,
                       dev.chunk_ptrs.data_ptr(), dev.chunk_lengths.data_ptr(),
                       dev.col_idxs.data_ptr(), dev.values.data_ptr(),
                       x.data_ptr(), x_ld, x_vs, y.data_ptr(), y_ld, y_vs,
                       ncols, n_vec, 0)

            library = None
            if vdt == xdt and bs == 1:
                keep = dev.values != 0
                library = csr_call(dev.row_idxs[keep], dev.col_idxs[keep],
                                   dev.values[keep], n, x)
            passes = bs if layout == "colwise" else 1
            case = f"{spec} {entry.replace('uspmv_scs_spmv_', '')}" + (
                f" {layout} bs={bs}" if bs > 1 else "")
            rows += paired(case, versions, run,
                           scs_spmv.spmv_scs_plain(dev, x, layout),
                           passes * dev.stream_bytes() + 2 * x.numel() * esize,
                           reps, rounds, library)
            del dev
        del op, mtx
        torch.cuda.empty_cache()
    return rows


def packed_cases(versions, device, reps, rounds) -> List[dict]:
    rows = []
    mtx = generators.random_imbalanced(500_000, 8)
    for value_type in ("dp", "sp", "hp"):
        op = SpmvOperator.from_mtx(
            Config(kernel_format="scs", chunk_size=1024, sigma=1,
                   value_type=value_type, backend="cuda"), mtx)
        (dev,) = op.devs.values()
        if not op.is_packed():
            raise RuntimeError(f"packed case: {op.impl_name()} is not packed")
        xdt = torch.float64 if value_type == "dp" else torch.float32
        x = torch.as_tensor(np.random.default_rng(1).standard_normal(
            dev.n_rows_padded), device=device).to(xdt)
        entry = scs_packed.entry_point(dev.values.dtype, xdt)
        n = dev.n_rows_padded

        # the first row of every group and the end: the older group_ptr
        group_ptr = torch.cat([dev.groups[:, 0], dev.groups[-1:, 1]])

        def run(v, y, dev=dev, x=x, entry=entry, group_ptr=group_ptr):
            head = (dev.n_groups, dev.groups.data_ptr()
                    if v.abi == "records" else group_ptr.data_ptr(),
                    dev.row_ptr.data_ptr(), dev.col_idxs.data_ptr(),
                    dev.values.data_ptr(), x.data_ptr(), 1, 0, y.data_ptr(),
                    1, 0, 1, 1, 0)
            if v.abi == "records":
                head += (scs_packed.stage_bytes(dev, x.dtype),)
            v.call(entry, *head)

        library = None
        if dev.values.dtype == xdt:
            library = csr_call(dev.row_idxs, dev.col_idxs, dev.values, n, x)
        rows += paired(f"RandomImbalanced-500k packed {value_type}", versions,
                       run, scs_packed.spmv_packed_plain(dev, x),
                       dev.stream_bytes() + 2 * n * x.element_size(), reps,
                       rounds, library)
        del op, dev
        torch.cuda.empty_cache()
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
    x0 = torch.as_tensor(np.random.default_rng(2).standard_normal(n),
                         device=device, dtype=torch.float32)
    buf = torch.empty(2, n, dtype=torch.float32, device=device)
    entry = scs_solve.entry_point(torch.float32, torch.float32)

    def run(v, y):
        v.call(entry, n, dev.C, dev.chunk_ptrs.data_ptr(),
               dev.chunk_lengths.data_ptr(), dev.col_idxs.data_ptr(),
               dev.values.data_ptr(), x0.data_ptr(), buf[0].data_ptr(),
               buf[1].data_ptr(), 1, 1, SOLVE_K)
        y.copy_(buf[(SOLVE_K - 1) & 1])

    def timer(fn):  # a cooperative launch of ~2 ms: events, few calls
        return events_ms(fn, max(reps // 20, 1))

    _, want = scs_solve.solve_scs_plain(dev, x0, SOLVE_K)
    nbytes = SOLVE_K * dev.stream_bytes() + 3 * n * 4
    return paired(f"Laplace3D-128 fused solve sp k={SOLVE_K}", versions,
                  run, want, nbytes, reps, rounds, None, timer)


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
              f"{r['function']}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    for case in cases:
        fn = {"sell": sell_cases, "packed": packed_cases,
              "solve": solve_cases}[case]
        rows += fn(versions, device, args.reps, args.rounds)
    for r in rows:
        r.update(platform=_common.platform_of(device), card=card)
    path = _common.write_rows(args.out or _common.default_out(NAME), rows)
    print(f"\n{len(rows)} rows appended to {path}")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
