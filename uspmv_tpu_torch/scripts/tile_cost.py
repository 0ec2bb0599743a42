"""Where the SELL-C-sigma kernel's time goes: its row loop with one part of
the work replaced at a time, and the unit-value stream beside it.

Port of the JAX package's TPU probe scripts/pallas_tile_cost.py, through
the variants of ``ops/scs_probe.py`` (csrc/scs_probe.cu): it builds the
operator of a matrix (default ``Laplace3D,64``, as the script; a bare
number n means ``Laplace3D,n``) at C=1024, sigma=1, sp, and prints each
variant's time, ns per stored element and GFLOP/s (2 nnz / t), with its
byte bound and its error against the plain version:

    full      spmv_scs's own kernel, through the probe's entry
    x_window  x[col & (W-1)], x in L1        (the script's fixed_w)
    no_store  y stored only above a run-time
              threshold                       (fixed_cl)
    no_x      float(col) in place of x[col]   (no_gather)
    bare      no_x and no_store               (bare)
    x_row     x[r], coalesced, in place of the gather (behind the column
              load, as the gather is)
    spmv      spmv_scs itself, the production launch
    unit      the unit-value stream (no values, 4 B per element) on the
              all-ones pattern of the same matrix, beside spmv_scs on that
              pattern with explicit ones ("ones")

    python -m uspmv_tpu_torch.scripts.tile_cost [matrix | n]
        [--backend cuda|cpu] [--reps R] [--out PATH]

Each variant is first held against its plain version with every row
stored (no_store and bare with the threshold -inf); no_store and bare are
then timed with the threshold +inf, which stores no row. On a GPU each time
is one replay of a CUDA graph of R launches over R; with --backend cpu the
plain versions run and the rows say "cpu".
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..cli import load_matrix
from ..config import Config
from ..ops import scs_probe
from ..ops.device_format import DeviceScs, build_device_scs
from ..ops.scs_spmv import spmv_scs, spmv_scs_plain
from ..runtime.operator import SpmvOperator
from . import _common

NAME = "tile_cost"
TOL = 1e-5  # f32 sums in another order than the plain version's


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"uspmv_tpu_torch.scripts.{NAME}",
                                description=__doc__.split("\n")[0])
    p.add_argument("matrix", nargs="?", default="Laplace3D,64",
                   help=".mtx file, generator spec, or n for Laplace3D,n")
    _common.add_common_args(p, NAME)
    p.add_argument("--reps", type=int, default=100)
    return p


class CostSplit(NamedTuple):
    """What ``measure`` built and measured, for a caller that times more on
    the same inputs."""
    rows: List[dict]
    op: SpmvOperator  # the sp operator of the matrix
    x: torch.Tensor  # the vector every row was measured with
    y: torch.Tensor  # spmv_scs(op.devs["sp"], x)
    unit: DeviceScs  # the matrix's all-ones pattern without values
    y_unit: torch.Tensor  # spmv_scs(unit, x)


def measure(mtx, spec: str, device: torch.device, reps: int) -> CostSplit:
    """Every variant and the unit stream on ``mtx``."""
    platform = _common.platform_of(device)
    cfg = Config(kernel_format="scs", chunk_size=1024, sigma=1,
                 value_type="sp", backend=device.type,
                 split_rows_threshold=-1, mixed_tiles=False)
    op = SpmvOperator.from_mtx(cfg, mtx)
    dev = op.devs["sp"]
    x = op.make_x(np.random.default_rng(0).standard_normal(op.n_rows))
    n_pad = dev.n_rows_padded
    vec = 4 * n_pad  # one f32 vector, read or written once
    win = 4 * scs_probe.x_window(x.numel())
    # full and spmv read the slots below each group's length; the other
    # variants walk each chunk to its length
    stream, chunks = dev.stream_bytes(), dev.chunk_stream_bytes()
    bytes_of = {"full": stream + 2 * vec, "x_window": chunks + win + vec,
                "no_store": chunks + vec, "no_x": chunks + vec,
                "bare": chunks, "x_row": chunks + 2 * vec,
                "spmv": stream + 2 * vec}
    print(f"matrix {spec}: rows={op.n_rows} nnz={op.nnz} "
          f"elements={dev.n_elements} C=1024 sigma=1 [{platform}]")
    y_spmv = spmv_scs(dev, x)
    y_buf = torch.zeros(n_pad, dtype=torch.float32, device=device)
    count = torch.zeros(1, dtype=torch.int32, device=device)
    rows = []

    def check(got, want, what):
        return _common.check_close(got, want, TOL, f"tile_cost {what}")

    def record(name, fn, plain, nbytes, err, **extra):
        ms = _common.device_ms(fn, reps, device)
        us = ms * 1e3
        row = dict(matrix=spec, variant=name, us=us,
                   ns_per_element=ms * 1e6 / dev.n_elements,
                   gflops=2 * op.nnz / ms / 1e6, bound_bytes=nbytes,
                   bound_ms=_common.bound_ms(nbytes, device),
                   bound_by="bytes",
                   plain_ms=_common.device_ms(plain, max(reps // 10, 1),
                                              device),
                   n_rows=op.n_rows, nnz=op.nnz, n_elements=dev.n_elements,
                   reps=reps, platform=platform, **err, **extra)
        print(f"{name:11s}: {us:8.2f} us  {row['ns_per_element']:7.4f} "
              f"ns/element  {row['gflops']:7.1f} GFLOP/s  bound "
              f"{row['bound_ms'] * 1e3:7.2f} us")
        rows.append(row)

    for variant in scs_probe.VARIANTS:
        # every row stored: the sums against the plain version's
        y, stored = scs_probe.probe_scs(dev, x, variant, y_buf.zero_(),
                                        count.zero_())
        y_plain, stored_plain = scs_probe.probe_plain(dev, x, variant)
        err = check(y, y_plain, variant)
        if stored.item() != stored_plain.item():
            raise RuntimeError(f"tile_cost {variant}: {stored.item()} rows "
                               "stored, the plain version "
                               f"{stored_plain.item()}")
        extra = {}
        thr = -math.inf
        if variant == "full":
            extra["bit_equal_to_spmv"] = bool(torch.equal(y, y_spmv))
            if not extra["bit_equal_to_spmv"]:
                raise RuntimeError("tile_cost: full differs from spmv_scs")
        if variant in scs_probe.THRESHOLDED:
            # timed storing no row: y keeps its values, no row is counted
            thr = math.inf
            y_buf.fill_(7.0)
            y, stored = scs_probe.probe_scs(dev, x, variant, y_buf,
                                            count.zero_(), thr)
            if stored.item() != 0 or not bool((y == 7.0).all().item()):
                raise RuntimeError(f"tile_cost {variant}: rows stored above "
                                   "the threshold +inf")
            extra["rows_stored_when_timed"] = 0
        record(variant,
               lambda v=variant, t=thr: scs_probe.probe_scs(
                   dev, x, v, y_buf, count, t),
               lambda v=variant, t=thr: scs_probe.probe_plain(
                   dev, x, v, store_above=t),
               bytes_of[variant], err, **extra)
    out = torch.empty_like(x)
    record("spmv", lambda: spmv_scs(dev, x, out=out),
           lambda: spmv_scs_plain(dev, x), bytes_of["spmv"],
           check(y_spmv, spmv_scs_plain(dev, x), "spmv"))

    # the all-ones pattern: without a value stream, and with explicit ones
    host = op.scs["sp"]
    ones = dataclasses.replace(host, values=(host.values != 0).astype(
        np.float32))
    unit = build_device_scs(ones, device, unit_values=True)
    explicit = build_device_scs(ones, device)
    y_unit = spmv_scs(unit, x)
    y_ones = spmv_scs(explicit, x)
    vs_ones = check(y_unit, y_ones, "unit vs explicit ones")
    record("unit", lambda: spmv_scs(unit, x, out=out),
           lambda: spmv_scs_plain(unit, x), unit.stream_bytes() + 2 * vec,
           check(y_unit, spmv_scs_plain(unit, x), "unit"),
           rel_err_vs_ones=vs_ones["rel_err"],
           bit_equal_to_ones=bool(torch.equal(y_unit, y_ones)))
    record("ones", lambda: spmv_scs(explicit, x, out=out),
           lambda: spmv_scs_plain(explicit, x),
           explicit.stream_bytes() + 2 * vec,
           check(y_ones, spmv_scs_plain(explicit, x), "ones"))
    return CostSplit(rows, op, x, y_spmv, unit, y_unit)


def run(args: argparse.Namespace, mtx=None) -> List[dict]:
    """The probe on ``args.matrix`` (or the matrix given, under that name);
    returns its rows, also appended to --out."""
    device = _common.device_for(args.backend)
    spec = args.matrix
    if spec.isdigit():
        spec = f"Laplace3D,{spec}"
    if mtx is None:
        mtx = load_matrix(spec)
    rows = measure(mtx, spec, device, args.reps).rows
    path = _common.write_rows(args.out or _common.default_out(NAME), rows)
    print(f"\n{len(rows)} rows appended to {path}")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
