"""x-gather probes on the card: which gathers are right, how fast they run,
and what a scattered x load costs by pattern and x size.

Port of the JAX package's TPU probes scripts/test_gather1d.py,
scripts/test_gather2d.py and scripts/test_gather_tput.py, through the
kernels of ``ops/x_access.py`` (csrc/x_access.cu):

  1. the shape table: every (src, idx, dim) of test_gather1d.py and every
     (H, W, h, w) of test_gather2d.py as a flat gather ``gather_store``,
     checked against the scripts' own numpy formulas (``correct=``);
  2. the throughput runs: test_gather1d.py's ``bench_gather`` cases (the
     gather alone; the TPU kernel also scaled its output by 2) and
     test_gather_tput.py's "copy" and "gather" modes (``copy_fma``,
     ``gather_fma`` over (512, 128) blocks), as ms, Gelem/s and GB/s;
  3. the sweep: ``gather_store`` and ``gather_fma`` over E elements with the
     index patterns random, banded (idx = e * n_x / E + k, |k| <= 3: about
     e/7 + k at the Laplacian's seven per row) and strided (consecutive
     elements 1,024 apart, all of x visited), against x sizes of 2, 8.4,
     16.4 and 67 MB; beside each its byte bound and the time of one PyTorch
     call for the same gather, microbench's ``take_1d`` (``library_ms``;
     ``take_mul`` beside gather_fma).

    python -m uspmv_tpu_torch.scripts.gather_probe [--backend cuda|cpu]
        [--elements E] [--x_elems N ...] [--tput_blocks B] [--reps R]
        [--out PATH]

Every result is checked against the plain version on the same device. With
--backend cpu the plain versions run and the rows say "cpu".
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

from ..ops import x_access
from . import _common
from .microbench import take_1d, take_mul

NAME = "gather_probe"
# test_gather1d.py:121-130: (src shape, idx shape, dim)
SHAPES_1D = [
    ((8, 128), (8, 128), 0),
    ((8, 128), (8, 128), 1),
    ((64, 128), (8, 128), 0),
    ((2048, 128), (8, 128), 0),
    ((2048, 128), (64, 128), 0),
    ((8, 1024), (8, 128), 1),
    ((8, 32768), (8, 128), 1),
    ((16, 128), (16, 128), 0),
    ((32, 128), (8, 128), 0),
]
# test_gather2d.py:72-75: (H, W, h, w)
SHAPES_2D = [(8, 128, 8, 128), (64, 128, 8, 128), (2048, 128, 8, 128),
             (2048, 128, 64, 512)]
# test_gather1d.py:132-136: (src shape, idx shape, dim, n_tiles)
BENCH_1D = [
    ((8, 128), (8, 128), 1, 512),
    ((8, 128), (8, 128), 0, 512),
    ((2048, 128), (8, 128), 0, 512),
    ((2048, 128), (64, 128), 0, 64),
    ((8, 32768), (8, 128), 1, 512),
]
ROWS_PER_BLOCK = 512  # test_gather_tput.py: (512, 128) blocks
PATTERNS = ("random", "banded", "strided")
# x sizes in elements: 2.1 MB, Laplace3D-128's 8.4 MB, Laplace3D-160's
# 16.4 MB, and 67 MB, the one size beyond the 50 MB L2
X_ELEMS = (2**19, 2**21, 4_096_000, 2**24)
STRIDE = 1024
SECTOR = 32  # bytes of device memory behind one scattered 4 B load


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"uspmv_tpu_torch.scripts.{NAME}",
                                description=__doc__.split("\n")[0])
    _common.add_common_args(p, NAME)
    p.add_argument("--elements", type=int, default=2**24,
                   help="gathered elements E of each sweep point")
    p.add_argument("--x_elems", type=int, nargs="+", default=list(X_ELEMS),
                   help="x sizes of the sweep, in float32 elements")
    p.add_argument("--tput_blocks", type=int, default=256,
                   help="(512, 128) blocks of the copy/gather throughput run")
    p.add_argument("--reps", type=int, default=20)
    return p


def sweep_index(pattern: str, n: int, n_x: int,
                gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """int32 indices e -> x of one sweep pattern, n elements, x of n_x."""
    e = torch.arange(n, device=device, dtype=torch.int64)
    if pattern == "random":
        idx = torch.randint(0, n_x, (n,), generator=gen, device=device)
    elif pattern == "banded":
        k = torch.randint(-3, 4, (n,), generator=gen, device=device)
        idx = (e * n_x // n + k).clamp(0, n_x - 1)
    elif pattern == "strided":
        rows = n_x // STRIDE  # x viewed as [rows, STRIDE], read by column
        if rows < 1:
            raise ValueError(f"the strided pattern needs x of >= {STRIDE} "
                             f"elements, not {n_x}")
        e = e % (rows * STRIDE)
        idx = (e % rows) * STRIDE + e // rows
    else:
        raise ValueError(f"pattern must be one of {PATTERNS}, not {pattern!r}")
    return idx.to(torch.int32)


def shape_table(device: torch.device) -> List[dict]:
    rows = []
    for src_shape, idx_shape, dim in SHAPES_1D:
        rng = np.random.default_rng(0)  # as test_shape draws them
        src = rng.standard_normal(src_shape).astype(np.float32)
        hi = src_shape[dim]
        idx = rng.integers(0, hi, idx_shape).astype(np.int32)
        flat = x_access.flat_index(torch.from_numpy(idx).to(device),
                                   src_shape, dim)
        got = x_access.gather_store(torch.from_numpy(src.ravel()).to(device),
                                    flat).view(idx_shape).cpu().numpy()
        if src.shape[1 - dim] == idx.shape[1 - dim]:
            want = np.take_along_axis(src, idx % hi, axis=dim)
        elif dim == 0:
            want = src[idx % hi, np.arange(idx_shape[1])[None, :]
                       % src_shape[1]]
        else:
            want = src[np.arange(idx_shape[0])[:, None] % src_shape[0],
                       idx % hi]
        ok = bool(np.allclose(got, want))
        print(f"dim={dim} src{src_shape} idx{idx_shape}: correct={ok}")
        rows.append(dict(probe="gather1d", dim=dim, src_shape=list(src_shape),
                         idx_shape=list(idx_shape), correct=ok))
    for H, W, h, w in SHAPES_2D:
        rng = np.random.default_rng(0)  # as gather2d's run draws them
        src = rng.standard_normal((H, W)).astype(np.float32)
        idx = rng.integers(0, H * W, (h, w)).astype(np.int32)
        flat = x_access.flat_index(torch.from_numpy(idx).to(device), (H, W),
                                   None)
        got = x_access.gather_store(torch.from_numpy(src.ravel()).to(device),
                                    flat).view(h, w).cpu().numpy()
        want = src.reshape(-1)[idx.reshape(-1) % (H * W)].reshape(h, w)
        ok = bool(np.allclose(got, want))
        print(f"H={H} W={W} h={h} w={w}: correct={ok}")
        rows.append(dict(probe="gather2d", H=H, W=W, h=h, w=w, correct=ok))
    return rows


def throughput(device: torch.device, tput_blocks: int, reps: int,
               platform: str) -> List[dict]:
    rows = []
    for src_shape, idx_shape, dim, n_tiles in BENCH_1D:
        rng = np.random.default_rng(0)
        src = torch.from_numpy(
            rng.standard_normal(src_shape).astype(np.float32).ravel()
        ).to(device)
        # the n_tiles index tiles stacked row-wise; every tile gathers from
        # the one src (for dim 1 the src height equals the tile height, so
        # flat_index's row i mod H is the row within the tile)
        idx = rng.integers(0, src_shape[dim],
                           (n_tiles * idx_shape[0], idx_shape[1])
                           ).astype(np.int32)
        flat = x_access.flat_index(torch.from_numpy(idx).to(device),
                                   src_shape, dim).view(-1)
        out = torch.empty(flat.numel(), dtype=torch.float32, device=device)
        err = _common.check_close(x_access.gather_store(src, flat, out),
                                  x_access.gather_store_plain(src, flat), 0.0,
                                  f"{NAME} bench_gather")
        ms = _common.device_ms(lambda: x_access.gather_store(src, flat, out),
                               reps, device)
        E = flat.numel()
        print(f"bench dim={dim} src{src_shape} idx{idx_shape} x{n_tiles}: "
              f"{ms:.3f} ms  {E / ms / 1e6:.2f} Gelem/s  "
              f"{E * 8 / ms / 1e6:.1f} GB/s(equiv)")
        rows.append(dict(probe="bench_gather", dim=dim,
                         src_shape=list(src_shape), idx_shape=list(idx_shape),
                         n_tiles=n_tiles, ms=ms, gelem_s=E / ms / 1e6,
                         gbps_equiv=E * 8 / ms / 1e6, platform=platform,
                         **err))
    # test_gather_tput.py: (N, 128) vals, in-row lane indices and x
    N = tput_blocks * ROWS_PER_BLOCK
    E = N * 128
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(
        rng.standard_normal((N, 128)).astype(np.float32).ravel()).to(device)
    lane = torch.from_numpy(
        rng.integers(0, 128, (N, 128)).astype(np.int32)).to(device)
    x = torch.from_numpy(
        rng.standard_normal((N, 128)).astype(np.float32).ravel()).to(device)
    flat = x_access.flat_index(lane, (N, 128), 1).view(-1)
    T = x_access.fma_threads(E)
    part = torch.empty(T, dtype=torch.float32, device=device)
    for mode in ("copy", "gather"):
        if mode == "copy":
            def run():
                return x_access.copy_fma(x, vals, part)
            want = x_access.copy_fma_plain(x, vals)
        else:
            def run():
                return x_access.gather_fma(x, flat, vals, part)
            want = x_access.gather_fma_plain(x, flat, vals)
        err = _common.check_close(run(), want, x_access.fma_tol(E),
                                  f"{NAME} {mode}")
        ms = _common.device_ms(run, reps, device)
        moved = E * (4 + (4 if mode == "gather" else 0) + 4)  # vals+idx+x
        print(f"{mode:7s}: {ms:8.3f} ms  {E / ms / 1e6:6.2f} Gelem/s  "
              f"{moved / ms / 1e6:6.1f} GB/s HBM")
        rows.append(dict(probe="gather_tput", mode=mode, n_blocks=tput_blocks,
                         elements=E, ms=ms, gelem_s=E / ms / 1e6,
                         gbps=moved / ms / 1e6, bound_ms=_common.bound_ms(
                             moved + 4 * T), tol=x_access.fma_tol(E),
                         platform=platform, **err))
    return rows


def sweep(device: torch.device, n: int, x_sizes, reps: int,
          platform: str) -> List[dict]:
    rows = []
    gen = torch.Generator(device=device).manual_seed(0)
    v = torch.randn(n, generator=gen, device=device)
    out = torch.empty(n, dtype=torch.float32, device=device)
    T = x_access.fma_threads(n)
    part = torch.empty(T, dtype=torch.float32, device=device)
    tol = x_access.fma_tol(n)
    for n_x in x_sizes:
        x = torch.randn(n_x, generator=gen, device=device)
        for pattern in PATTERNS:
            idx = sweep_index(pattern, n, n_x, gen, device)
            x_read = 4 * torch.unique(idx).numel()  # x entries this run needs
            for mode in ("gather_store", "gather_fma"):
                if mode == "gather_store":
                    def run():
                        return x_access.gather_store(x, idx, out)
                    want = x_access.gather_store_plain(x, idx)
                    streams = 8 * n  # idx read, out written
                    err = _common.check_close(run(), want, 0.0,
                                              f"{NAME} {mode}")
                    lib_ms = _common.device_ms(lambda: take_1d(x, idx), reps,
                                               device)
                    lib_call, mode_tol = "microbench take_1d: " \
                        "torch.index_select(x, 0, idx)", 0.0
                else:
                    def run():
                        return x_access.gather_fma(x, idx, v, part)
                    want = x_access.gather_fma_plain(x, idx, v)
                    streams = 8 * n + 4 * T  # idx and v read, partials out
                    err = _common.check_close(run(), want, tol,
                                              f"{NAME} {mode}")
                    lib_ms, lib_call, mode_tol = None, None, tol
                ms = _common.device_ms(run, reps, device)
                plain_ms = _common.device_ms(
                    (lambda: x_access.gather_store_plain(x, idx))
                    if mode == "gather_store"
                    else (lambda: x_access.gather_fma_plain(x, idx, v)),
                    max(reps // 4, 1), device)
                nbytes = streams + x_read
                # a random load from an x beyond L2 brings a whole sector
                miss = (pattern == "random" and 4 * n_x > _common.L2_BYTES)
                row = dict(
                    probe="sweep", mode=mode, pattern=pattern, x_elems=n_x,
                    x_mb=4 * n_x / 1e6, elements=n, n_threads=T, ms=ms,
                    gelem_s=n / ms / 1e6, gbps=nbytes / ms / 1e6,
                    bound_bytes=nbytes, bound_ms=_common.bound_ms(nbytes),
                    bound_by="bytes",
                    sector_floor_ms=(_common.bound_ms(streams + SECTOR * n)
                                     if miss else None),
                    plain_ms=plain_ms, library_ms=lib_ms,
                    library_call=lib_call,
                    library_error=(None if lib_call else
                                   "no one PyTorch call computes the "
                                   "per-thread partial sums"),
                    tol=mode_tol, platform=platform, **err)
                if mode == "gather_fma":
                    row["take_mul_ms"] = _common.device_ms(
                        lambda: take_mul(v, x, idx), reps, device)
                print(f"{mode:12s} {pattern:8s} x {4 * n_x / 1e6:6.1f} MB: "
                      f"{ms:8.4f} ms  {n / ms / 1e6:7.2f} Gelem/s  "
                      f"{nbytes / ms / 1e6:7.1f} GB/s  bound "
                      f"{row['bound_ms']:.4f} ms  library "
                      f"{lib_ms if lib_ms is None else round(lib_ms, 4)}")
                rows.append(row)
    # the coalesced reference: x read in place, no index stream
    x = torch.randn(n, generator=gen, device=device)

    def run():
        return x_access.copy_fma(x, v, part)
    err = _common.check_close(run(), x_access.copy_fma_plain(x, v), tol,
                              f"{NAME} copy_fma")
    ms = _common.device_ms(run, reps, device)
    plain_ms = _common.device_ms(lambda: x_access.copy_fma_plain(x, v),
                                 max(reps // 4, 1), device)
    nbytes = 8 * n + 4 * T
    print(f"copy_fma     in place   x {4 * n / 1e6:6.1f} MB: {ms:8.4f} ms  "
          f"{nbytes / ms / 1e6:7.1f} GB/s")
    rows.append(dict(probe="sweep", mode="copy_fma", pattern="in_place",
                     x_elems=n, x_mb=4 * n / 1e6, elements=n, n_threads=T,
                     ms=ms, gelem_s=n / ms / 1e6, gbps=nbytes / ms / 1e6,
                     bound_bytes=nbytes, bound_ms=_common.bound_ms(nbytes),
                     bound_by="bytes", sector_floor_ms=None,
                     plain_ms=plain_ms, library_ms=None, library_call=None,
                     library_error="no one PyTorch call computes the "
                                   "per-thread partial sums",
                     tol=tol, platform=platform, **err))
    return rows


def run(args: argparse.Namespace) -> List[dict]:
    """Every phase of the probe; returns its rows (also appended to
    --out)."""
    device = _common.device_for(args.backend)
    platform = _common.platform_of(device)
    rows = shape_table(device)
    rows += throughput(device, args.tput_blocks, args.reps, platform)
    rows += sweep(device, args.elements, args.x_elems, args.reps, platform)
    path = _common.write_rows(args.out or _common.default_out(NAME), rows)
    print(f"\n{len(rows)} rows appended to {path}")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    rows = run(build_parser().parse_args(argv))
    return 0 if all(r.get("correct", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
