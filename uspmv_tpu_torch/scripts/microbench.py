"""Primitive microbenchmarks: the array operations around an SpMV, as
PyTorch calls, timed on the device.

Port of the JAX package's scripts/microbench.py. Its cases are XLA
operations, not Pallas kernels, so here each is the PyTorch call that
computes the same thing (``index_select``, ``index_add_``, ``torch.gather``,
``torch.roll``). Its ``take_1d`` and ``take_mul`` are the library
yardsticks of the x-gather probe kernels: scripts/gather_probe.py's sweep
times these two functions at its own sizes and indices. On a GPU each case is
timed by replaying a CUDA graph of R calls (the JAX script looped the
operation inside one jitted fori_loop to reach the device's own time); on
the CPU by the host clock.

    python -m uspmv_tpu_torch.scripts.microbench [case ...]
        [--backend cuda|cpu] [--n N] [--elements E] [--reps R] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _common

NAME = "microbench"
DIA_OFFSETS = (-4096, -64, -1, 0, 1, 64, 4096)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"uspmv_tpu_torch.scripts.{NAME}",
                                description=__doc__.split("\n")[0])
    p.add_argument("cases", nargs="*", help="cases to run (default: all)")
    _common.add_common_args(p, NAME)
    p.add_argument("--n", type=int, default=1 << 18, help="length of x")
    p.add_argument("--elements", type=int, default=1 << 21,
                   help="gathered / scattered elements E")
    p.add_argument("--reps", type=int, default=50)
    return p


def take_1d(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x[cols]: the gather alone."""
    return torch.index_select(x, 0, cols)


def take_mul(vals: torch.Tensor, x: torch.Tensor,
             cols: torch.Tensor) -> torch.Tensor:
    """vals * x[cols]: the gather and the product of an SpMV's inner loop."""
    return vals * torch.index_select(x, 0, cols)


def make_cases(n: int, E: int, device: torch.device
               ) -> Dict[str, Tuple[Callable[[], torch.Tensor], int]]:
    """case -> (the call, the bytes it moves), the JAX script's cases with
    its data drawn from numpy's generator seeded 0 in the same order."""
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    x = put(rng.standard_normal(n).astype(np.float32))
    cols = put(rng.integers(0, n, E).astype(np.int64))
    vals = put(rng.standard_normal(E).astype(np.float32))
    rows_sorted = put(np.sort(rng.integers(0, n, E)).astype(np.int64))
    W = E // 8
    x8 = put(rng.standard_normal((8, W)).astype(np.float32))
    idx8 = put(rng.integers(0, W, (8, W)).astype(np.int64))
    xK = put(rng.standard_normal((E // 128, 128)).astype(np.float32))
    iK = put(rng.integers(0, 128, (E // 128, 128)).astype(np.int64))
    iK16 = iK // 16
    diags = put(rng.standard_normal((7, n)).astype(np.float32))

    def dia():
        y = diags[0] * torch.roll(x, DIA_OFFSETS[0])
        for k, off in enumerate(DIA_OFFSETS[1:], start=1):
            y = y + diags[k] * torch.roll(x, off)
        return y

    return {
        "stream_mul": (lambda: vals * 2.0, 2 * E * 4),
        "take_1d": (lambda: take_1d(x, cols), E * 8),
        "take_mul": (lambda: take_mul(vals, x, cols), E * 12),
        "scatter_add": (lambda: torch.zeros(n, device=device).index_add_(
            0, cols, vals), E * 8),
        "segsum_sorted": (lambda: torch.zeros(n, device=device).index_add_(
            0, rows_sorted, vals), E * 8),
        "taa_lanes_8xW": (lambda: torch.gather(x8, 1, idx8), E * 8),
        "taa_lanes_Kx128": (lambda: torch.gather(xK, 1, iK), E * 8),
        "taa_sublanes_Kx128": (lambda: torch.gather(xK, 0, iK16), E * 8),
        "dia_7": (dia, 9 * n * 4),
    }


def run(args: argparse.Namespace) -> List[dict]:
    device = _common.device_for(args.backend)
    platform = _common.platform_of(device)
    cases = make_cases(args.n, args.elements, device)
    unknown = [c for c in args.cases if c not in cases]
    if unknown:
        raise ValueError(f"unknown cases {unknown}; known: {list(cases)}")
    rows = []
    for name in args.cases or list(cases):
        fn, nbytes = cases[name]
        ms = _common.device_ms(fn, args.reps, device)
        print(f"{name:20s}: {ms:9.4f} ms/iter  {nbytes / ms / 1e6:8.1f} GB/s")
        rows.append(dict(case=name, ms_per_iter=ms, gbps=nbytes / ms / 1e6,
                         bytes=nbytes, n=args.n, elements=args.elements,
                         reps=args.reps, platform=platform))
    path = _common.write_rows(args.out or _common.default_out(NAME), rows)
    print(f"\n{len(rows)} rows appended to {path}")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
