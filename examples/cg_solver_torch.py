#!/usr/bin/env python
"""Conjugate-gradient solve built on the embedding API of the PyTorch port.

The counterpart of examples/cg_solver.py: what a user of the reference
library would do with ``interface.hpp``, embed the SpMV kernel inside their
own iterative solver. The whole iteration stays on the device in the
operator's layout: the SpMV is ``op.spmv`` (the CUDA kernel on a GPU), the
dots and axpys are PyTorch's, and the residual is read back only once per
batch of iterations.

Usage: python examples/cg_solver_torch.py [matrix.mtx | 'Laplace3D,48']
           [--tol 1e-6] [--maxiter 500] [--backend cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

BATCH = 25  # iterations between two reads of the residual


def cg(op, b_host, tol=1e-6, maxiter=500):
    """CG on the device layout; returns (x_host, n_iters, rel_residual)."""
    import torch

    b = op.make_x(b_host)

    def step(state):
        x, r, p, rs = state
        Ap = op.spmv(p)
        alpha = rs / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        return (x, r, p, rs_new)

    rs = torch.dot(b, b)
    b_norm = float(torch.sqrt(rs))
    state = (torch.zeros_like(b), b, b, rs)
    it = 0
    res = 1.0
    while it < maxiter:
        n = min(BATCH, maxiter - it)
        for _ in range(n):
            state = step(state)
        it += n
        # one device sync per batch, not per iteration
        res = float(torch.sqrt(state[3])) / b_norm
        if res <= tol:
            break
    return op.to_host(state[0]), it, res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("matrix", nargs="?", default="Laplace3D,48")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()

    import uspmv_tpu_torch.interface as ui
    from uspmv_tpu_torch.cli import load_matrix

    mtx = load_matrix(args.matrix)  # SPD needed for CG (Laplacians are)
    h = ui.prepare(mtx, C=1024, sigma=1, value_type="sp",
                   backend=args.backend)
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(mtx.n_rows)
    b = mtx.to_scipy().tocsr() @ x_true

    x, it, res = cg(h, b, tol=args.tol, maxiter=args.maxiter)
    err = np.linalg.norm(x - x_true) / np.linalg.norm(x_true)
    print(f"CG: {it} iterations, rel residual {res:.2e}, "
          f"solution rel error {err:.2e} ({mtx.n_rows} rows, {mtx.nnz} nnz, "
          f"{h.impl_name()})")
    return 0 if res <= args.tol * 10 else 1


if __name__ == "__main__":
    sys.exit(main())
