#!/usr/bin/env python
"""Conjugate-gradient solve built on the embedding API of the PyTorch port.

The counterpart of examples/cg_solver.py: what a user of the reference
library would do with ``interface.hpp``, embed the SpMV kernel inside their
own iterative solver. The whole iteration stays on the device in the
operator's layout: the SpMV is ``op.spmv`` (the CUDA kernel on a GPU), the
dots and axpys are PyTorch's, and the residual is read back only once per
batch of iterations. On a GPU each batch of BATCH steps is one replay of a
CUDA graph captured once over static (x, r, p, rs) tensors (the
counterpart of the JAX example's ``jax.jit`` of a ``lax.scan``; a short
last batch gets its own graph); on the CPU the steps run eagerly.

Usage: python examples/cg_solver_torch.py [matrix.mtx | 'Laplace3D,48']
           [--tol 1e-6] [--maxiter 500] [--backend cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

BATCH = 25  # iterations between two reads of the residual


def cg_step(op):
    """One CG iteration on the state (x, r, p, rs); the dots stay 0-d
    device tensors, never read on the host."""
    import torch

    def step(state):
        x, r, p, rs = state
        Ap = op.spmv(p)
        alpha = rs / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        return (x, r, p, rs_new)

    return step


def eager_batches(step):
    """run(state, n): n steps launched one by one."""
    def run(state, n):
        for _ in range(n):
            state = step(state)
        return state

    return run


class GraphBatches:
    """run(state, n): n steps as one replay of a CUDA graph, captured at
    the first batch of n steps over static state tensors (which the replay
    updates in place and returns). The graph launches what the eager steps
    launch, in the same order, so the iterates are the same bits."""

    def __init__(self, step):
        self.step = step
        self.static = None
        self.graphs = {}

    def __call__(self, state, n):
        if self.static is None:
            self.static = tuple(t.clone() for t in state)
        elif state is not self.static:
            for dst, src in zip(self.static, state):
                dst.copy_(src)
        if n not in self.graphs:
            self.graphs[n] = self._capture(n)
        self.graphs[n].replay()
        return self.static

    def _capture(self, n):
        import torch

        # kernels built and libraries set up on a side stream first, from a
        # copy of the state: none of that is legal inside a capture
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.step(tuple(t.clone() for t in self.static))
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            state = self.static
            for _ in range(n):
                state = self.step(state)
            for dst, src in zip(self.static, state):
                dst.copy_(src)
        return graph


def cg(op, b_host, tol=1e-6, maxiter=500, batches=None):
    """CG on the device layout; returns (x_host, n_iters, rel_residual).
    ``batches(step)`` makes the runner of a batch (default: GraphBatches
    on a GPU, eager_batches on the CPU)."""
    import torch

    b = op.make_x(b_host)
    step = cg_step(op)
    if batches is None:
        batches = GraphBatches if b.device.type == "cuda" else eager_batches
    run = batches(step)
    rs = torch.dot(b, b)
    b_norm = float(torch.sqrt(rs))
    state = (torch.zeros_like(b), b, b, rs)
    it = 0
    res = 1.0
    while it < maxiter:
        n = min(BATCH, maxiter - it)
        state = run(state, n)
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
