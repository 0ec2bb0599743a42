"""Debug-mode sanity checker.

Port of ``uspmv_tpu/runtime/sanity.py``, the reference's ``SanityChecker``
(sanity_checker.hpp:9-353, DEBUG_MODE_FINE): stage-labelled dumps of x/y
around the solve plus structural invariant checks (permutation validity,
SCS padding placement, halo-plan consistency). Enabled by -debug 1; dumps
go to ``Config.output_dir``/uspmv_debug_rank<r>.log like the reference's
per-rank stdout ladders, in the JAX checker's text for the same vectors.
Vectors are host arrays (``op.to_host``); a torch tensor is copied to the
host first.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _host(vec) -> np.ndarray:
    if hasattr(vec, "detach"):  # a torch tensor, on any device
        return vec.detach().cpu().numpy()
    return np.asarray(vec)


class SanityChecker:
    """Collects stage dumps and runs invariant checks.

    Methods mirror the reference's check_* entry points; each either writes
    a labelled dump (vector stages) or raises AssertionError with a precise
    message (structural checks).
    """

    def __init__(self, output_dir: str = ".", rank: int = 0,
                 max_elems: int = 32, enabled: bool = True):
        self.enabled = enabled
        self.rank = rank
        self.max_elems = max_elems
        self.path = os.path.join(output_dir, f"uspmv_debug_rank{rank}.log")
        if enabled and os.path.exists(self.path):
            os.remove(self.path)

    # ------------------------------------------------------------- dumps

    def _write(self, text: str) -> None:
        with open(self.path, "a") as f:
            f.write(text)

    def dump_vector(self, label: str, vec, n_rows: Optional[int] = None):
        """Stage dump (reference check_vectors_before/after_*,
        sanity_checker.hpp:22-180)."""
        if not self.enabled:
            return
        a = _host(vec)
        v = a.reshape(-1)
        head = v[: self.max_elems]
        self._write(
            f"[rank {self.rank}] {label}: shape={a.shape} "
            f"n_rows={n_rows if n_rows is not None else len(v)} "
            f"head={np.array2string(head, precision=6, max_line_width=120)}\n"
        )

    def dump_stage(self, stage: str, **vectors):
        """Dump several vectors under one stage label, e.g.
        dump_stage('before_spmv', x=x, y=y)."""
        for name, vec in vectors.items():
            self.dump_vector(f"{stage}.{name}", vec)

    # ------------------------------------------------------------ checks

    def check_perm(self, perm, n: Optional[int] = None):
        """Permutation is a bijection on [0, n) (reference perm checks in
        ScsData::permute, classes_structs.hpp:1707-1714)."""
        if not self.enabled:
            return
        p = _host(perm)
        n = n if n is not None else p.size
        if p.size != n:
            raise AssertionError(f"perm has {p.size} entries, expected {n}")
        seen = np.zeros(n, dtype=bool)
        if (p < 0).any() or (p >= n).any():
            raise AssertionError("perm entry out of range")
        seen[p] = True
        if not seen.all():
            missing = int(np.flatnonzero(~seen)[0])
            raise AssertionError(f"perm is not a bijection (missing {missing})")

    def check_scs_padding(self, scs):
        """Structural zero padding carries value 0 (reference padding
        checks, sanity_checker.hpp:200-260)."""
        if not self.enabled:
            return
        pad = scs.padding_mask()
        vals = np.asarray(scs.values, dtype=np.float64)
        if (vals[pad] != 0.0).any():
            raise AssertionError("SCS padding slot holds a nonzero value")

    def check_halo_plan(self, plan, n_local_rows: Optional[int] = None):
        """On a ``parallel.halo.HaloPlan``: every send index of shard r is
        one of its local rows (below ``n_rows_padded[r]``, or
        ``n_local_rows`` where given) and every receive index lands in its
        halo region or the dump slot H (reference mismatched-buffer check,
        classes_structs.hpp:934-939). The JAX checker reads a
        ``send_idxs`` field its plan does not have; this one checks the
        plan's own index matrices."""
        if not self.enabled:
            return
        for d in plan.offsets:
            gather = np.asarray(plan.send_gather_idx[d])
            scatter = np.asarray(plan.recv_scatter_idx[d])
            for r in range(plan.n_shards):
                lo = plan.n_rows_padded[r]
                top = lo if n_local_rows is None else n_local_rows
                g, s = gather[r], scatter[r]
                if g.size and ((g < 0).any() or (g >= top).any()):
                    raise AssertionError(
                        f"send idx out of local range for shard {r}, "
                        f"offset {d}")
                inside = (s >= lo) & (s < lo + plan.halo_counts[r])
                if not (inside | (s == plan.H)).all():
                    raise AssertionError(
                        f"recv idx outside the halo of shard {r}, "
                        f"offset {d}")

    def check_finite(self, label: str, vec):
        if not self.enabled:
            return
        v = np.asarray(_host(vec), dtype=np.float64)
        if not np.isfinite(v).all():
            bad = int(np.flatnonzero(~np.isfinite(v.reshape(-1)))[0])
            raise AssertionError(f"{label}: non-finite value at flat index {bad}")
