"""Independent comparison path: the vendor's sparse product.

Port of ``uspmv_tpu/ops/spmv_bcoo.py``. The reference cross-checks its
kernels against a vendor library it did not write: cuSPARSE CSR and
SlicedEll descriptors (utilities.hpp:3380-3550, invoked via cusparseSpMV at
classes_structs.hpp:998-1011). The JAX package's analogue is
``jax.experimental.sparse`` BCOO; here it is PyTorch's sparse CSR product,
``torch.sparse_csr_tensor(...) @ x``, which runs cuSPARSE on the card (and
PyTorch's own CSR product on the CPU). Select with ``-impl bcoo``; the
bench block then reports a number produced by the vendor's kernels rather
than this package's, against the JAX operator's flops/bytes accounting.

Deliberately minimal, as in JAX: no SCS conversion, no row permutation,
no halo machinery; x and y stay in natural order, so nothing from the
format pipeline can leak into it. Uniform dp/sp/hp only, one device.
Values are stored in the value type and widened to the working dtype
before the product (hp: rounded to bf16, then widened to f32), the JAX
path's rule (spmv_bcoo.py:124-133): bf16 quantisation stays, bf16
accumulation does not, and cuSPARSE takes an f32 matrix with f32 x. It is
a library path by design, never the default, and no port of a kernel.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config, dtype_for, host_values, numpy_dtype
from ..formats.coo import MtxData, extract_matrix_min_mean_max
from ..ops.vectors import init_x_host
from ..runtime.operator import OperatorBase, resolve_device


@dataclasses.dataclass
class CsrDev:
    """One precision's CSR matrix on the device, with the JAX BCOO's byte
    count: values in the value type plus an int32 (row, column) pair per
    nonzero."""

    mat: torch.Tensor  # sparse CSR, values widened to the working dtype
    nnz: int
    value_bytes: int  # bytes of one stored value in the value type

    def stream_bytes(self) -> int:
        return self.nnz * (self.value_bytes + 8)

    @property
    def device_beta(self) -> float:
        return 1.0  # CSR stores no padding


@dataclasses.dataclass
class BcooSpmvOperator(OperatorBase):
    """Same public surface as ``SpmvOperator``, executing through the
    vendor's CSR product; the metrics it shares with it come from
    ``OperatorBase``. Single-device only: a comparison baseline, not a
    distribution path."""

    config: Config
    n_rows: int
    n_rows_padded: int
    devs: Dict[str, CsrDev]
    matrix_stats: tuple
    nnz: int
    device: torch.device
    mtx: MtxData  # natural order, values as stored (dump_sparsity)
    split_threshold: int = 0
    n_dropped: int = 0

    @classmethod
    def from_mtx(cls, config: Config, mtx: MtxData) -> "BcooSpmvOperator":
        config.validate()
        if config.n_shards > 1:
            raise ValueError("-impl bcoo is a single-device comparison path")
        if config.is_ap:
            raise ValueError(
                "-impl bcoo supports uniform precisions only (dp|sp|hp)"
            )
        mtx = mtx.copy()
        if not mtx.is_sorted:
            mtx = mtx.sort_by_row()
        stats = extract_matrix_min_mean_max(mtx)
        device = resolve_device(config)
        prec = config.value_type
        vals = host_values(mtx.values, prec)
        stored = dataclasses.replace(mtx, values=vals)
        # CSR in (row, column) order; duplicates stay and are summed
        order = np.lexsort((mtx.J, mtx.I))
        crow = np.zeros(mtx.n_rows + 1, dtype=np.int64)
        np.cumsum(np.bincount(mtx.I, minlength=mtx.n_rows), out=crow[1:])
        idx = torch.int32 if device.type == "cuda" else torch.int64
        wd = numpy_dtype(config.working_dtype())
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Sparse CSR tensor support")
            warnings.filterwarnings("ignore", "Sparse invariant checks")
            mat = torch.sparse_csr_tensor(
                torch.from_numpy(crow).to(device, idx),
                torch.from_numpy(mtx.J[order].astype(np.int64)).to(device,
                                                                    idx),
                torch.from_numpy(vals[order].astype(wd)).to(device),
                size=(mtx.n_rows, mtx.n_cols), check_invariants=False,
            )
        return cls(
            config=config,
            n_rows=mtx.n_rows,
            n_rows_padded=mtx.n_rows,
            devs={prec: CsrDev(
                mat=mat, nnz=mtx.nnz,
                value_bytes=torch.empty((), dtype=dtype_for(prec))
                .element_size())},
            matrix_stats=stats,
            nnz=mtx.nnz,
            device=device,
            mtx=stored,
        )

    # ------------------------------------------------------------- execution

    def spmv(self, x: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """y = A x in natural order: one vector, rowwise block vectors
        [n, bs] as one sparse-dense product, colwise [bs, n] vector by
        vector. With ``out`` given, y is copied into it."""
        mat = next(iter(self.devs.values())).mat
        if x.dim() == 2 and self.config.vector_layout == "colwise":
            y = torch.stack([mat @ x[i] for i in range(x.shape[0])])
        else:
            y = mat @ x
        if out is not None:
            return out.copy_(y)
        return y

    def solve_impl_name(self, n_repetitions: int = 2,
                        impl: Optional[str] = None) -> str:
        """Always "loop": the comparison path runs a Python loop of
        products."""
        if impl not in (None, "loop"):
            raise ValueError(f"-impl bcoo solves by 'loop', not {impl!r}")
        return "loop"

    def solve(self, x: torch.Tensor, n_repetitions: int,
              impl: Optional[str] = None) -> tuple:
        """n_repetitions of y = A x with the x <-> y swap; returns
        (x_last_input, y_result)."""
        self.solve_impl_name(n_repetitions, impl)
        prev = torch.zeros_like(x)
        for _ in range(n_repetitions):
            prev, x = x, self.spmv(x)
        return prev, x

    # --------------------------------------------------------------- vectors

    def make_x(self, x_in: Optional[np.ndarray] = None) -> torch.Tensor:
        host = init_x_host(
            self.config, self.n_rows, self.matrix_stats,
            x_in=x_in, dtype=numpy_dtype(self.working_dtype),
        )
        if self.config.block_vec_size > 1 and \
                self.config.vector_layout == "colwise":
            host = np.ascontiguousarray(host.T)  # [bs, n]
        return torch.from_numpy(host).to(self.device)

    def to_host(self, y: torch.Tensor) -> np.ndarray:
        y = y.detach().cpu().numpy()
        if self.config.block_vec_size > 1 and \
                self.config.vector_layout == "colwise":
            y = np.ascontiguousarray(y.T)
        return y

    # --------------------------------------------------------------- metrics

    def bytes_per_spmv(self) -> int:
        """The JAX operator's count: the matrix once (values in the value
        type + int32 row and column per nonzero) + x + y in the working
        dtype."""
        total = sum(d.stream_bytes() for d in self.devs.values())
        xw = torch.empty((), dtype=self.working_dtype).element_size()
        total += self.n_rows * self.config.block_vec_size * xw * 2
        return total

    def beta(self) -> Dict[str, float]:
        return {p: 1.0 for p in self.devs}

    def device_beta(self) -> Dict[str, float]:
        return {p: d.device_beta for p, d in self.devs.items()}

    def nnz_per_precision(self) -> Dict[str, int]:
        return {p: self.nnz for p in self.devs}

    def n_pieces(self) -> int:
        return 0

    def nnz_in_pieces(self) -> int:
        return 0

    def impl_name(self) -> str:
        """cusparse-csr-<value type> on the card, torch-csr-<value type>
        on the CPU (PyTorch's own CSR product)."""
        where = "cusparse" if self.device.type == "cuda" else "torch"
        return f"{where}-csr-{self.config.value_type}"

    def dump_sparsity(self, outdir: str) -> list:
        """-output_sparsity: the matrix as stored, in its value type,
        natural (= original) order, exact zeros dropped as the SCS dump
        drops them, into ``<value type>_local_scs.mtx``."""
        from ..io.mmio import write_mtx

        m = self.mtx
        keep = m.values.astype(np.float64) != 0.0
        path = os.path.join(outdir, f"{self.config.value_type}_local_scs.mtx")
        write_mtx(path, MtxData.from_arrays(
            m.I[keep], m.J[keep], m.values[keep],
            n_rows=m.n_rows, n_cols=m.n_cols))
        return [path]
