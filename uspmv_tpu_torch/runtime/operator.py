"""SpmvOperator — the kernel dispatch / execution object.

Port of ``uspmv_tpu/runtime/operator.py`` (reference ``SpmvKernel``,
classes_structs.hpp:280-1166) for one device: SCS or CRS at the user's
(C, sigma), dp/sp/hp values, the four adaptive-precision (AP) splits, one
vector or a block of vectors (SpMMV, rowwise or colwise). Pipeline
(reference init_local_structs, main.cpp:1074-1334):

  ingest COO -> [jacobi | equilibrate] -> SCS-explosion guard ->
  [AP partition] -> convert_to_scs (the highest precision defines the row
  permutation, the rest reuse it) -> symmetric column permutation ->
  device tensors -> spmv (the CUDA kernel per precision stream, or its
  plain version on the CPU)

Unlike the JAX package, the port does not re-tile (C, sigma) into
1024-row lane-tile chunks: the CUDA kernel runs the user's layout as it
is. -dp_emu runs native f64 (the TPU's df64 pairs are not needed). Heavy
rows are not split. Everything outside the ported slices raises
``NotImplementedError`` naming the later slice that ports it.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config, dtype_for, host_values, numpy_dtype
from ..formats.coo import (
    MtxData,
    equilibrate_matrix,
    extract_matrix_min_mean_max,
    jacobi_scale_matrix,
)
from ..formats.scs import ScsData, convert_to_scs, permute_scs_cols
from ..ops.device_format import DeviceScs, build_device_scs
from ..ops.scs_spmv import spmv_scs
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


def check_slice(config: Config) -> None:
    """Raise NotImplementedError for configurations this port does not run
    yet, naming the slice of ROADMAP.md queue 1 that ports them."""
    unported = [
        (config.n_shards > 1, "distributed execution (slice 6)"),
        (config.impl == "bcoo", "the vendor comparison impl='bcoo' (slice 7)"),
        (config.impl == "xla" or not config.use_pallas,
         "impl='xla' (the port has one kernel path; impl='auto')"),
        (config.split_rows_threshold > 0, "heavy-row splitting (slice 5)"),
        (config.mixed_tiles is True, "zero-locality tiers (slice 5)"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(
                f"uspmv_tpu_torch does not port {what} yet"
            )


MAX_SCS_EXPANSION = 16.0  # n_elements / nnz beyond which SCS is refused


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


@dataclasses.dataclass
class SpmvOperator:
    config: Config
    n_rows: int
    n_rows_padded: int
    scs: Dict[str, ScsData]  # host struct per precision, highest first
    devs: Dict[str, DeviceScs]  # device struct per precision, same order
    old_to_new: np.ndarray
    matrix_stats: tuple
    nnz: int  # the whole matrix's nnz (dropped elements included)
    device: torch.device
    n_dropped: int = 0
    jacobi_diag: Optional[np.ndarray] = None
    equilib: Optional[tuple] = None

    # ----------------------------------------------------------------- build

    @classmethod
    def from_mtx(cls, config: Config, mtx: MtxData) -> "SpmvOperator":
        config.validate()
        check_slice(config)
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
        C, sigma = guard_scs_explosion(mtx, C, sigma)

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
        primary = convert_to_scs(subs[precs[0]], C, sigma)
        scs = {precs[0]: primary}
        for p in precs[1:]:
            scs[p] = convert_to_scs(
                subs[p], C, sigma, fixed_permutation=primary.old_to_new_idx
            )
        # symmetric column permutation so x can live in permuted order
        # (reference main.cpp:1308 -> permute_scs_cols)
        full_perm = np.arange(primary.n_rows_padded, dtype=np.int32)
        full_perm[: primary.n_rows] = primary.old_to_new_idx
        for s in scs.values():
            permute_scs_cols(s, full_perm)
        op = cls.from_scs(config, scs, stats, mtx.nnz, device)
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
    ) -> "SpmvOperator":
        """Operator over given host ``ScsData`` (one, or a dict per
        precision in ``config.ap_precisions`` order sharing one row
        permutation) whose columns are already symmetrically permuted
        (``permute_scs_cols``). ``device`` defaults to the one
        ``config.backend`` names."""
        config.validate()
        check_slice(config)
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
        return cls(
            config=config,
            n_rows=primary.n_rows,
            n_rows_padded=primary.n_rows_padded,
            scs=scs,
            devs={p: build_device_scs(s, device, dtype_for(p))
                  for p, s in scs.items()},
            old_to_new=primary.old_to_new_idx[: primary.n_rows],
            matrix_stats=matrix_stats,
            nnz=nnz,
            device=device,
        )

    # ------------------------------------------------------------- execution

    @property
    def working_dtype(self) -> torch.dtype:
        return self.config.working_dtype()

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """One y = A x in device layout (permuted/padded). Adaptive
        precision sums the streams in order, highest precision first: the
        first writes y, each later one adds into it (the JAX closure's
        y = y + y_k)."""
        layout = self.config.vector_layout
        y = None
        for dev in self.devs.values():
            y = spmv_scs(dev, x, layout, y)
        return y

    def solve(self, x: torch.Tensor, n_repetitions: int) -> tuple:
        """Solve mode: n_repetitions of y = A x with x<->y swap (reference
        main.cpp:528-607 + swap_local_vectors). Returns (x_last_input,
        y_result) after the final iteration, device layout."""
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

    def flops_per_spmv(self) -> int:
        """Useful flops only, padding excluded (reference main.cpp:521-526)."""
        return 2 * self.nnz * self.config.block_vec_size

    def matrix_passes(self) -> int:
        """Matrix streams per SpMV and precision: one, or one per vector
        for colwise block vectors."""
        if self.config.vector_layout == "colwise":
            return self.config.block_vec_size
        return 1

    def bytes_per_spmv(self) -> int:
        """Minimum traffic: each precision's matrix stream (values +
        int32 columns + chunk metadata), once per matrix pass, + x + y in
        the working dtype. Not comparable with the JAX package's count,
        whose lane tiles stream int16 gather tables."""
        total = self.matrix_passes() * sum(
            dev.stream_bytes() for dev in self.devs.values()
        )
        xw = torch.empty((), dtype=self.working_dtype).element_size()
        total += self.n_rows_padded * self.config.block_vec_size * xw * 2
        return total

    def beta(self) -> Dict[str, float]:
        """Fill efficiency of the user's (C, sigma) format per precision
        (reference main.cpp:693)."""
        return {p: s.beta for p, s in self.scs.items()}

    def device_beta(self) -> Dict[str, float]:
        return {p: d.device_beta for p, d in self.devs.items()}

    def nnz_per_precision(self) -> Dict[str, int]:
        return {p: s.nnz for p, s in self.scs.items()}

    def hp_nnz_fraction(self) -> float:
        """Share of the stored nonzeros in bf16, which sets the validation
        bound of hp mixes (runtime/validate.compare); 1.0 unless AP."""
        if not self.config.is_ap:
            return 1.0
        npp = self.nnz_per_precision()
        return npp.get("hp", 0) / max(sum(npp.values()), 1)

    def impl_name(self) -> str:
        """Which implementation executes, and on which value types: the
        CUDA kernel or, on the CPU, its plain PyTorch version."""
        base = "cuda-scs" if self.device.type == "cuda" else "torch-plain-scs"
        return f"{base}-{self.config.value_type}"
