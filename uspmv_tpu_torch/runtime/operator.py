"""SpmvOperator — the kernel dispatch / execution object.

Port of the main-path subset of ``uspmv_tpu/runtime/operator.py``
(reference ``SpmvKernel``, classes_structs.hpp:280-1166): one precision
(sp or dp), one right-hand side, one device, SCS or CRS at the user's
(C, sigma). Pipeline (reference init_local_structs, main.cpp:1074-1334):

  ingest COO -> convert_to_scs -> symmetric column permutation ->
  device tensors -> spmv (CUDA kernel, or its plain version on the CPU)

Unlike the JAX package, the port does not re-tile (C, sigma) into
1024-row lane-tile chunks: the CUDA kernel runs the user's layout as it
is. Heavy rows are not split. Everything outside this slice raises
``NotImplementedError`` naming the later slice that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..config import HOST_DTYPES, Config
from ..formats.coo import MtxData, extract_matrix_min_mean_max
from ..formats.scs import ScsData, convert_to_scs, permute_scs_cols
from ..ops.device_format import DeviceScs, build_device_scs
from ..ops.scs_spmv import spmv_scs
from ..ops.vectors import from_device_layout, init_x_host, to_device_layout


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
        (config.is_ap, "adaptive precision (slice 3)"),
        (config.value_type == "hp", "hp / bfloat16 values (slice 2)"),
        (config.block_vec_size > 1, "block vectors / SpMMV (slice 2)"),
        (config.dp_emulation, "-dp_emu (slice 2: native f64 on the GPU)"),
        (config.n_shards > 1, "distributed execution (slice 6)"),
        (config.impl == "bcoo", "the vendor comparison impl='bcoo' (slice 7)"),
        (config.impl == "xla" or not config.use_pallas,
         "impl='xla' (the port has one kernel path; impl='auto')"),
        (config.equilibrate or config.jacobi_scale,
         "equilibrate / jacobi_scale (slice 3)"),
        (config.split_rows_threshold > 0, "heavy-row splitting (slice 5)"),
        (config.mixed_tiles is True, "zero-locality tiers (slice 5)"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(
                f"uspmv_tpu_torch does not port {what} yet"
            )


@dataclasses.dataclass
class SpmvOperator:
    config: Config
    n_rows: int
    n_rows_padded: int
    scs: Dict[str, ScsData]  # host struct per precision
    devs: Dict[str, DeviceScs]  # device struct per precision
    old_to_new: np.ndarray
    matrix_stats: tuple
    nnz: int
    device: torch.device

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
        C = config.chunk_size if config.kernel_format == "scs" else 1
        sigma = config.sigma if config.kernel_format == "scs" else 1
        prec = config.value_type
        scs = convert_to_scs(mtx.astype(HOST_DTYPES[prec]), C, sigma)
        # symmetric column permutation so x can live in permuted order
        # (reference main.cpp:1308 -> permute_scs_cols)
        full_perm = np.arange(scs.n_rows_padded, dtype=np.int32)
        full_perm[: scs.n_rows] = scs.old_to_new_idx
        permute_scs_cols(scs, full_perm)
        return cls.from_scs(config, scs, stats, mtx.nnz, device)

    @classmethod
    def from_scs(
        cls,
        config: Config,
        scs: ScsData,
        matrix_stats: tuple,
        nnz: int,
        device: Optional[torch.device] = None,
    ) -> "SpmvOperator":
        """Operator over a given host ``ScsData`` whose columns are already
        symmetrically permuted (``permute_scs_cols``). ``device`` defaults
        to the one ``config.backend`` names."""
        config.validate()
        check_slice(config)
        if device is None:
            device = resolve_device(config)
        expect = HOST_DTYPES[config.value_type]
        if scs.values.dtype != expect:
            raise TypeError(
                f"{config.value_type} needs {expect} values, got "
                f"{scs.values.dtype}"
            )
        return cls(
            config=config,
            n_rows=scs.n_rows,
            n_rows_padded=scs.n_rows_padded,
            scs={config.value_type: scs},
            devs={config.value_type: build_device_scs(scs, device)},
            old_to_new=scs.old_to_new_idx[: scs.n_rows],
            matrix_stats=matrix_stats,
            nnz=nnz,
            device=device,
        )

    # ------------------------------------------------------------- execution

    @property
    def working_dtype(self) -> torch.dtype:
        return self.config.working_dtype()

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """One y = A x in device layout (permuted/padded)."""
        (dev,) = self.devs.values()
        return spmv_scs(dev, x)

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
        host = init_x_host(
            self.config,
            self.n_rows,
            self.matrix_stats,
            x_in=x_in,
            dtype=HOST_DTYPES[self.config.value_type],
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

    def bytes_per_spmv(self) -> int:
        """Minimum traffic: matrix stream (values + int32 columns + chunk
        metadata) + x + y. Not comparable with the JAX package's count,
        whose lane tiles stream int16 gather tables."""
        total = sum(dev.stream_bytes() for dev in self.devs.values())
        xw = torch.empty((), dtype=self.working_dtype).element_size()
        total += self.n_rows_padded * self.config.block_vec_size * xw * 2
        return total

    def beta(self) -> Dict[str, float]:
        """Fill efficiency of the user's (C, sigma) format (reference
        main.cpp:693)."""
        return {p: s.beta for p, s in self.scs.items()}

    def device_beta(self) -> Dict[str, float]:
        return {p: d.device_beta for p, d in self.devs.items()}

    def nnz_per_precision(self) -> Dict[str, int]:
        return {p: s.nnz for p, s in self.scs.items()}

    def impl_name(self) -> str:
        """Which implementation executes: the CUDA kernel or, on the CPU,
        its plain PyTorch version."""
        return "cuda-scs" if self.device.type == "cuda" else "torch-plain-scs"
