"""Runtime configuration.

Port of ``uspmv_tpu/config.py``: one runtime dataclass holding every knob
of the reference CLI (reference classes_structs.hpp:47-153,
utilities.hpp:1047-1545). All fields are kept so that the CLI parser ports
whole; the operator raises ``NotImplementedError`` for values outside the
ported slices (runtime/operator.py). Device dtypes are torch dtypes.

hp on the host: numpy has no bfloat16, so host hp values are float32
arrays that carry bf16-rounded values (``host_values``), rounded by torch
the way ``ml_dtypes`` rounds them in the JAX package; on the device they
are ``torch.bfloat16`` tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Precision names follow the reference CLI (-dp/-sp/-hp/-ap[...]).
PRECISION_DTYPES = {
    "dp": torch.float64,
    "sp": torch.float32,
    "hp": torch.bfloat16,
}
# Host-side (numpy) value dtypes; numpy has no bfloat16, so hp values are
# held as float32 arrays of bf16-rounded values (host_values)
HOST_DTYPES = {
    "dp": np.dtype(np.float64),
    "sp": np.dtype(np.float32),
    "hp": np.dtype(np.float32),
}

AP_VALUE_TYPES = ("ap[dp_sp]", "ap[dp_hp]", "ap[sp_hp]", "ap[dp_sp_hp]")
VALUE_TYPES = ("dp", "sp", "hp") + AP_VALUE_TYPES
KERNEL_FORMATS = ("crs", "scs")
SEG_METHODS = ("seg-rows", "seg-nnz", "seg-metis")
# Reference block-vector layouts (Makefile:17-31): colwise = X[vec_len*v + row],
# rowwise = X[row*bs + v].
VECTOR_LAYOUTS = ("colwise", "rowwise")
# Reference MPI message-batching modes (Makefile:199-218) plus "allgather".
COMM_MODES = ("singlevec", "multivec", "bulkvec", "graphtopo", "allgather")
BACKENDS = ("cuda", "cpu")


def dtype_for(prec: str) -> torch.dtype:
    """Torch dtype for a precision name ('dp'|'sp'|'hp')."""
    return PRECISION_DTYPES[prec]


def host_values(values: np.ndarray, prec: str) -> np.ndarray:
    """``values`` in precision ``prec`` on the host: float64 (dp), float32
    (sp), or float32 carrying bf16-rounded values (hp) — the same numbers
    the JAX package holds as ``ml_dtypes.bfloat16``."""
    if prec == "hp":
        t = torch.from_numpy(np.ascontiguousarray(values))
        return t.to(torch.bfloat16).to(torch.float32).numpy()
    return values.astype(HOST_DTYPES[prec])


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a float32/float64 torch dtype."""
    return {torch.float32: np.dtype(np.float32),
            torch.float64: np.dtype(np.float64)}[dtype]


@dataclasses.dataclass
class Config:
    """All runtime knobs; mirrors reference Config + compile-time defines."""

    # --- format (reference: -c, -s; classes_structs.hpp:49-51) ---
    chunk_size: int = 1  # C of SELL-C-sigma
    sigma: int = 1  # sorting scope
    kernel_format: str = "scs"  # 'crs' | 'scs'

    # --- precision (reference: -dp/-sp/-hp/-ap[...]) ---
    value_type: str = "dp"

    # --- block vectors / SpMMV (reference: -block_vec_size, BLOCK_VECTOR_LAYOUT) ---
    block_vec_size: int = 1
    vector_layout: str = "colwise"  # 'colwise' | 'rowwise'

    # --- x initialization (reference: -rand_x 0|1|m, DefaultValues) ---
    random_init_x: bool = False
    mean_init_x: bool = False  # 'm': fill x with the matrix min/max midpoint
    random_init_A: bool = False
    seed: int = 42

    # --- modes & loop counts (reference: -mode, -rev, -bench_time) ---
    mode: str = "b"  # 'b' bench | 's' solve
    n_repetitions: int = 1
    bench_time: float = 5.0
    validate_result: bool = True
    verbose: bool = False

    # --- adaptive precision (reference: -ap_threshold_1/2, -dropout*) ---
    ap_threshold_1: float = 0.0
    ap_threshold_2: float = 0.0
    dropout: bool = False
    dropout_threshold: float = 0.0

    # --- scaling (reference: -equilibrate, jacobi_scale) ---
    equilibrate: bool = False
    jacobi_scale: bool = False

    # --- heavy-row splitting (extension beyond the reference) ---
    # N = rows longer than N are cut into pieces of N; 0 = auto
    # (min(max(4 * mean row length, 32), 1024)); -1 = disabled
    split_rows_threshold: int = 0

    # --- distribution (reference: -seg_method, MPI_MODE) ---
    seg_method: str = "seg-rows"
    comm_mode: str = "bulkvec"
    overlap_comm: bool = True
    comm_halos: bool = True  # reference: -comm_halos
    ba_synch: bool = True
    par_pack: bool = True
    no_pack: bool = False
    print_comm_vol: bool = False
    n_shards: int = 1

    # --- device execution ---
    # -dp_emu: on the TPU the df64 (hi, lo) float-pair kernel; the GPU has
    # native f64, so here it runs the dp stream in plain double
    dp_emulation: bool = False
    # 'cuda' runs the hand-written kernel on the current CUDA device and
    # raises when there is none; 'cpu' runs the plain PyTorch version
    backend: str = "cuda"
    use_pallas: bool = True
    impl: str = "auto"
    # TPU lane-tile packing knobs of the JAX package; the port runs the
    # user's (C, sigma) as given and reads neither
    tile_elems: int = 1024
    retile: bool = True
    # the padding-free tier (the JAX package's mixed tiles; here packed row
    # groups): True forces it, False forbids it, None takes it when the
    # SELL-C-sigma fill beta is low (runtime/operator.PACKED_BETA_CUTOFF)
    mixed_tiles: Optional[bool] = None

    # --- reporting (reference: output_filename_*) ---
    output_dir: str = "."
    matrix_file_name: str = ""
    mode_matrix_stats: bool = False
    output_sparsity: bool = False
    log_prof: bool = False
    debug_mode: bool = False

    def validate(self) -> None:
        """Cross-validation of flag combinations (ref utilities.hpp:1047-1545)."""
        if self.kernel_format not in KERNEL_FORMATS:
            raise ValueError(f"kernel_format must be one of {KERNEL_FORMATS}")
        if self.value_type not in VALUE_TYPES:
            raise ValueError(f"value_type must be one of {VALUE_TYPES}")
        if self.mode not in ("b", "s"):
            raise ValueError("mode must be 'b' (bench) or 's' (solve)")
        if self.chunk_size < 1 or self.sigma < 1:
            raise ValueError("chunk_size and sigma must be >= 1")
        if self.vector_layout not in VECTOR_LAYOUTS:
            raise ValueError(f"vector_layout must be one of {VECTOR_LAYOUTS}")
        if self.seg_method not in SEG_METHODS:
            raise ValueError(f"seg_method must be one of {SEG_METHODS}")
        if self.comm_mode not in COMM_MODES:
            raise ValueError(f"comm_mode must be one of {COMM_MODES}")
        if self.impl not in ("auto", "xla", "bcoo"):
            raise ValueError("impl must be one of ('auto', 'xla', 'bcoo')")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        if self.dp_emulation:
            if "dp" not in self.ap_precisions:
                raise ValueError(
                    "-dp_emu requires a dp value stream (dp or ap[dp_*])"
                )
            if self.block_vec_size > 1 and self.vector_layout != "rowwise":
                raise ValueError(
                    "-dp_emu block vectors require -layout rowwise (the "
                    "df64 kernel fuses all RHS columns in one stream)"
                )
        if self.block_vec_size < 1:
            raise ValueError("block_vec_size must be >= 1")
        if self.value_type in AP_VALUE_TYPES:
            if self.ap_threshold_1 < 0:
                raise ValueError("ap_threshold_1 must be >= 0")
            if self.value_type == "ap[dp_sp_hp]" and not (
                0 <= self.ap_threshold_2 <= self.ap_threshold_1
            ):
                # reference requires 0 <= th2 <= th1 (utilities.hpp:3042-3121)
                raise ValueError("need 0 <= ap_threshold_2 <= ap_threshold_1")
        if self.dropout and self.dropout_threshold < 0:
            raise ValueError("dropout_threshold must be >= 0")
        if self.kernel_format == "crs" and (self.chunk_size != 1 or self.sigma != 1):
            raise ValueError("crs implies chunk_size == sigma == 1")

    @property
    def is_ap(self) -> bool:
        return self.value_type in AP_VALUE_TYPES

    @property
    def ap_precisions(self) -> tuple:
        """Ordered precisions of an adaptive value type, e.g. ('dp','sp')."""
        if not self.is_ap:
            return (self.value_type,)
        return tuple(self.value_type[3:-1].split("_"))

    def working_dtype(self) -> torch.dtype:
        """The dtype y/x are held in: the highest precision in play, with
        bfloat16 promoted to float32 (hp = bf16 values, f32 vectors)."""
        d = dtype_for(self.ap_precisions[0])
        if d == torch.bfloat16:
            return torch.float32
        return d


@dataclasses.dataclass
class DefaultValues:
    """Initial x/y fills (reference classes_structs.hpp:1792-1810)."""

    A: float = 2.0
    x: float = 5.00
    y: float = 0.0
