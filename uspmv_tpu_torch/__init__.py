"""uspmv_tpu_torch — Ultimate-SpMV on PyTorch and CUDA.

The port of the ``uspmv_tpu`` JAX package to PyTorch with a hand-written
CUDA kernel for NVIDIA Hopper (H100). It computes y = A x and Y = A X
(block vectors) in the SELL-C-sigma format of RRZE-HPC/Ultimate-SpMV, in
dp, sp, hp or an adaptive dp/sp/hp split of A's nonzeros, on one device;
the JAX package remains the reference it is tested against. Host
structures (COO, SCS arrays, permutations) are numpy and bit-equal to the
JAX package's; device data are torch tensors on an explicit device.

Precision naming follows the reference (classes_structs.hpp:47-153):
  dp = float64, sp = float32, hp = bfloat16 values with float32 vectors.

This package never imports jax.
"""

__version__ = "0.1.0"

from .config import Config, DefaultValues, PRECISION_DTYPES, dtype_for
from .formats.coo import MtxData, apply_permutation
from .formats.scs import (
    ScsData,
    convert_to_scs,
    permute_scs_cols,
    scs_from_reference,
)
from .io.mmio import read_mtx, write_mtx
from .ops.scs_solve import solve_scs, solve_scs_plain
from .ops.scs_spmv import launch_count, spmv_scs, spmv_scs_plain
from .precision.partition import partition_precisions
from .runtime.operator import DeviceUnavailableError, SpmvOperator

__all__ = [
    "Config",
    "DefaultValues",
    "PRECISION_DTYPES",
    "dtype_for",
    "MtxData",
    "apply_permutation",
    "ScsData",
    "convert_to_scs",
    "permute_scs_cols",
    "scs_from_reference",
    "read_mtx",
    "write_mtx",
    "launch_count",
    "spmv_scs",
    "spmv_scs_plain",
    "solve_scs",
    "solve_scs_plain",
    "partition_precisions",
    "DeviceUnavailableError",
    "SpmvOperator",
]
