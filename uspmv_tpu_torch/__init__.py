"""uspmv_tpu_torch — Ultimate-SpMV on PyTorch and CUDA.

The port of the ``uspmv_tpu`` JAX package to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (H100). It computes y = A x and Y = A X
(block vectors) in the SELL-C-sigma format of RRZE-HPC/Ultimate-SpMV, in
dp, sp, hp or an adaptive dp/sp/hp split of A's nonzeros, on one device
or split by rows into R shards on it or over several processes and cards,
each with its own halo of remote x rows that an exchange kernel (and,
between processes, a pack, a transfer and an unpack) fills before the
rows that read it run;
rows far longer than the mean are split into pieces that a second kernel
sums and folds back, and a layout that would be mostly padding runs as
packed row groups instead. The JAX package remains the reference it is
tested against. Host
structures (COO, SCS arrays, permutations) are numpy and bit-equal to the
JAX package's; device data are torch tensors on an explicit device.

Precision naming follows the reference (classes_structs.hpp:47-153):
  dp = float64, sp = float32, hp = bfloat16 values with float32 vectors.

This package never imports jax.
"""

__version__ = "0.1.0"

from .config import Config, DefaultValues, PRECISION_DTYPES, dtype_for
from .formats.coo import (
    MtxData,
    apply_permutation,
    apply_strided_permutation,
    equilibrate_matrix,
    extract_largest_col_elems,
    extract_largest_row_elems,
    split_heavy_rows,
)
from .formats.scs import (
    ScsData,
    convert_to_scs,
    permute_scs_cols,
    scs_from_reference,
)
from .io.mmio import read_mtx, write_mtx
from .ops.halo_exchange import halo_exchange, halo_exchange_plain
from .ops.scs_packed import spmv_packed, spmv_packed_plain
from .ops.scs_pieces import spmv_pieces, spmv_pieces_plain
from .ops.scs_solve import solve_scs, solve_scs_plain
from .ops.scs_spmv import launch_count, spmv_scs, spmv_scs_plain
from .precision.partition import ap_threshold_from_norm, partition_precisions
from .runtime.operator import DeviceUnavailableError, SpmvOperator
from .parallel.distributed import DistributedSpmvOperator

__all__ = [
    "Config",
    "DefaultValues",
    "PRECISION_DTYPES",
    "dtype_for",
    "MtxData",
    "apply_permutation",
    "apply_strided_permutation",
    "equilibrate_matrix",
    "extract_largest_col_elems",
    "extract_largest_row_elems",
    "split_heavy_rows",
    "ScsData",
    "convert_to_scs",
    "permute_scs_cols",
    "scs_from_reference",
    "read_mtx",
    "write_mtx",
    "launch_count",
    "spmv_scs",
    "spmv_scs_plain",
    "spmv_packed",
    "spmv_packed_plain",
    "spmv_pieces",
    "spmv_pieces_plain",
    "solve_scs",
    "solve_scs_plain",
    "partition_precisions",
    "ap_threshold_from_norm",
    "DeviceUnavailableError",
    "SpmvOperator",
    "DistributedSpmvOperator",
    "halo_exchange",
    "halo_exchange_plain",
]
