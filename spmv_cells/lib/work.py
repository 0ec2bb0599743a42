"""The work of one SpMV, from the matrix and the cell alone, and the card's
peak rate: the yardstick of the roofline metrics.

The byte count never reads the program's own counts (``bytes_per_spmv``,
``stream_bytes`` and the like change with its format): per SpMV, each
nonzero's value and a 4-byte column, x read once and y written once. The
peak table is a frozen copy of the rows of ``uspmv_tpu_torch/runtime/
card.py`` at commit 49643eb (NVIDIA data-sheet HBM rates at the full power
limit), without its CPU row: a CPU has no roofline here.
"""

from __future__ import annotations

from typing import Optional

VALUE_BYTES = {"dp": 8, "sp": 4, "hp": 2}
# x and y are held in the working type: hp's bf16 values take f32 vectors
VECTOR_BYTES = {"dp": 8, "sp": 4, "hp": 4}
COLUMN_BYTES = 4

# (substring of the device name, HBM bytes/s), matched in this order,
# case folded: the NVL and PCIe parts before the bare "H100" of the SXM5
# part ("NVIDIA H100 80GB HBM3")
HBM_BYTES_PER_S = (
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),
)


def hbm_bytes_per_s(name: str) -> Optional[float]:
    """The data-sheet HBM rate of the card named ``name``; None for a card
    the table does not know."""
    name = name.lower()
    for key, rate in HBM_BYTES_PER_S:
        if key.lower() in name:
            return rate
    return None


def flops_per_spmv(nnz: int, bs: int) -> int:
    """Useful flops of one y = A x over bs vectors (reference
    main.cpp:521-526)."""
    return 2 * nnz * bs


def bytes_per_spmv(nnz: int, n_rows: int, n_cols: int, value_type: str,
                   bs: int) -> int:
    """Bytes one y = A x must move at the least: the matrix once, x read
    once, y written once."""
    xb = VECTOR_BYTES[value_type]
    return (nnz * (VALUE_BYTES[value_type] + COLUMN_BYTES)
            + n_cols * bs * xb + n_rows * bs * xb)
