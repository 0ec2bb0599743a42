"""What the port knows of the card it measures on: its name and power limit
as ``nvidia-smi`` reports them, and its HBM rate for rooflines.

A card whose name the table does not know has no rate: ``hbm_bytes_per_s``
returns None rather than guess one (``bench.py``'s TPU table falls back
to 819 GB/s; a bound or a ``vs_baseline`` on a guessed rate would look
like a measurement of a card it is not)."""

from __future__ import annotations

import subprocess
from typing import Optional

# (substring of the device name, HBM bytes/s), matched in this order, case
# folded: the NVL and PCIe parts before the bare "H100" of the SXM5 part
# (e.g. "NVIDIA H100 80GB HBM3"). Data-sheet rates at the full power limit.
# "cpu" is bench.py's own CPU row, used only when the caller asks for the
# CPU.
HBM_BYTES_PER_S = (
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),
    ("cpu", 50.0e9),
)


def hbm_bytes_per_s(name: str) -> Optional[float]:
    """The HBM rate of the device named ``name``
    (``torch.cuda.get_device_name``, or "cpu"); None for a card the table
    does not know."""
    name = name.lower()
    for key, rate in HBM_BYTES_PER_S:
        if key.lower() in name:
            return rate
    return None


def device_name(device) -> str:
    """``torch.cuda.get_device_name`` of a CUDA ``device``, else "cpu"."""
    if device.type == "cuda":
        import torch

        return torch.cuda.get_device_name(device)
    return "cpu"


def card_name_and_power_limit() -> str:
    """The first card's ``name, power.limit`` as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints it; raises where nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]
