"""The counters of the program under test, read in its process after the
run: ``snapshot()["counters"]`` of ``uspmv_tpu_torch.runtime.profiling``,
which the program books whether its spans are on or not (kernel launches,
the bytes its builds placed on the device). A program whose profiling
module has no ``snapshot`` (an older version), or a process that never
loaded it, reads None, never an error."""

from __future__ import annotations

import sys
from typing import Optional

PROFILING = "uspmv_tpu_torch.runtime.profiling"


def counter(name: str) -> Optional[int]:
    """The program's counter ``name`` in this process; None where the
    program keeps no such counter or has booked nothing to it."""
    snapshot = getattr(sys.modules.get(PROFILING), "snapshot", None)
    if snapshot is None:
        return None
    return snapshot().get("counters", {}).get(name)
