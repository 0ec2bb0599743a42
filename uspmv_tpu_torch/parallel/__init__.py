"""Row-sharded execution: partitioning, halo plans, the sharded operator,
and its processes (multihost)."""

from .halo import HaloPlan, build_halo_plan
from .partition import seg_work_sharing
