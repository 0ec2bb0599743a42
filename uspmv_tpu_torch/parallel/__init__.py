"""Row-sharded execution: partitioning, halo plans, the sharded operator."""

from .halo import HaloPlan, build_halo_plan
from .partition import seg_work_sharing
