"""The benchmark of uspmv_tpu_torch: cells driven by data (see run.py)."""
