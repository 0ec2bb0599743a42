"""Adaptive-precision partitioning (port of ``uspmv_tpu/precision``)."""
