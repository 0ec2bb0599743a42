"""Entry points of the port's probes and benchmark sweeps, named after the
JAX package's scripts/ so that each counterpart is easy to find; run each
as ``python -m uspmv_tpu_torch.scripts.<name>``:

    gather_probe  test_gather1d.py, test_gather2d.py, test_gather_tput.py
    microbench    microbench.py
    tile_cost     pallas_tile_cost.py
    perf_sweep    perf_sweep.py
    ap_bench      ap_bench.py

Each takes ``--backend cuda|cpu`` (default cuda, which raises
DeviceUnavailableError without a GPU) and appends its JSON rows to
``--out``, by default a file under ``build/uspmv_tpu_torch/``.
"""
