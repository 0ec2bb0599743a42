"""Entry points of the port's probes and benchmark sweeps, named after the
JAX package's scripts/ so that each counterpart is easy to find; run each
as ``python -m uspmv_tpu_torch.scripts.<name>``:

    gather_probe  test_gather1d.py, test_gather2d.py, test_gather_tput.py
    microbench    microbench.py
    tile_cost     pallas_tile_cost.py
    perf_sweep    perf_sweep.py
    ap_bench      ap_bench.py
    check_dp_emu  check_dp_emu.py
    solve_diag    solve_diag.py
    validate_campaign  validate_campaign.py (--multihost: 2-process runs)

Each takes ``--backend cuda|cpu`` (default cuda, which raises
DeviceUnavailableError without a GPU) and appends its JSON rows to
``--out``, by default a file under ``build/uspmv_tpu_torch/``. Two run on
the host only and write an image (by default under the same directory):

    value_histogram   value_histogram.py
    sparsity_pattern  sparsity_pattern.py

One more has no JAX counterpart and runs on a GPU only:

    kernel_ab     two or more source trees of the SELL-C-sigma, packed and
                  solve kernels (a parent commit's and a change's), timed
                  in turns on the same inputs
"""
