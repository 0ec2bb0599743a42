#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (uspmv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA device, nvcc and
nvidia-smi. Phases, each printing one JSON line:

  1. environment: torch, CUDA, nvcc, and the card's name and power limit;
  2. build: nvcc compiles uspmv_tpu_torch/csrc/*.cu for sm_90a;
  3. kernel vs plain: the CUDA kernel against its plain PyTorch version
     on Laplace3D-32 at (C, sigma) in {(1024, 1), (32, 512), (1, 1)} and
     RandomBanded-200k at (1024, 1), sp and dp, with the launch count
     checked per call;
  4. headline: Laplace3D-128, SELL-C-sigma C=1024 sigma=1 sp, through
     SpmvOperator.from_mtx, solve (5 repetitions, validated against the
     scipy f64 oracle) and bench_spmv; the launch count over this run shows
     that the timed loop ran the hand-written kernel; then the kernel and
     the plain version are compared and timed on the same tensors;
  5. large x: Laplace3D-160 (x = 16.4 MB, above the TPU kernel's 12 MB
     VMEM budget), kernel vs plain and one validated solve.

Tolerances: max|kernel - plain| / max|plain| <= 1e-5 (sp) and 1e-12 (dp);
the plain version's index_add_ sums in another order, and the kernel
contracts to FMAs. Any failed check raises and the script exits non-zero.
The next-to-last lines are the kernel record and nvidia-smi's
``name, power.limit``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs no network and imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

TOL = {"sp": 1e-5, "dp": 1e-12}
KERNEL_SOURCE = "uspmv_tpu_torch/csrc/scs_spmv.cu"
REPLACES = "uspmv_tpu/ops/pallas_scs.py:820"  # _kernel
ALSO_REPLACES = "uspmv_tpu/ops/pallas_scs.py:1478"  # _kernel_windowed


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_name_and_power_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps):
    """Mean milliseconds per call of fn over reps calls, CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(dev, x, tol, what):
    """One kernel launch against the plain version on the same tensors."""
    import torch

    from uspmv_tpu_torch.ops.scs_spmv import (
        launch_count,
        spmv_scs,
        spmv_scs_plain,
    )

    n0 = launch_count()
    y = spmv_scs(dev, x)
    torch.cuda.synchronize()
    require(launch_count() == n0 + 1, f"{what}: launch not counted")
    y_plain = spmv_scs_plain(dev, x)
    max_abs = (y - y_plain).abs().max().item()
    scale = y_plain.abs().max().item()
    rel = max_abs / scale if scale > 0 else max_abs
    require(torch.isfinite(y).all().item(), f"{what}: non-finite y")
    require(rel <= tol, f"{what}: max|d|/max|y| = {rel:.3e} > {tol:g}")
    return y, max_abs, rel


def vs_scipy(op, mtx, x_host, y, tol, what):
    """max|y - A x| / max|A x| against scipy in f64, with x rounded to the
    operator's precision first so only the accumulation differs."""
    import numpy as np

    xr = x_host.astype(op.scs[op.config.value_type].values.dtype)
    ref = mtx.to_scipy().tocsr() @ xr.astype(np.float64)
    got = op.to_host(y).astype(np.float64)
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    require(rel <= tol, f"{what}: vs scipy {rel:.3e} > {tol:g}")
    return rel


def validated_solve(op, mtx, n_rev, what):
    import numpy as np

    from uspmv_tpu_torch.ops.vectors import init_x_host
    from uspmv_tpu_torch.runtime.validate import validate_solve

    x0 = init_x_host(op.config, op.n_rows, op.matrix_stats, dtype=np.float64)
    _, y = op.solve(op.make_x(x0), n_rev)
    rep = validate_solve(mtx, x0, op.to_host(y), n_rev,
                         value_type=op.config.value_type)
    require(rep.flag == "OK", f"{what}: validation {rep.summary()}")
    return rep


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.io.generators import laplace3d, random_banded
    from uspmv_tpu_torch.ops import _build
    from uspmv_tpu_torch.ops.scs_spmv import (
        launch_count,
        reset_launch_count,
        spmv_scs,
        spmv_scs_plain,
    )
    from uspmv_tpu_torch.runtime.bench import bench_spmv

    t_start = time.perf_counter()
    card = card_name_and_power_limit()
    kind = torch.cuda.get_device_name(0)
    nvcc = _build.find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc_version, device=kind,
         device_count=torch.cuda.device_count(), card=card)

    lib = _build.load_library()
    emit("build", seconds=lib.build_seconds, built=lib.built,
         library=str(lib.path),
         ptxas=[ln.strip() for ln in lib.log.splitlines()
                if "registers" in ln or "Compiling entry" in ln])

    rng = np.random.default_rng(0)

    def operator(mtx, C, sigma, prec):
        cfg = Config(kernel_format="scs", chunk_size=C, sigma=sigma,
                     value_type=prec, backend="cuda")
        return SpmvOperator.from_mtx(cfg, mtx)

    # ---- 3. kernel vs plain on small shapes
    cases = [("Laplace3D,32", laplace3d(32), C, s)
             for C, s in ((1024, 1), (32, 512), (1, 1))]
    cases.append(("RandomBanded,200000,60,11",
                  random_banded(200_000, 60, 11), 1024, 1))
    n_calls = 0
    n0 = launch_count()
    for name, mtx, C, sigma in cases:
        x_host = rng.standard_normal(mtx.n_rows)
        for prec in ("sp", "dp"):
            op = operator(mtx, C, sigma, prec)
            (dev,) = op.devs.values()
            y, max_abs, rel = kernel_vs_plain(
                dev, op.make_x(x_host), TOL[prec], f"{name} C={C} s={sigma} {prec}"
            )
            n_calls += 1
            emit("kernel_vs_plain", matrix=name, C=C, sigma=sigma,
                 value_type=prec, max_abs_err=max_abs, rel_err=rel,
                 tol=TOL[prec])
    require(launch_count() - n0 == n_calls,
            f"launch count rose by {launch_count() - n0}, expected {n_calls}")

    # ---- 4. headline: the main path, as a user drives it
    mtx = laplace3d(128)
    cfg = Config(kernel_format="scs", chunk_size=1024, sigma=1,
                 value_type="sp", backend="cuda")
    reset_launch_count()
    t0 = time.perf_counter()
    op = SpmvOperator.from_mtx(cfg, mtx)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(op.impl_name() == "cuda-scs", f"impl {op.impl_name()}")
    rep = validated_solve(op, mtx, 5, "headline solve")
    n_before_bench = launch_count()
    res = bench_spmv(op, bench_time=2.0)
    bench_launches = launch_count() - n_before_bench
    main_launches = launch_count()
    require(bench_launches >= res.n_iterations,
            f"bench launched the kernel {bench_launches} times for "
            f"{res.n_iterations} timed iterations")
    require(np.isfinite(res.perf_gflops) and res.perf_gflops > 0,
            f"GFLOP/s {res.perf_gflops}")

    (dev,) = op.devs.values()
    x_host = rng.standard_normal(mtx.n_rows)
    x = op.make_x(x_host)
    y, max_abs, rel = kernel_vs_plain(dev, x, TOL["sp"], "headline")
    rel_scipy = vs_scipy(op, mtx, x_host, y, TOL["sp"], "headline")
    # alternate plain, kernel, kernel, plain on the same tensors
    reps = 200
    t_plain = [time_ms(lambda: spmv_scs_plain(dev, x), reps)]
    t_kern = [time_ms(lambda: spmv_scs(dev, x), reps) for _ in range(2)]
    t_plain.append(time_ms(lambda: spmv_scs_plain(dev, x), reps))
    ms, plain_ms = float(np.median(t_kern)), float(np.median(t_plain))
    flops, nbytes = op.flops_per_spmv(), op.bytes_per_spmv()
    emit("headline", matrix="Laplace3D,128", C=1024, sigma=1,
         value_type="sp", n_rows=op.n_rows, nnz=op.nnz,
         n_elements=dev.n_elements, beta=op.beta()["sp"],
         operator_build_s=build_s, validation=rep.summary(),
         gflops=res.perf_gflops, gbps=res.effective_gbps,
         n_iterations=res.n_iterations, bench_launches=bench_launches,
         main_path_launches=main_launches,
         timing_samples_s=res.timing_samples_s,
         kernel_ms=ms, kernel_gflops=flops / ms / 1e6,
         kernel_gbps=nbytes / ms / 1e6,
         plain_ms=plain_ms, plain_gflops=flops / plain_ms / 1e6,
         plain_gbps=nbytes / plain_ms / 1e6,
         kernel_samples_ms=t_kern, plain_samples_ms=t_plain,
         bytes_per_spmv=nbytes, max_abs_err=max_abs, rel_err=rel,
         rel_err_vs_scipy=rel_scipy, card=card)
    headline = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
    del op, dev, x, y
    torch.cuda.empty_cache()

    # ---- 5. large x (on the TPU: the windowed kernel's regime)
    mtx = laplace3d(160)
    op = SpmvOperator.from_mtx(cfg, mtx)
    (dev,) = op.devs.values()
    x_host = rng.standard_normal(mtx.n_rows)
    y, max_abs, rel = kernel_vs_plain(dev, op.make_x(x_host), TOL["sp"],
                                      "large x")
    rel_scipy = vs_scipy(op, mtx, x_host, y, TOL["sp"], "large x")
    rep = validated_solve(op, mtx, 1, "large-x solve")
    emit("large_x", matrix="Laplace3D,160", n_rows=op.n_rows, nnz=op.nnz,
         x_bytes=op.n_rows_padded * 4, max_abs_err=max_abs, rel_err=rel,
         rel_err_vs_scipy=rel_scipy, validation=rep.summary(),
         seconds_total=time.perf_counter() - t_start)

    print(json.dumps({"kernels": [{
        "name": "scs_spmv", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "also_replaces": ALSO_REPLACES,
        "launches": main_launches, **headline,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
