#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (uspmv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA device, nvcc and
nvidia-smi. Phases, each printing JSON lines:

  1. environment: torch, CUDA, nvcc, and the card's name and power limit;
  2. build: nvcc compiles uspmv_tpu_torch/csrc/*.cu for sm_90a;
  3. kernel vs plain, small shapes:
     a. the sp and dp operators on Laplace3D-32 at (C, sigma) in
        {(1024, 1), (32, 512), (1, 1)} and RandomBanded-200k at (1024, 1);
     b. every instantiated (values, x) dtype pair of the kernel, one vector
        and bs in {4, 8} rowwise and colwise, each plain and in the
        accumulate form y += A x, on Laplace3D-32 and RandomBanded-200k;
     with the launch count checked per call;
  4. headline: Laplace3D-128, SELL-C-sigma C=1024 sigma=1 sp, through
     SpmvOperator.from_mtx, solve (5 repetitions, validated against the
     scipy f64 oracle) and bench_spmv; then the kernel and the plain
     version are compared and timed on the same tensors;
  5. large x: Laplace3D-160 (x = 16.4 MB), kernel vs plain and one
     validated solve;
  6. the paths of slice 2, each driven as a user would (from_mtx, a solve
     of 5 repetitions validated OK, bench_spmv for 2 s) with the launch
     counts set to 0 before and read after, then the whole SpMV and each
     precision stream compared and timed against the plain version:
       A  Laplace3D-128  ap[dp_sp] -dp_emu, ap_threshold_1 = 2.44
       B  Laplace3D-128  ap[sp_hp], ap_threshold_1 = 2.44
       C  Laplace3D-128  hp
       D  Laplace3D-128  sp, block vectors bs=8 and bs=4 rowwise, bs=8
          colwise
       E  WideSpectrum-55  ap[dp_sp_hp] -dp_emu, thresholds 1e-2 / 1e-5
          (all three streams must be non-empty)
     all at C=1024, sigma=1.

Tolerances, max|kernel - plain| / max|plain|: 1e-5 where the sums are in
f32 (sp, hp, ap[sp_hp]) and 1e-12 where they are in f64 (dp and every
ap[dp_*] stream); the plain version's index_add_ sums in another order,
and the kernel contracts to FMAs. Any failed check raises and the script
exits non-zero. The next-to-last lines are the kernel record (one entry
per instantiation, timed on the stream of its path) and nvidia-smi's
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
PALLAS = "uspmv_tpu/ops/pallas_scs.py"
# instantiation -> (the TPU kernels it replaces, its timing: path, stream).
# `_kernel` :820 and `_kernel_windowed` :1478 read f32 or bf16 values;
# `_kernel_df64` :761 and `_kernel_df64_windowed` :1579 are the dp stream
# under -dp_emu (windowed once x exceeds 12 MB, as path A's f64 x does).
INSTANTIATIONS = {
    "uspmv_scs_spmv_f32_f32": ((":820", ":1478"), "headline", "sp"),
    "uspmv_scs_spmv_f64_f64": ((":1579", ":761"), "A", "dp"),
    "uspmv_scs_spmv_f32_f64": ((":820", ":1478"), "A", "sp"),
    "uspmv_scs_spmv_bf16_f32": ((":820", ":1478"), "C", "hp"),
    "uspmv_scs_spmv_bf16_f64": ((":820", ":1478"), "E", "hp"),
}
PATHS = [
    ("A", "Laplace3D,128", dict(value_type="ap[dp_sp]", dp_emulation=True,
                                ap_threshold_1=2.44)),
    ("B", "Laplace3D,128", dict(value_type="ap[sp_hp]",
                                ap_threshold_1=2.44)),
    ("C", "Laplace3D,128", dict(value_type="hp")),
    ("D-rowwise-8", "Laplace3D,128", dict(value_type="sp", block_vec_size=8,
                                          vector_layout="rowwise")),
    ("D-rowwise-4", "Laplace3D,128", dict(value_type="sp", block_vec_size=4,
                                          vector_layout="rowwise")),
    ("D-colwise-8", "Laplace3D,128", dict(value_type="sp", block_vec_size=8,
                                          vector_layout="colwise")),
    ("E", "WideSpectrum,55", dict(value_type="ap[dp_sp_hp]",
                                  dp_emulation=True, ap_threshold_1=1e-2,
                                  ap_threshold_2=1e-5)),
]
# (layout, bs) of the small-shape checks; bs=1 is one vector [n_pad]
SHAPES = [("rowwise", 1), ("rowwise", 4), ("rowwise", 8), ("colwise", 4),
          ("colwise", 8)]


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


def acc_tol(x):
    """Tolerance by the accumulator (x) dtype."""
    import torch

    return TOL["dp"] if x.dtype == torch.float64 else TOL["sp"]


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


def time_pair(kernel, plain, reps=100):
    """(kernel ms, plain ms, samples) in the order plain, kernel, kernel,
    plain on the same tensors; each is the median of its two runs."""
    import numpy as np

    t_plain = [time_ms(plain, reps)]
    t_kern = [time_ms(kernel, reps) for _ in range(2)]
    t_plain.append(time_ms(plain, reps))
    return (float(np.median(t_kern)), float(np.median(t_plain)),
            dict(kernel_samples_ms=t_kern, plain_samples_ms=t_plain))


def compare(y, y_plain, tol, what):
    import torch

    max_abs = (y - y_plain).abs().max().item()
    scale = y_plain.abs().max().item()
    rel = max_abs / scale if scale > 0 else max_abs
    require(torch.isfinite(y).all().item(), f"{what}: non-finite y")
    require(rel <= tol, f"{what}: max|d|/max|y| = {rel:.3e} > {tol:g}")
    return max_abs, rel


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
    max_abs, rel = compare(y, spmv_scs_plain(dev, x), tol, what)
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
                         value_type=op.config.value_type,
                         hp_nnz_fraction=op.hp_nnz_fraction())
    require(rep.flag == "OK", f"{what}: validation {rep.summary()}")
    return rep


def plain_spmv(op, x):
    """op.spmv with every stream through the plain version, in op.spmv's
    order: the first writes y, the rest add into it."""
    from uspmv_tpu_torch.ops.scs_spmv import spmv_scs_plain

    y = None
    for dev in op.devs.values():
        y = spmv_scs_plain(dev, x, op.config.vector_layout, y)
    return y


def small_shapes(cuda, rng_seed=0):
    """Phase 3b: every instantiation, layout and the accumulate form."""
    import numpy as np
    import torch

    from uspmv_tpu_torch.formats.scs import convert_to_scs, permute_scs_cols
    from uspmv_tpu_torch.io.generators import laplace3d, random_banded
    from uspmv_tpu_torch.ops import scs_spmv
    from uspmv_tpu_torch.ops.device_format import build_device_scs

    gen = torch.Generator().manual_seed(rng_seed)
    for name, mtx in (("Laplace3D,32", laplace3d(32)),
                      ("RandomBanded,200000,60,11",
                       random_banded(200_000, 60, 11))):
        scs = convert_to_scs(mtx, 1024, 1)
        perm = np.arange(scs.n_rows_padded, dtype=np.int32)
        perm[: scs.n_rows] = scs.old_to_new_idx
        permute_scs_cols(scs, perm)
        for (vdt, xdt), entry in scs_spmv._ENTRY_POINTS.items():
            dev = build_device_scs(scs, cuda, vdt)
            n = dev.n_rows_padded
            worst = {}
            for layout, bs in SHAPES:
                shape = ((n,) if bs == 1 else
                         (n, bs) if layout == "rowwise" else (bs, n))
                x = torch.randn(shape, generator=gen,
                                dtype=torch.float64).to(xdt).to(cuda)
                y0 = torch.randn(shape, generator=gen,
                                 dtype=torch.float64).to(xdt).to(cuda)
                for acc in (False, True):
                    what = f"{name} {entry} {layout} bs={bs} acc={acc}"
                    n0 = scs_spmv.launch_counts()[entry]
                    y = scs_spmv.spmv_scs(dev, x, layout,
                                          y0.clone() if acc else None)
                    torch.cuda.synchronize()
                    require(scs_spmv.launch_counts()[entry] == n0 + 1,
                            f"{what}: launch not counted")
                    ref = scs_spmv.spmv_scs_plain(
                        dev, x, layout, y0.clone() if acc else None)
                    require(tuple(y.shape) == shape, f"{what}: shape")
                    _, rel = compare(y, ref, acc_tol(x), what)
                    key = f"{layout}-{bs}{'-acc' if acc else ''}"
                    worst[key] = rel
            emit("kernel_vs_plain_pairs", matrix=name, C=1024, sigma=1,
                 entry=entry, values=str(vdt), x=str(xdt),
                 rel_err=worst, tol=acc_tol(x))
            del dev


def run_path(name, spec, mtx, fields, rng):
    """Phase 6: one path of slice 2, as a user drives it."""
    import numpy as np
    import torch

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.ops.scs_spmv import (
        entry_point,
        launch_count,
        launch_counts,
        reset_launch_count,
        spmv_scs,
        spmv_scs_plain,
    )
    from uspmv_tpu_torch.runtime.bench import bench_spmv

    cfg = Config(kernel_format="scs", chunk_size=1024, sigma=1,
                 backend="cuda", **fields)
    reset_launch_count()
    t0 = time.perf_counter()
    op = SpmvOperator.from_mtx(cfg, mtx)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(op.impl_name() == f"cuda-scs-{cfg.value_type}",
            f"{name}: impl {op.impl_name()}")
    npp = op.nnz_per_precision()
    require(list(npp) == list(cfg.ap_precisions) and min(npp.values()) > 0,
            f"{name}: empty precision stream {npp}")
    rep = validated_solve(op, mtx, 5, f"path {name} solve")
    n_before = launch_count()
    res = bench_spmv(op, bench_time=2.0)
    bench_launches = launch_count() - n_before
    counts = launch_counts()  # the main path's launches, per instantiation
    streams = len(op.devs)
    require(bench_launches >= res.n_iterations * streams,
            f"{name}: {bench_launches} launches for {res.n_iterations} "
            f"timed iterations of {streams} streams")
    require(np.isfinite(res.perf_gflops) and res.perf_gflops > 0,
            f"{name}: GFLOP/s {res.perf_gflops}")
    wd = op.working_dtype
    for dev in op.devs.values():
        entry = entry_point(dev.values.dtype, wd)
        require(counts[entry] > 0, f"{name}: {entry} never launched")

    bs = cfg.block_vec_size
    x = op.make_x(rng.standard_normal((op.n_rows, bs) if bs > 1
                                      else op.n_rows))
    y = op.spmv(x)
    torch.cuda.synchronize()
    max_abs, rel = compare(y, plain_spmv(op, x), acc_tol(x), name)
    ms, plain_ms, samples = time_pair(lambda: op.spmv(x),
                                      lambda: plain_spmv(op, x))
    flops, nbytes = op.flops_per_spmv(), op.bytes_per_spmv()
    layout = cfg.vector_layout
    stream_rec = {}
    for p, dev in op.devs.items():
        s_ms, s_plain_ms, _ = time_pair(
            lambda: spmv_scs(dev, x, layout),
            lambda: spmv_scs_plain(dev, x, layout))
        s_abs, s_rel = compare(spmv_scs(dev, x, layout),
                               spmv_scs_plain(dev, x, layout), acc_tol(x),
                               f"{name} {p} stream")
        s_bytes = (op.matrix_passes() * dev.stream_bytes()
                   + 2 * op.n_rows_padded * bs * x.element_size())
        stream_rec[p] = dict(
            entry=entry_point(dev.values.dtype, wd), nnz=dev.nnz,
            n_elements=dev.n_elements, ms=s_ms, plain_ms=s_plain_ms,
            gbps=s_bytes / s_ms / 1e6, plain_gbps=s_bytes / s_plain_ms / 1e6,
            max_abs_err=s_abs, rel_err=s_rel)
    emit("path", path=name, matrix=spec, C=1024, sigma=1,
         config={k: v for k, v in fields.items()}, impl=op.impl_name(),
         n_rows=op.n_rows, nnz=op.nnz, nnz_per_precision=npp,
         beta=op.beta(), n_dropped=op.n_dropped, operator_build_s=build_s,
         validation=rep.summary(), gflops=res.perf_gflops,
         gbps=res.effective_gbps, n_iterations=res.n_iterations,
         timing_samples_s=res.timing_samples_s,
         bench_launches=bench_launches, main_path_launches=counts,
         kernel_ms=ms, kernel_gflops=flops / ms / 1e6,
         kernel_gbps=nbytes / ms / 1e6, plain_ms=plain_ms,
         plain_gflops=flops / plain_ms / 1e6,
         plain_gbps=nbytes / plain_ms / 1e6, **samples,
         bytes_per_spmv=nbytes, max_abs_err=max_abs, rel_err=rel,
         streams=stream_rec)
    return counts, stream_rec


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.io.generators import (
        generate_matrix,
        laplace3d,
        random_banded,
    )
    from uspmv_tpu_torch.ops import _build
    from uspmv_tpu_torch.ops.scs_spmv import (
        launch_count,
        launch_counts,
        reset_launch_count,
        spmv_scs,
        spmv_scs_plain,
    )
    from uspmv_tpu_torch.runtime.bench import bench_spmv

    t_start = time.perf_counter()
    card = card_name_and_power_limit()
    kind = torch.cuda.get_device_name(0)
    cuda = torch.device("cuda", 0)
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

    # ---- 3a. the sp/dp operators' kernel vs plain on small shapes
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

    # ---- 3b. every instantiation, layout and the accumulate form
    small_shapes(cuda)

    # ---- 4. headline: the main path, as a user drives it
    mtx = laplace3d(128)
    cfg = Config(kernel_format="scs", chunk_size=1024, sigma=1,
                 value_type="sp", backend="cuda")
    reset_launch_count()
    t0 = time.perf_counter()
    op = SpmvOperator.from_mtx(cfg, mtx)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(op.impl_name() == "cuda-scs-sp", f"impl {op.impl_name()}")
    rep = validated_solve(op, mtx, 5, "headline solve")
    n_before_bench = launch_count()
    res = bench_spmv(op, bench_time=2.0)
    bench_launches = launch_count() - n_before_bench
    main_launches = launch_counts()
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
    ms, plain_ms, samples = time_pair(lambda: spmv_scs(dev, x),
                                      lambda: spmv_scs_plain(dev, x), 200)
    flops, nbytes = op.flops_per_spmv(), op.bytes_per_spmv()
    emit("headline", matrix="Laplace3D,128", C=1024, sigma=1,
         value_type="sp", n_rows=op.n_rows, nnz=op.nnz,
         n_elements=dev.n_elements, beta=op.beta()["sp"],
         operator_build_s=build_s, validation=rep.summary(),
         gflops=res.perf_gflops, gbps=res.effective_gbps,
         n_iterations=res.n_iterations, bench_launches=bench_launches,
         main_path_launches=sum(main_launches.values()),
         timing_samples_s=res.timing_samples_s,
         kernel_ms=ms, kernel_gflops=flops / ms / 1e6,
         kernel_gbps=nbytes / ms / 1e6,
         plain_ms=plain_ms, plain_gflops=flops / plain_ms / 1e6,
         plain_gbps=nbytes / plain_ms / 1e6, **samples,
         bytes_per_spmv=nbytes, max_abs_err=max_abs, rel_err=rel,
         rel_err_vs_scipy=rel_scipy, card=card)
    stream_records = {("headline", "sp"): dict(max_abs_err=max_abs, ms=ms,
                                               plain_ms=plain_ms)}
    del op, dev, x, y
    torch.cuda.empty_cache()

    # ---- 5. large x (on the TPU: the windowed kernel's regime)
    big = laplace3d(160)
    op = SpmvOperator.from_mtx(cfg, big)
    (dev,) = op.devs.values()
    x_host = rng.standard_normal(big.n_rows)
    y, max_abs, rel = kernel_vs_plain(dev, op.make_x(x_host), TOL["sp"],
                                      "large x")
    rel_scipy = vs_scipy(op, big, x_host, y, TOL["sp"], "large x")
    rep = validated_solve(op, big, 1, "large-x solve")
    emit("large_x", matrix="Laplace3D,160", n_rows=op.n_rows, nnz=op.nnz,
         x_bytes=op.n_rows_padded * 4, max_abs_err=max_abs, rel_err=rel,
         rel_err_vs_scipy=rel_scipy, validation=rep.summary())
    del op, dev, y, big
    torch.cuda.empty_cache()

    # ---- 6. the paths of slice 2
    matrices = {"Laplace3D,128": mtx}
    for name, spec, fields in PATHS:
        if spec not in matrices:
            t0 = time.perf_counter()
            matrices[spec] = generate_matrix(spec)
            emit("generate", matrix=spec, n_rows=matrices[spec].n_rows,
                 nnz=matrices[spec].nnz, seconds=time.perf_counter() - t0)
        counts, streams = run_path(name, spec, matrices[spec], fields, rng)
        for entry, n in counts.items():
            main_launches[entry] += n
        for p, rec in streams.items():
            stream_records[(name, p)] = rec
        torch.cuda.empty_cache()

    kernels = []
    for entry, (replaces, path, prec) in INSTANTIATIONS.items():
        rec = stream_records[(path, prec)]
        require(main_launches[entry] > 0, f"{entry} never launched")
        kernels.append({
            "name": entry.replace("uspmv_", ""), "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": PALLAS + replaces[0],
            "also_replaces": [PALLAS + r for r in replaces[1:]],
            "launches": main_launches[entry],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "timed_on": f"path {path}, {prec} stream",
        })
    emit("done", seconds_total=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
