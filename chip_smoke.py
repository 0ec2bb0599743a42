#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (uspmv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA device, nvcc and
nvidia-smi. Phases, each printing JSON lines:

  1. environment: torch, CUDA, nvcc, and the card's name and power limit;
  2. build: nvcc compiles uspmv_tpu_torch/csrc/*.cu for sm_90a; the
     registers and local memory of the row-sum kernels (cuobjdump);
  3. kernel vs plain, small shapes:
     a. the sp and dp operators on Laplace3D-32 at (C, sigma) in
        {(1024, 1), (32, 512), (1, 1)} and RandomBanded-200k at (1024, 1);
     b. every instantiated (values, x) dtype pair of the kernel, one vector
        and bs in {4, 8} rowwise and colwise, each plain and in the
        accumulate form y += A x, on Laplace3D-32 and RandomBanded-200k;
     c. the heavy-row pieces and packed-row kernels (slice 5) through
        operators on a 4,600-row imbalanced matrix at C=32, sigma=64 (one
        row of 3,000+ elements, 600 empty rows at the end: whole row groups
        without elements): sp, dp, hp and ap[dp_sp_hp] (all five dtype
        pairs of the pieces, all three of the packed rows), split
        thresholds 2 (a row with more pieces than a warp has lanes), 32
        and 1024, one vector, rowwise and colwise bs=4, the write and the
        accumulate form; each kernel against its plain version, and twice
        in a row bit-equal (the pieces' counters and slots back at 0);
     with the launch count checked per call;
  4. headline: Laplace3D-128, SELL-C-sigma C=1024 sigma=1 sp, through
     SpmvOperator.from_mtx, solve (5 repetitions, validated against the
     scipy f64 oracle) and bench_spmv; then the kernel and the plain
     version are compared, and the kernel, the plain version and cuSPARSE
     timed in turns (plain, kernel, library, library, kernel, plain) on the
     same tensors, with each one's spread and the kernel's launch geometry
     (blocks resident per SM, grid);
  5. large x: Laplace3D-160 (x = 16.4 MB), kernel vs plain, one validated
     solve, and the kernel's time beside its bound and cuSPARSE's, timed
     in turns as in 4;
  6. the paths of slice 2, each driven as a user would (from_mtx, a solve
     of 5 repetitions validated OK, bench_spmv for 1 s) with the launch
     counts set to 0 before and read after, then the whole SpMV and each
     precision stream compared and timed against the plain version:
       A  Laplace3D-128  ap[dp_sp] -dp_emu, ap_threshold_1 = 2.44
       B  Laplace3D-128  ap[sp_hp], ap_threshold_1 = 2.44
       C  Laplace3D-128  hp
       D  Laplace3D-128  sp, block vectors bs=8 and bs=4 rowwise, bs=8
          colwise
       E  WideSpectrum-55  ap[dp_sp_hp] -dp_emu, thresholds 1e-2 / 1e-5
          (all three streams must be non-empty)
     all at C=1024, sigma=1;
  7. solve mode (slice 4). Matrices are value-scaled so the row sums of |A|
     are <= 1 and the iterates of x <- A x stay finite:
     a. small shapes: the fused solve kernel (csrc/scs_solve.cu) on
        Laplace3D-32, RandomBanded-200k and FemTet3D-9 at (C, sigma) in
        {(1024, 1), (32, 512)}, its three dtype pairs, one vector and
        rowwise bs in {4, 8}, k in {1, 2, 5, 64}: bit-equal to k launches
        of the SpMV kernel and within tolerance of its plain version, both
        returned vectors; the CUDA-graph solve bit-equal to the loop of
        launches (sp, dp, hp, an ap[sp_hp] split, colwise bs=4); launch
        counts checked (one launch per fused solve; a graph replay makes no
        launch through the wrapper and is counted apart, as k kernel nodes
        per stream, in runtime/operator.graph_nodes_replayed);
     b. path F, solve at full size through SpmvOperator and bench_solve,
        C=1024 sigma=1 sp, k=512, 1 s per impl: Laplace3D-128, FemTet3D-55
        and the launch-bound FemTet3D-9; impl loop, graph and fused, each
        with a solve of 5 repetitions validated OK and the three results
        bit-equal at k=512 and k=64; ap[dp_sp] -dp_emu through loop and
        graph; and the dp and hp fused solves on Laplace3D-128. Laplace3D's
        solves are validated per element, on the unscaled matrix from the
        configuration's default x (as -rev 5 on the command line).
        FemTet3D's start from a random x (-rand_x 1) on the scaled matrix,
        since its constant vector belongs to the smallest eigenvalue and
        5 repetitions amplify its f32 rounding by ~89^5 at any scale; the
        cases of L2_JUDGED among them are judged on the relative L2 norm.
        Every line prints both flags;
     c. the library surface: interface.prepare / execute_uspmv on
        Laplace3D-128 against scipy, the device-resident loop, and the CG
        example (examples/cg_solver_torch.py) on Laplace3D-128 sp;
  8. path G (slice 5), imbalanced rows at full size: FemTet3D-55,
     BandedImbalanced-500k, PowerLawCols-500k and RandomImbalanced-500k at
     (C, sigma) = (1024, 1) and (32, 512), sp, through
     SpmvOperator.from_mtx three times each: with the defaults ("auto":
     rows split at the automatic threshold, the tier chosen by beta), with
     the other tier forced ("other": mixed_tiles the opposite of what auto
     chose, which locates the cross-over of the two tiers), and with
     split_rows_threshold=-1, mixed_tiles=False ("before": the SELL-C-sigma
     kernel alone, as this path stood before the slice). Each is compared
     with its plain version, with scipy in f64, and run twice bit-equal;
     op.spmv and each of its kernels are timed by replaying a CUDA graph
     (an op.spmv is up to three launches of ~2-30 us each, so events around
     a Python loop would time the host); beside them the bound of the bytes
     each kernel moves, the bound of an ideal CSR, and cuSPARSE's time. The
     auto operator is driven as a user would first (a validated solve of 1
     repetition: per element for FemTet3D-55, on the relative L2 norm for
     the three random-valued matrices named in L2_JUDGED; bench_spmv 0.3 s)
     with the launch counts of all three wrappers set to 0 before and read
     after. FemTet3D-55 is the control: it must stay on cuda-scs. Then
     RandomImbalanced-500k at (1024, 1) as hp, dp, ap[dp_sp], ap[dp_hp]
     and sp with rowwise bs=4, and a CUDA-graph solve of k=64 bit-equal to
     the loop. In the driven runs each kernel and cuSPARSE on its
     sub-matrix are timed in turns (kernel, library, library, kernel), as
     are op.spmv and cuSPARSE on the whole matrix; each packed stream
     carries its launch geometry, and each packed and pieces stream its
     random-gather floor: the x-access probes gathering x at the stream's
     own columns.
     Kernel vs plain tolerance there:
     max(1e-5, 4 eps_f32 sqrt(longest row)), since a row of 10^5 products
     summed in f32 in two orders differs by more than 1e-5;
  9. the last TPU kernels (slice 6), through the port's probe and sweep
     entry points (uspmv_tpu_torch/scripts/), each driven with the launch
     counts set to 0 before and read after:
     a. gather_probe: the x-access kernels (csrc/x_access.cu) on the shape
        table of the TPU gather probes, their throughput runs and the sweep
        of gather_store and gather_fma over 2^24 elements with random,
        banded and strided indices into x of 2.1, 8.4, 16.4 and 67 MB, each
        point against its plain version, its byte bound and microbench's
        take_1d / take_mul (index_select) on the same indices;
     b. tile_cost on the headline Laplace3D-128 (C=1024, sigma=1, sp): the
        cost variants of the SELL row loop (csrc/scs_probe.cu), each held
        against its plain version at that size with every row stored
        (no_store and bare at the threshold -inf, then timed at +inf),
        ``full`` (spmv_scs's own kernel) bit-equal to spmv_scs, and the
        unit-value stream on the matrix's all-ones pattern against its
        plain version and against spmv_scs on the pattern with explicit
        ones; cuSPARSE beside full and the unit stream, on tile_cost's own
        operator and unit stream;
     c. perf_sweep --bs_only on Laplace3D-128 (bs 1, 4, 8, 16, 32), the
        script's default sweep on Laplace3D-64, and ap_bench on
        Laplace3D-128, with short bench times, every row emitted;
 10. row-sharded execution (slice 9): DistributedSpmvOperator, R shards on
     the one card, the halo exchange kernel (csrc/halo_exchange.cu). Each
     driven run (from_mtx, a validated solve, bench_spmv 0.3 s) sets every
     launch count to 0 before and reads it after, and needs the exchange
     and a row kernel to have launched:
     a. Laplace3D-128 sp (C=1024, sigma=1, seg-rows, bulkvec, overlap on)
        at R=4 and R=8: y against the plain version of every launch and
        against the single-device operator, the comm volume against the
        partitioner's own count (at R=4 exactly 98,304 real and 131,072
        padded halo rows), the sharded SpMV and the single-device one
        timed by replayed CUDA graphs in turns; at R=4 also overlap off
        against on, the exchange kernel alone (bit-equal to its plain
        version; kernel, plain and index_select + index_copy_ timed by
        graphs in turns), comm_halos=0 (y must be wrong), a k=64 graph
        solve against the single-device one (us per iteration),
        ap[dp_sp] (the f64 exchange), rowwise and colwise bs=4 (against
        the one-vector operator column by column) and allgather;
     b. RandomImbalanced-500k, R=4, seg-nnz: packed rows and pieces per
        shard, against the plain version and the single-device operator
        (the solve judged on the relative L2 norm), timed as in a;
     c. the CLI in two processes: -n_shards 4 solve mode on Laplace3D-128
        (validated OK) and bench mode with -print_comm_vol on Laplace3D-64,
        which run beside d;
     d. seg-metis against seg-nnz on Laplace3D-64: the partition's host
        seconds, both comm volumes (seg-metis must not move more), y
        against scipy;
 11. the auxiliaries (slice 10), each driven through its entry point:
     a. ScaMaC's Hubbard chain (n_sites=13, n_fermions=6, U=1.3: 2.9 M
        rows, 41 M nnz) and StokesSaddle-64 (1.0 M rows, 27 M nnz),
        generated by the port, through the main path at sp, C=1024,
        sigma=1, default tiers (from_mtx, a solve of 1 repetition validated
        per element, bench_spmv 0.3 s; launch counts set to 0 before and
        read after); op.spmv against its plain version and scipy; the other
        tier and BcooSpmvOperator (cuSPARSE) against op.spmv; op.spmv and
        the other tier by replayed CUDA graphs and cuSPARSE by CUDA events,
        in turns, beside the byte bound;
     b, c. the CLI on the headline: -impl bcoo sp and hp, -impl xla sp
        (validated solves of 5 repetitions, and bench mode), beside the
        kernel path's bench;
     d. the CLI's -matrix_stats, -output_sparsity (split rows; the file
        read back equals the matrix's nonzeros as a set) and -debug 1 on a
        small Hubbard chain, and -log_prof on the headline bench: the
        Chrome trace must hold the spmv_scs_benchmark range and the SELL
        kernel's own name (CUPTI records kernels launched through ctypes),
        and the bench with and without the profiler gives its cost;
     e. the native host library (g++, native/uspmv_host.cpp): read_mtx of
        a written Laplace3D-64 and convert_to_scs of the headline against
        the Python paths, bit-equal, with the seconds of each and of
        from_mtx with the native path on and off;
     f. the scripts check_dp_emu and validate_campaign --quick on the card
        (every campaign run on cuda-* or cusparse-*), their rows read back.

Beside each kernel's time the script prints its bound (bytes over 3,350
GB/s, or flops over the peak of its type if larger; for the fused solve the
matrix stream once per iteration, x0 in and two vectors out once) and ``library_ms``, the
time of ``torch.sparse_csr_tensor(...) @ x`` on the same matrix in the
original row order: a yardstick only, the port never calls it (null with
the error text where PyTorch has no CSR product for the dtypes).

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
import threading
import time

TOL = {"sp": 1e-5, "dp": 1e-12}
KERNEL_SOURCE = "uspmv_tpu_torch/csrc/scs_spmv.cu"
SOLVE_SOURCE = "uspmv_tpu_torch/csrc/scs_solve.cu"
PIECES_SOURCE = "uspmv_tpu_torch/csrc/scs_pieces.cu"
PACKED_SOURCE = "uspmv_tpu_torch/csrc/scs_packed.cu"
PALLAS = "uspmv_tpu/ops/pallas_scs.py"
X_ACCESS_SOURCE = "uspmv_tpu_torch/csrc/x_access.cu"
PROBE_SOURCE = "uspmv_tpu_torch/csrc/scs_probe.cu"
# x-access entry point -> (the TPU probe kernels it replaces, the sweep point
# that times it in the kernels line: mode, pattern, x elements)
X_ACCESS = {
    "uspmv_x_gather_store": (
        ["scripts/test_gather1d.py:46", "scripts/test_gather1d.py:85",
         "scripts/test_gather2d.py:55"], ("gather_store", "banded", 2**21)),
    "uspmv_x_gather_fma": (["scripts/test_gather_tput.py:66"],
                           ("gather_fma", "banded", 2**21)),
    "uspmv_x_copy_fma": (["scripts/test_gather_tput.py:66"],
                         ("copy_fma", "in_place", 2**24)),
}
# H100 SXM data sheet: HBM3 bytes/s; FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.float32": 67e12, "torch.float64": 34e12}
SOLVE_K = 512
# the kernels whose registers the build phase reports (cuobjdump)
ROW_SUM_KERNELS = ("scs_spmv_kernel", "scs_ones_kernel", "scs_packed_kernel",
                   "scs_solve_kernel")
# Solves judged on the relative L2 norm, not per element, and why. Every
# other validated solve of this script must be OK per element (hp and the
# ap[*_hp] mixes by validate's own bf16 bound). Keys: (phase, matrix,
# value type); path F's FemTet3D solves run 5 repetitions from a random x on
# the value-scaled matrix, path G's one repetition from the default x.
_FEM = ("an f32 result of rows whose diagonal nearly cancels the sum of "
        "their off-diagonals: per element WARNING/ERROR at rel_l2 <= 2.3e-7")
_RANDOM = ("random-signed values: rows that cancel trip the per-element "
           "flag in f32 at rel_l2 <= 2e-6")
L2_JUDGED = {
    ("F", "FemTet3D,55", "sp"): _FEM,
    ("F", "FemTet3D,55", "ap[dp_sp]"): _FEM + " (the sp stream's values)",
    ("F", "FemTet3D,9", "sp"): _FEM,
    ("G", "BandedImbalanced,500000,64,8", "sp"): _RANDOM,
    ("G", "PowerLawCols,500000,8", "sp"): _RANDOM,
    ("G", "RandomImbalanced,500000,8", "sp"): _RANDOM,
    ("G", "RandomImbalanced,500000,8", "hp"): _RANDOM,
    ("G", "RandomImbalanced,500000,8", "ap[dp_sp]"):
        _RANDOM + " (the sp stream's values)",
    ("G", "RandomImbalanced,500000,8", "ap[dp_hp]"):
        _RANDOM + " (the hp stream's values)",
}
# the slice-5 kernels: entry point -> (what it replaces, the run of path G on
# RandomImbalanced-500k at C=1024, sigma=1 that times it, the stream)
TIER_INSTANTIATIONS = {
    "uspmv_scs_packed_f32_f32": (":1347", "sp", "sp"),
    "uspmv_scs_packed_f64_f64": (":1347", "dp", "dp"),
    "uspmv_scs_packed_bf16_f32": (":1347", "hp", "hp"),
    "uspmv_scs_pieces_f32_f32": (":960", "sp", "sp"),
    "uspmv_scs_pieces_f64_f64": (":960", "dp", "dp"),
    "uspmv_scs_pieces_bf16_f32": (":960", "hp", "hp"),
    "uspmv_scs_pieces_f32_f64": (":960", "ap[dp_sp]", "sp"),
    "uspmv_scs_pieces_bf16_f64": (":960", "ap[dp_hp]", "hp"),
}
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
# fused-solve instantiation -> value type of its Laplace3D-128 run (path F)
SOLVE_INSTANTIATIONS = {
    "uspmv_scs_solve_f32_f32": "sp",
    "uspmv_scs_solve_f64_f64": "dp",
    "uspmv_scs_solve_bf16_f32": "hp",
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


def bound(nbytes, flops, x_dtype):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of bytes over the HBM rate and flops over the peak of the type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(x_dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def unit_row_sums(mtx):
    """Scale the values in place so the row sums of |A| are <= 1; returns
    the factor."""
    import numpy as np

    s = 1.0 / np.bincount(mtx.I, weights=np.abs(mtx.values)).max()
    mtx.values[:] = mtx.values * s
    return float(s)


def csr_library(dev, old_to_new, n_rows, x, y, reps=100, tol=None):
    """Time ``torch.sparse_csr_tensor(...) @ x`` (cuSPARSE) on the matrix of
    ``dev`` in the original row order (``csr_library_call``)."""
    call, err = csr_library_call(dev, old_to_new, n_rows, x, y, tol)
    return (time_ms(call, reps), None) if call else (None, err)


def csr_library_call(dev, old_to_new, n_rows, x, y, tol=None):
    """``torch.sparse_csr_tensor(...) @ x`` (cuSPARSE) on the matrix of
    ``dev`` in the original row order (``library_csr_call``). ``y`` is the
    kernel's result for the same x: the library's must agree with it within
    ``tol`` (default: the tolerance of x's dtype)."""
    import torch

    keep = dev.values != 0  # drops the padding (and explicit zeros)
    new_to_old = torch.full((dev.n_rows_padded,), -1, dtype=torch.int64,
                            device=x.device)
    o2n = torch.as_tensor(old_to_new, dtype=torch.int64, device=x.device)
    new_to_old[o2n] = torch.arange(n_rows, device=x.device)
    rows = new_to_old[dev.row_idxs[keep].long()]
    cols = new_to_old[dev.col_idxs[keep].long()]
    require(rows.min().item() >= 0 and cols.min().item() >= 0,
            "csr_library: a nonzero outside the original rows")
    return library_csr_call(rows, cols, dev.values[keep], n_rows,
                            x.index_select(0, o2n).contiguous(),
                            y.index_select(0, o2n), tol or acc_tol(x))


def library_csr_ms(rows, cols, vals, n, x, want, tol, reps):
    """Time ``torch.sparse_csr_tensor(...) @ x`` (cuSPARSE) for the n x n
    matrix of the given triples (``library_csr_call``). Returns (ms, None),
    or (None, error text) where PyTorch has no CSR product for the dtypes."""
    call, err = library_csr_call(rows, cols, vals, n, x, want, tol)
    return (time_ms(call, reps), None) if call else (None, err)


def library_csr_call(rows, cols, vals, n, x, want, tol):
    """``torch.sparse_csr_tensor(...) @ x`` (cuSPARSE) for the n x n matrix
    of the given triples (device tensors, in the index space of x, int32
    indices in the CSR), values widened to x's dtype (bf16 values too, the
    rule of ops/spmv_bcoo.py: cuSPARSE takes no bf16 matrix with an f32
    x); its result must agree with ``want``. Returns (the call, None), or
    (None, error text) where PyTorch has no CSR product for the dtypes."""
    import torch

    vals = vals.to(x.dtype)
    try:
        A = torch.sparse_coo_tensor(
            torch.stack([rows.long(), cols.long()]), vals,
            size=(n, n)).coalesce().to_sparse_csr()
        A = torch.sparse_csr_tensor(
            A.crow_indices().int(), A.col_indices().int(), A.values(),
            size=(n, n), check_invariants=False)
        y_lib = A @ x
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    compare(y_lib.to(want.dtype), want, tol, "library CSR product vs the "
            "kernel")
    return (lambda: A @ x), None


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


def graph_ms(fn, reps):
    """Milliseconds per call of ``fn`` on the device's own clock: reps calls
    captured into one CUDA graph and replayed, so no host enqueue sits
    between the kernels. ``fn`` launches kernels of this package into
    buffers it was given and allocates nothing. A kernel shorter than the
    host's enqueue (~30 us) reads too long in ``time_ms``."""
    import torch

    from uspmv_tpu_torch.ops.scs_spmv import record_captured_launches

    fn()  # built, loaded and launched once before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with record_captured_launches():
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    return time_ms(graph.replay, 3) / reps


def time_pair(kernel, plain, reps=100):
    """(kernel ms, plain ms, samples) in the order plain, kernel, kernel,
    plain on the same tensors; each is the median of its two runs."""
    import numpy as np

    t_plain = [time_ms(plain, reps)]
    t_kern = [time_ms(kernel, reps) for _ in range(2)]
    t_plain.append(time_ms(plain, reps))
    return (float(np.median(t_kern)), float(np.median(t_plain)),
            dict(kernel_samples_ms=t_kern, plain_samples_ms=t_plain))


def time_turns(timers):
    """Each of ``timers`` (name -> a call that returns one time in ms) in
    the order first..last, last..first: kernel, library, library, kernel.
    Returns {name: median ms}, {name + "_samples_ms": the two samples} and
    {name + "_spread": (max - min) / median}."""
    import numpy as np

    names = list(timers)
    samples = {k: [] for k in names}
    for k in [*names, *reversed(names)]:
        samples[k].append(timers[k]())
    med = {k: float(np.median(v)) for k, v in samples.items()}
    extra = {}
    for k, v in samples.items():
        extra[f"{k}_samples_ms"] = v
        extra[f"{k}_spread"] = (max(v) - min(v)) / med[k]
    return med, extra


def sell_vs_library(dev, op, x, y, reps):
    """The SELL-C-sigma kernel on ``dev`` and x beside its plain version and
    cuSPARSE on the same matrix, timed by CUDA events in turns (plain,
    kernel, library, library, kernel, plain), with the kernel's launch
    geometry. Returns (library ms, library error, fields), the fields
    holding kernel_ms, plain_ms, the samples, spreads and geometry."""
    from uspmv_tpu_torch.ops import scs_spmv

    call, lib_err = csr_library_call(dev, op.old_to_new, op.n_rows, x, y)
    timers = {"plain": lambda: time_ms(
                  lambda: scs_spmv.spmv_scs_plain(dev, x), reps),
              "kernel": lambda: time_ms(lambda: scs_spmv.spmv_scs(dev, x),
                                        reps)}
    if call:
        timers["library"] = lambda: time_ms(call, reps)
    med, fields = time_turns(timers)
    fields.update(kernel_ms=med["kernel"], plain_ms=med["plain"],
                  launch=scs_spmv.launch_geometry(dev, x.dtype))
    return med.get("library"), lib_err, fields


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


def validated_solve(op, mtx, n_rev, what, impl=None, l2_judged=False):
    """A solve of n_rev repetitions from the configuration's x, validated
    against the scipy f64 oracle both ways (runtime/validate.compare): per
    element and on the relative L2 norm. The per-element flag must be OK,
    unless ``l2_judged`` names this case as one of L2_JUDGED, where the
    norm's flag must be. Returns both reports."""
    import numpy as np

    from uspmv_tpu_torch.ops.vectors import init_x_host
    from uspmv_tpu_torch.runtime.validate import validate_solve

    x0 = init_x_host(op.config, op.n_rows, op.matrix_stats, dtype=np.float64)
    _, y = op.solve(op.make_x(x0), n_rev, impl=impl)
    y = op.to_host(y)
    rep, rep_l2 = (validate_solve(mtx, x0, y, n_rev,
                                  value_type=op.config.value_type,
                                  hp_nnz_fraction=op.hp_nnz_fraction(),
                                  l2_mode=l2_mode)
                   for l2_mode in (False, True))
    require((rep_l2 if l2_judged else rep).flag == "OK",
            f"{what}: validation per element {rep.summary()} / L2 "
            f"{rep_l2.summary()}")
    return rep, rep_l2


def plain_spmv(op, x):
    """op.spmv with every stream through the plain version, in op.spmv's
    order: the first writes y, the rest add into it, each followed by its
    heavy-row pieces."""
    from uspmv_tpu_torch.ops.device_format import DevicePacked
    from uspmv_tpu_torch.ops.scs_packed import spmv_packed_plain
    from uspmv_tpu_torch.ops.scs_pieces import spmv_pieces_plain
    from uspmv_tpu_torch.ops.scs_spmv import spmv_scs_plain

    layout = op.config.vector_layout
    y = None
    for p, dev in op.devs.items():
        plain = (spmv_packed_plain if isinstance(dev, DevicePacked)
                 else spmv_scs_plain)
        y = plain(dev, x, layout, y)
        if p in op.pieces:
            spmv_pieces_plain(op.pieces[p], x, layout, y)
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
    rep, _ = validated_solve(op, mtx, 5, f"path {name} solve")
    n_before = launch_count()
    res = bench_spmv(op, bench_time=1.0)
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
        b_ms, b_by = bound(s_bytes, 2 * dev.nnz * bs, x.dtype)
        lib_ms, lib_err = (None, "colwise block vectors: not timed")
        if layout == "rowwise" or bs == 1:
            lib_ms, lib_err = csr_library(dev, op.old_to_new, op.n_rows, x,
                                          spmv_scs(dev, x, layout))
        stream_rec[p] = dict(
            entry=entry_point(dev.values.dtype, wd), nnz=dev.nnz,
            n_elements=dev.n_elements, ms=s_ms, plain_ms=s_plain_ms,
            gbps=s_bytes / s_ms / 1e6, plain_gbps=s_bytes / s_plain_ms / 1e6,
            max_abs_err=s_abs, rel_err=s_rel, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library_error=lib_err)
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


def permuted_scs(mtx, C, sigma):
    """Host SCS with the symmetric column permutation, as the operator
    builds it."""
    import numpy as np

    from uspmv_tpu_torch.formats.scs import convert_to_scs, permute_scs_cols

    scs = convert_to_scs(mtx, C, sigma)
    perm = np.arange(scs.n_rows_padded, dtype=np.int32)
    perm[: scs.n_rows] = scs.old_to_new_idx
    permute_scs_cols(scs, perm)
    return scs


def solve_small(cuda, rng_seed=1):
    """Phase 7a: the fused solve kernel against k launches of the SpMV
    kernel (bit for bit) and against its plain version, small shapes."""
    import torch

    from uspmv_tpu_torch.io.generators import (
        fem_tet3d,
        laplace3d,
        random_banded,
    )
    from uspmv_tpu_torch.ops import scs_solve, scs_spmv
    from uspmv_tpu_torch.ops.device_format import build_device_scs

    gen = torch.Generator().manual_seed(rng_seed)
    for name, mtx in (("Laplace3D,32", laplace3d(32)),
                      ("RandomBanded,200000,60,11",
                       random_banded(200_000, 60, 11)),
                      ("FemTet3D,9", fem_tet3d(9))):
        unit_row_sums(mtx)
        for C, sigma in ((1024, 1), (32, 512)):
            scs = permuted_scs(mtx, C, sigma)
            for (vdt, xdt), entry in scs_solve._ENTRY_POINTS.items():
                dev = build_device_scs(scs, cuda, vdt)
                n = dev.n_rows_padded
                worst = 0.0
                for bs in (1, 4, 8):
                    x = torch.randn((n,) if bs == 1 else (n, bs),
                                    generator=gen,
                                    dtype=torch.float64).to(xdt).to(cuda)
                    x_before = x.clone()
                    for k in (1, 2, 5, 64):
                        what = f"{name} C={C} s={sigma} {entry} bs={bs} k={k}"
                        n0 = scs_solve.launch_counts()[entry]
                        s0 = scs_spmv.launch_count()
                        prev, fin = scs_solve.solve_scs(dev, x, k)
                        torch.cuda.synchronize()
                        require(scs_solve.launch_counts()[entry] == n0 + 1
                                and scs_spmv.launch_count() == s0,
                                f"{what}: not one fused launch")
                        want_prev, want = x, x
                        for _ in range(k):
                            want_prev, want = want, scs_spmv.spmv_scs(dev, want)
                        require(torch.equal(fin, want)
                                and torch.equal(prev, want_prev),
                                f"{what}: differs from k launches of the "
                                "SpMV kernel")
                        p_prev, p_fin = scs_solve.solve_scs_plain(dev, x, k)
                        _, rel = compare(fin, p_fin, acc_tol(x), what)
                        _, rel_prev = compare(prev, p_prev, acc_tol(x),
                                              what + " (previous vector)")
                        worst = max(worst, rel, rel_prev)
                    require(torch.equal(x, x_before), f"{name}: x0 written")
                emit("solve_vs_loop_and_plain", matrix=name, C=C, sigma=sigma,
                     entry=entry, values=str(vdt), x=str(xdt),
                     bs=[1, 4, 8], k=[1, 2, 5, 64], bit_equal_to_loop=True,
                     worst_rel_err_vs_plain=worst, tol=acc_tol(x))
                del dev


# operators of the graph-vs-loop check (phase 7a); thresholds are times the
# value scale, so ap[sp_hp] splits Laplace3D's diagonal from the rest
GRAPH_CASES = {
    "sp": dict(value_type="sp"),
    "dp": dict(value_type="dp"),
    "hp": dict(value_type="hp"),
    "ap[sp_hp]": dict(value_type="ap[sp_hp]", ap_threshold_1=2.44),
    "sp-colwise-4": dict(value_type="sp", block_vec_size=4,
                         vector_layout="colwise"),
}


def graph_small(rng):
    """Phase 7a: the CUDA-graph solve against the loop of launches, bit for
    bit, with a replay counted as its kernel nodes."""
    import torch

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.io.generators import laplace3d
    from uspmv_tpu_torch.ops import scs_solve, scs_spmv
    from uspmv_tpu_torch.runtime.operator import graph_nodes_replayed

    mtx = laplace3d(32)
    scale = unit_row_sums(mtx)
    for name, fields in GRAPH_CASES.items():
        fields = dict(fields)
        if "ap_threshold_1" in fields:
            fields["ap_threshold_1"] *= scale
        op = SpmvOperator.from_mtx(
            Config(kernel_format="scs", chunk_size=1024, sigma=1,
                   backend="cuda", **fields), mtx)
        streams = len(op.devs)
        require(streams == len(op.config.ap_precisions)
                and min(op.nnz_per_precision().values()) > 0,
                f"graph {name}: empty stream {op.nnz_per_precision()}")
        bs = op.config.block_vec_size
        x = op.make_x(rng.standard_normal((op.n_rows, bs) if bs > 1
                                          else op.n_rows))
        for k in (2, 5, 64):
            what = f"graph solve {name} k={k}"
            require(op.solve_impl_name(k) == "graph", f"{what}: default impl")
            l_prev, l_fin = op.solve(x, k, impl="loop")
            for _ in range(2):  # the capture, then a replay from the cache
                n0 = scs_spmv.launch_count()
                g0 = sum(graph_nodes_replayed().values())
                g_prev, g_fin = op.solve(x, k)
                torch.cuda.synchronize()
                require(torch.equal(g_fin, l_fin)
                        and torch.equal(g_prev, l_prev),
                        f"{what}: differs from the loop")
            nodes = sum(graph_nodes_replayed().values()) - g0
            require(nodes == k * streams and scs_spmv.launch_count() == n0,
                    f"{what}: a replay counted {nodes} kernel nodes, "
                    f"expected {k * streams}, and "
                    f"{scs_spmv.launch_count() - n0} launches, expected 0")
            if op.fused_solve_eligible():
                f0 = scs_solve.launch_count()
                f_prev, f_fin = op.solve(x, k, impl="fused")
                require(scs_solve.launch_count() == f0 + 1
                        and torch.equal(f_fin, l_fin)
                        and torch.equal(f_prev, l_prev),
                        f"{what}: fused differs from the loop")
        emit("graph_vs_loop", case=name, matrix="Laplace3D,32", k=[2, 5, 64],
             streams=streams, bit_equal=True,
             fused_eligible=op.fused_solve_eligible())


def solve_path(spec, mtx, scale, ap_threshold, card, unscaled=None):
    """Phase 7b, one matrix: solve at full size through the entry points,
    by every impl. ``mtx`` holds the values times ``scale``;
    ``ap_threshold`` is that of the unscaled values. The validated solves
    of 5 repetitions run on ``unscaled`` from the configuration's default
    x where it is given, else on ``mtx`` from a random x (-rand_x 1).
    Returns (SpMV launches, fused launches, graph nodes replayed) per
    entry point over this path."""
    import numpy as np
    import torch

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.ops import scs_solve, scs_spmv
    from uspmv_tpu_torch.runtime import operator
    from uspmv_tpu_torch.runtime.bench import bench_solve

    k = SOLVE_K
    scs_spmv.reset_launch_count()
    scs_solve.reset_launch_count()
    operator.reset_graph_nodes_replayed()

    def nodes_replayed():
        return sum(operator.graph_nodes_replayed().values())

    runs = [("sp", lambda s: dict(value_type="sp"),
             ("loop", "graph", "fused")),
            ("ap[dp_sp]", lambda s: dict(value_type="ap[dp_sp]",
                                         dp_emulation=True,
                                         ap_threshold_1=ap_threshold * s),
             ("loop", "graph"))]
    # mixed_tiles=False: path F is the fused solve kernel's path, which runs
    # SELL-C-sigma only; FemTet3D-9 (beta 0.4865 at C=1024) would otherwise
    # take the packed tier
    base = dict(kernel_format="scs", chunk_size=1024, sigma=1, backend="cuda",
                mixed_tiles=False)
    for label, fields, impls in runs:
        op = SpmvOperator.from_mtx(
            Config(random_init_x=True, **base, **fields(scale)), mtx)
        op_check, mtx_check = op, mtx
        if unscaled is not None:
            op_check = SpmvOperator.from_mtx(
                Config(**base, **fields(1.0)), unscaled)
            mtx_check = unscaled
        streams = len(op.devs)
        npp = op.nnz_per_precision()
        require(min(npp.values()) > 0, f"{spec} {label}: empty stream {npp}")
        require(op.fused_solve_eligible() == (label == "sp"),
                f"{spec} {label}: fused eligibility")
        x = op.make_x()
        results = {}
        for impl in impls:
            what = f"path F {spec} {label} {impl}"
            rep, rep_l2 = validated_solve(
                op_check, mtx_check, 5, what, impl,
                l2_judged=unscaled is None and ("F", spec, label) in L2_JUDGED)
            # one solve, counted: k SpMV launches (loop), k kernel nodes per
            # stream replayed and no launch (graph), or one fused launch
            op.solve(x, k, impl=impl)  # captures the graph, if any
            n0, f0 = scs_spmv.launch_count(), scs_solve.launch_count()
            g0 = nodes_replayed()
            results[impl] = op.solve(x, k, impl=impl)
            torch.cuda.synchronize()
            spmv_l = scs_spmv.launch_count() - n0
            fused_l = scs_solve.launch_count() - f0
            nodes = nodes_replayed() - g0
            require((spmv_l, nodes, fused_l)
                    == {"loop": (k * streams, 0, 0),
                        "graph": (0, k * streams, 0),
                        "fused": (0, 0, 1)}[impl],
                    f"{what}: one solve made {spmv_l} SpMV launches, "
                    f"replayed {nodes} kernel nodes and made {fused_l} "
                    "fused launches")
            n0, f0 = scs_spmv.launch_count(), scs_solve.launch_count()
            g0 = nodes_replayed()
            res = bench_solve(op, k, x=x, bench_time=1.0, impl=impl)
            bench_spmv_l = scs_spmv.launch_count() - n0
            bench_fused_l = scs_solve.launch_count() - f0
            bench_nodes = nodes_replayed() - g0
            require(res.impl == f"solve-{impl}[{op.impl_name()}]",
                    f"{what}: bench impl {res.impl}")
            require(res.n_iterations % k == 0
                    and np.isfinite(res.perf_gflops) and res.perf_gflops > 0,
                    f"{what}: {res.n_iterations} iterations, "
                    f"{res.perf_gflops} GFLOP/s")
            solves = res.n_iterations // k
            if impl == "fused":
                require(bench_fused_l >= solves and bench_spmv_l == 0,
                        f"{what}: {bench_fused_l} fused launches for "
                        f"{solves} timed solves")
            elif impl == "graph":
                require(bench_nodes >= res.n_iterations * streams
                        and bench_spmv_l == 0,
                        f"{what}: {bench_nodes} kernel nodes replayed and "
                        f"{bench_spmv_l} launches for {res.n_iterations} "
                        "timed iterations")
            else:
                require(bench_spmv_l >= res.n_iterations * streams
                        and bench_nodes == 0,
                        f"{what}: {bench_spmv_l} launches for "
                        f"{res.n_iterations} timed iterations")
            emit("solve_path", matrix=spec, config=label, impl=res.impl,
                 C=1024, sigma=1, k=k, n_rows=op.n_rows, nnz=op.nnz,
                 beta=op.beta(), streams=streams,
                 us_per_iteration=res.duration_kernel_s / res.n_iterations
                 * 1e6, gflops=res.perf_gflops, gbps=res.effective_gbps,
                 n_iterations=res.n_iterations, solves=solves,
                 timing_samples_s=res.timing_samples_s,
                 launches_per_solve=dict(spmv=spmv_l, fused=fused_l,
                                         graph_nodes_replayed=nodes),
                 bench_launches=dict(spmv=bench_spmv_l, fused=bench_fused_l,
                                     graph_nodes_replayed=bench_nodes),
                 validated_on=("the unscaled matrix, default x"
                               if unscaled is not None
                               else "the scaled matrix, random x"),
                 validation=rep.summary(), validation_l2=rep_l2.summary(),
                 card=card)
        # k = SOLVE_K may drive a contraction's iterates down to denormals;
        # k = 64 compares the impls on values of ordinary size as well
        checked = {k: results,
                   64: {impl: op.solve(x, 64, impl=impl) for impl in impls}}
        for kk, got in checked.items():
            for impl in impls[1:]:
                require(torch.equal(got[impl][1], got["loop"][1])
                        and torch.equal(got[impl][0], got["loop"][0]),
                        f"path F {spec} {label}: {impl} differs from the "
                        f"loop at k={kk}")
            require(torch.isfinite(got["loop"][1]).all().item(),
                    f"path F {spec} {label}: non-finite A^{kk} x")
        emit("solve_path_bit_equal", matrix=spec, config=label,
             impls=list(impls),
             max_abs_y={kk: got["loop"][1].abs().max().item()
                        for kk, got in checked.items()})
        del op, op_check, results, checked, x
        torch.cuda.empty_cache()
    return (scs_spmv.launch_counts(), scs_solve.launch_counts(),
            operator.graph_nodes_replayed())


def fused_record(mtx, unscaled, value_type, card):
    """Phase 7b: the fused solve of one value type on Laplace3D-128 through
    the entry points (validated on the unscaled matrix, benchmarked on the
    scaled one), then the kernel against its plain version on the same
    tensors at k = SOLVE_K. Returns the kernel's record and its launches
    over the main path."""
    import torch

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.ops import scs_solve
    from uspmv_tpu_torch.runtime.bench import bench_solve

    k = SOLVE_K
    cfg = Config(kernel_format="scs", chunk_size=1024, sigma=1,
                 value_type=value_type, backend="cuda", random_init_x=True)
    op = SpmvOperator.from_mtx(cfg, mtx)
    (dev,) = op.devs.values()
    entry = scs_solve.entry_point(dev.values.dtype, op.working_dtype)
    main = 0
    if value_type != "sp":  # sp was driven by solve_path
        scs_solve.reset_launch_count()
        op_check = SpmvOperator.from_mtx(
            Config(kernel_format="scs", chunk_size=1024, sigma=1,
                   value_type=value_type, backend="cuda"), unscaled)
        rep, rep_l2 = validated_solve(op_check, unscaled, 5,
                                      f"fused {value_type}", "fused")
        del op_check
        res = bench_solve(op, k, bench_time=1.0, impl="fused")
        main = scs_solve.launch_counts()[entry]
        emit("solve_path", matrix="Laplace3D,128", config=value_type,
             impl=res.impl, C=1024, sigma=1, k=k,
             us_per_iteration=res.duration_kernel_s / res.n_iterations * 1e6,
             gflops=res.perf_gflops, gbps=res.effective_gbps,
             n_iterations=res.n_iterations,
             validated_on="the unscaled matrix, default x",
             validation=rep.summary(), validation_l2=rep_l2.summary(),
             card=card)
    x = op.make_x()
    prev, fin = scs_solve.solve_scs(dev, x, k)
    p_prev, p_fin = scs_solve.solve_scs_plain(dev, x, k)
    max_abs, rel = compare(fin, p_fin, acc_tol(x), f"{entry} k={k}")
    compare(prev, p_prev, acc_tol(x), f"{entry} k={k} (previous vector)")
    ms, plain_ms, samples = time_pair(
        lambda: scs_solve.solve_scs(dev, x, k),
        lambda: scs_solve.solve_scs_plain(dev, x, k), reps=3)
    # the bytes A^k x0 must move: the matrix stream once per iteration (at
    # 117-176 MB it exceeds the 50 MB L2), x0 read once, the two returned
    # vectors written once; the iterates between may stay in L2
    nbytes = k * dev.stream_bytes() + 3 * x.numel() * x.element_size()
    b_ms, b_by = bound(nbytes, k * op.flops_per_spmv(), x.dtype)
    rec = dict(max_abs_err=max_abs, rel_err=rel, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               library_error="no single PyTorch call computes A^k x",
               k=k, us_per_iteration=ms / k * 1e3,
               bound_us_per_iteration=b_ms / k * 1e3, bound_bytes=nbytes,
               gbps_of_bound_bytes=nbytes / ms / 1e6, **samples)
    emit("fused_solve_kernel", entry=entry, matrix="Laplace3D,128",
         value_type=value_type, card=card, **rec)
    return entry, rec, main


def interface_and_cg(mtx, mtx_scaled, rng, card):
    """Phase 7c: the library surface on Laplace3D-128."""
    import importlib.util

    import numpy as np
    import torch

    import uspmv_tpu_torch.interface as ui

    A = mtx_scaled.to_scipy().tocsr()
    h = ui.prepare(mtx_scaled, C=1024, sigma=1, value_type="sp")
    require(h.impl_name() == "cuda-scs-sp", f"interface impl {h.impl_name()}")
    x = rng.standard_normal(mtx.n_rows)
    x32 = x.astype(np.float32).astype(np.float64)
    y = ui.execute_uspmv(h, x)
    require(isinstance(y, np.ndarray) and y.shape == x.shape,
            "execute_uspmv: numpy out in host order")
    ref = A @ x32
    rel1 = float(np.abs(y - ref).max() / np.abs(ref).max())
    xd = ui.upload_x(h, x)
    for _ in range(3):
        xd = ui.execute_uspmv(h, xd, device_resident=True)
    require(isinstance(xd, torch.Tensor) and xd.is_cuda,
            "device_resident result must stay on the card")
    y3 = ui.download_y(h, xd)
    ref3 = A @ (A @ ref)
    rel3 = float(np.abs(y3 - ref3).max() / np.abs(ref3).max())
    y3_host = ui.execute_uspmv(h, x, n_repetitions=3)
    require(np.array_equal(y3_host, y3),
            "n_repetitions=3 differs from three device-resident calls")
    require(rel1 <= TOL["sp"] and rel3 <= TOL["sp"],
            f"interface vs scipy: {rel1:.3e}, {rel3:.3e} > {TOL['sp']:g}")
    emit("interface", matrix="Laplace3D,128", value_type="sp",
         rel_err_vs_scipy=rel1, rel_err_3_device_resident_calls=rel3,
         tol=TOL["sp"])
    del h, xd
    torch.cuda.empty_cache()

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "cg_solver_torch", os.path.join(here, "examples", "cg_solver_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    tol, maxiter = 1e-6, 500  # the example's defaults
    h = ui.prepare(mtx, C=1024, sigma=1, value_type="sp")
    x_true = np.random.default_rng(0).standard_normal(mtx.n_rows)
    b = mtx.to_scipy().tocsr() @ x_true
    example.cg(h, b, tol=tol, maxiter=example.BATCH)  # warm-up, one batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_cg, it, res = example.cg(h, b, tol=tol, maxiter=maxiter)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    err = float(np.linalg.norm(x_cg - x_true) / np.linalg.norm(x_true))
    require(res <= tol * 10, f"CG: residual {res:.3e} after {it} iterations")
    require(np.isfinite(err) and err < 1e-3, f"CG: solution error {err:.3e}")
    emit("cg", matrix="Laplace3D,128", value_type="sp", tol=tol,
         maxiter=maxiter, iterations=it, rel_residual=res,
         solution_rel_error=err, seconds=seconds,
         us_per_iteration=seconds / it * 1e6, card=card)


def imbalanced_small():
    """random_imbalanced(4000, 8) with row 7 filled to 3,000+ elements, and
    600 empty rows behind it: 4,600 rows."""
    import numpy as np

    from uspmv_tpu_torch.formats.coo import MtxData
    from uspmv_tpu_torch.io.generators import random_imbalanced

    m = random_imbalanced(4000, 8)
    rng = np.random.default_rng(5)
    cols = rng.permutation(4000)[:3000]
    I = np.concatenate([m.I, np.full(cols.size, 7)])
    J = np.concatenate([m.J, cols])
    V = np.concatenate([m.values, rng.standard_normal(cols.size)])
    _, first = np.unique(I.astype(np.int64) * 4600 + J, return_index=True)
    return MtxData.from_arrays(I[first], J[first], V[first], 4600,
                               4600).sort_by_row()


TIER_SMALL = {
    "sp": dict(value_type="sp"),
    "dp": dict(value_type="dp"),
    "hp": dict(value_type="hp"),
    "ap[dp_sp_hp]": dict(value_type="ap[dp_sp_hp]", ap_threshold_1=1.0,
                         ap_threshold_2=0.3),
}


def long_row_tol(x, longest):
    """Kernel vs plain where a row of ``longest`` products is summed in two
    orders: the tolerance of x's dtype, or 4 eps sqrt(longest) if larger."""
    import torch

    return max(acc_tol(x), 4 * torch.finfo(x.dtype).eps / 2 * longest ** 0.5)


def small_tiers(rng_seed=2):
    """Phase 3c: the pieces and packed-row kernels against their plain
    versions, every instantiation, layout and form; twice bit-equal."""
    import numpy as np
    import torch

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.ops import scs_packed, scs_pieces

    mtx = imbalanced_small()
    longest = int(np.bincount(mtx.I).max())
    gen = torch.Generator().manual_seed(rng_seed)
    seen = set()
    for name, fields in TIER_SMALL.items():
        is_ap = name.startswith("ap")
        worst = {}
        for th in (2, 32, 1024):
            for layout, bs in (("rowwise", 1), ("rowwise", 4), ("colwise", 4)):
                for packed in ((False,) if is_ap else (False, True)):
                    op = SpmvOperator.from_mtx(Config(
                        kernel_format="scs", chunk_size=32, sigma=64,
                        backend="cuda", split_rows_threshold=th,
                        mixed_tiles=packed, block_vec_size=bs,
                        vector_layout=layout, **fields), mtx)
                    what = f"{name} th={th} {layout} bs={bs} packed={packed}"
                    tier = ("packed" if packed else "scs") + "+pieces"
                    require(op.impl_name() == f"cuda-{tier}-{name}",
                            f"{what}: impl {op.impl_name()}")
                    require(list(op.pieces) == list(op.devs),
                            f"{what}: a stream without pieces")
                    n = op.n_rows_padded
                    shape = ((n,) if bs == 1 else
                             (n, bs) if layout == "rowwise" else (bs, n))
                    x, y0 = (torch.randn(shape, generator=gen,
                                         dtype=torch.float64)
                             .to(op.working_dtype).to(op.device)
                             for _ in range(2))
                    tol = long_row_tol(x, longest)
                    for prec, dev in op.devs.items():
                        pc = op.pieces[prec]
                        if th == 2:
                            runs = pc.parent_ptr[1:] - pc.parent_ptr[:-1]
                            require(runs.max().item() > 32,
                                    f"{what}: no parent with > 32 pieces")
                        entry = scs_pieces.entry_point(pc.values.dtype, x.dtype)
                        n0 = scs_pieces.launch_counts()[entry]
                        got = [scs_pieces.spmv_pieces(pc, x, layout, y0.clone())
                               for _ in range(2)]
                        torch.cuda.synchronize()
                        require(scs_pieces.launch_counts()[entry] == n0 + 2,
                                f"{what}: {entry} launches not counted")
                        require(torch.equal(*got), f"{what}: {entry} differs "
                                "from run to run")
                        require(not pc.arrivals.any().item()
                                and not pc.slots.any().item(),
                                f"{what}: {entry} left a counter or slot "
                                "set")
                        _, rel = compare(got[0], scs_pieces.spmv_pieces_plain(
                            pc, x, layout, y0.clone()), tol, f"{what} {entry}")
                        worst[entry] = max(worst.get(entry, 0.0), rel)
                        seen.add(entry)
                        if not packed:
                            continue
                        entry = scs_packed.entry_point(dev.values.dtype,
                                                       x.dtype)
                        counts = dev.row_ptr[1:] - dev.row_ptr[:-1]
                        require((dev.groups[:, 2] == dev.groups[:, 3]
                                 ).any().item(),
                                f"{what}: no row group without elements")
                        for acc in (False, True):
                            n0 = scs_packed.launch_counts()[entry]
                            got = [scs_packed.spmv_packed(
                                dev, x, layout, y0.clone() if acc else None)
                                for _ in range(2)]
                            torch.cuda.synchronize()
                            require(scs_packed.launch_counts()[entry]
                                    == n0 + 2,
                                    f"{what}: {entry} launches not counted")
                            require(torch.equal(*got), f"{what}: {entry} "
                                    "differs from run to run")
                            _, rel = compare(
                                got[0], scs_packed.spmv_packed_plain(
                                    dev, x, layout,
                                    y0.clone() if acc else None),
                                acc_tol(x), f"{what} {entry} acc={acc}")
                            worst[entry] = max(worst.get(entry, 0.0), rel)
                            seen.add(entry)
                            if not acc:
                                rows = got[0] if layout == "rowwise" or bs == 1 \
                                    else got[0].T
                                require(not rows[counts == 0].any().item(),
                                        f"{what}: a row without elements "
                                        "is not 0")
                    y = [op.spmv(x) for _ in range(2)]
                    require(torch.equal(*y), f"{what}: op.spmv differs from "
                            "run to run")
                    compare(y[0], plain_spmv(op, x), tol, what)
        emit("tier_kernels_vs_plain", matrix="imbalanced_small (4,600 rows)",
             C=32, sigma=64, config=name, thresholds=[2, 32, 1024],
             shapes=["rowwise-1", "rowwise-4", "colwise-4"],
             longest_row=longest, rel_err=worst, bit_equal_run_to_run=True,
             tol=tol)
    require(seen == set(TIER_INSTANTIATIONS),
            f"small shapes reached {sorted(seen)}")


SIZING = [
    ("FemTet3D,55", lambda g: g.fem_tet3d(55)),
    ("BandedImbalanced,500000,64,8", lambda g: g.banded_imbalanced(
        500_000, bandwidth=64, avg_nnz_per_row=8, seed=7)),
    ("PowerLawCols,500000,8", lambda g: g.powerlaw_cols(500_000, 8)),
    ("RandomImbalanced,500000,8", lambda g: g.random_imbalanced(500_000, 8)),
]
# RandomImbalanced-500k at C=1024, sigma=1 once more, per value type and
# with block vectors; thresholds split its standard-normal values
G_EXTRAS = {
    "hp": dict(value_type="hp"),
    "dp": dict(value_type="dp"),
    "ap[dp_sp]": dict(value_type="ap[dp_sp]", dp_emulation=True,
                      ap_threshold_1=0.5),
    "ap[dp_hp]": dict(value_type="ap[dp_hp]", dp_emulation=True,
                      ap_threshold_1=0.5),
    "sp-rowwise-4": dict(value_type="sp", block_vec_size=4,
                         vector_layout="rowwise"),
}


def tier_stream_records(op, x, reps, tol, with_library):
    """Each kernel of ``op.spmv`` on its own, on x (one vector or block
    vectors): ms by a replayed CUDA graph, its plain version's ms, the
    bound of the bytes it moves and, for one vector, cuSPARSE's ms on the
    same sub-matrix. Returns {entry point: record}."""
    import torch

    from uspmv_tpu_torch.ops import scs_packed, scs_pieces, scs_spmv
    from uspmv_tpu_torch.ops.device_format import DevicePacked

    layout = op.config.vector_layout
    bs = op.config.block_vec_size
    n = op.n_rows_padded
    xy_bytes = 2 * n * bs * x.element_size()
    out = torch.empty_like(x)
    recs = {}
    for p, dev in op.devs.items():
        packed = isinstance(dev, DevicePacked)
        mod, run, plain = ((scs_packed, scs_packed.spmv_packed,
                            scs_packed.spmv_packed_plain) if packed else
                           (scs_spmv, scs_spmv.spmv_scs,
                            scs_spmv.spmv_scs_plain))
        entry = mod.entry_point(dev.values.dtype, x.dtype)
        y = run(dev, x, layout, out=out).clone()
        max_abs, rel = compare(y, plain(dev, x, layout), tol,
                               f"{entry} vs plain")
        plain_ms = time_ms(lambda: plain(dev, x, layout), reps)
        nbytes = op.matrix_passes() * dev.stream_bytes() + xy_bytes
        b_ms, b_by = bound(nbytes, 2 * dev.nnz * bs, x.dtype)
        call, lib_err = None, "block vectors: not timed"
        if with_library and x.dim() == 1:
            keep = slice(None) if packed else dev.values != 0
            call, lib_err = library_csr_call(
                dev.row_idxs[keep], dev.col_idxs[keep], dev.values[keep], n,
                x, y, tol)
        # the kernel by a replayed graph and the library by events, in
        # turns: kernel, library, library, kernel
        timers = {"kernel": lambda: graph_ms(
            lambda: run(dev, x, layout, out=out), reps)}
        if call:
            timers["library"] = lambda: time_ms(call, reps)
        med, turns = time_turns(timers)
        recs[entry] = dict(
            stream=p, kind="packed" if packed else "scs", nnz=dev.nnz,
            n_elements=dev.nnz if packed else dev.n_elements,
            ms=med["kernel"], plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, bound_bytes=nbytes, max_abs_err=max_abs,
            rel_err=rel, library_ms=med.get("library"),
            library_error=lib_err, **turns)
        if packed:
            n_vec = x.shape[0] if x.dim() == 2 and layout == "colwise" else 1
            recs[entry]["launch"] = scs_packed.launch_geometry(dev, x.dtype,
                                                               n_vec)
        if packed and with_library and x.dim() == 1:
            recs[entry].update(gather_floor(dev, x, reps))
        if p not in op.pieces:
            continue
        pc = op.pieces[p]
        entry = scs_pieces.entry_point(pc.values.dtype, x.dtype)
        y0 = torch.zeros_like(x)
        y = scs_pieces.spmv_pieces(pc, x, layout, y0.clone())
        max_abs, rel = compare(
            y, scs_pieces.spmv_pieces_plain(pc, x, layout, y0.clone()), tol,
            f"{entry} vs plain")
        plain_ms = time_ms(
            lambda: scs_pieces.spmv_pieces_plain(pc, x, layout, out), reps)
        # bound, per vector: the function's own bytes (the CSR stream and
        # the parents' runs and rows), the x entries the pieces can touch,
        # the parents' rows of y read and written; moved: the same with
        # the kernel's records, counters and long records' slots
        xy = x.element_size() * (min(n, pc.nnz) + 2 * pc.n_parents)
        nbytes = bs * (pc.bound_bytes() + xy)
        b_ms, b_by = bound(nbytes, 2 * pc.nnz * bs, x.dtype)
        call, lib_err = None, "block vectors: not timed"
        if with_library and x.dim() == 1:
            call, lib_err = library_csr_call(
                pc.piece_rows[pc.piece_idxs.long()], pc.col_idxs, pc.values,
                n, x, y, tol)
        # as the stream kernels above: kernel, library, library, kernel
        timers = {"kernel": lambda: graph_ms(
            lambda: scs_pieces.spmv_pieces(pc, x, layout, out), reps)}
        if call:
            timers["library"] = lambda: time_ms(call, reps)
        med, turns = time_turns(timers)
        recs[entry] = dict(
            stream=p, kind="pieces", nnz=pc.nnz, n_pieces=pc.n_pieces,
            n_parents=pc.n_parents, n_records=pc.records.shape[0],
            n_long=pc.longs.shape[0], ms=med["kernel"], plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
            moved_bytes=bs * (pc.stream_bytes() + xy),
            max_abs_err=max_abs, rel_err=rel, library_ms=med.get("library"),
            library_error=lib_err, **turns)
        if with_library and x.dim() == 1:
            recs[entry].update(gather_floor(pc, x, reps))
    return recs


def gather_floor(dev, x, reps):
    """The random-gather floor of a packed or pieces stream: the x-access
    probes (csrc/x_access.cu) gathering x at the stream's own columns, once
    per stored element, from an f32 vector as many bytes long as x (an f64
    x is gathered as x_f32[2 col], the same 32 B sectors), by a replayed
    graph.
    gather_store writes each value, gather_fma sums value times x per
    thread: the two ends of what the kernel's phase a does. Both are upper
    bounds of the floor: a probe that gathers these columns faster lowers
    it."""
    import torch

    from uspmv_tpu_torch.ops import x_access

    scale = x.element_size() // 4
    idx = (dev.col_idxs * scale).contiguous()
    xf = torch.randn(dev.n_rows_padded * scale, device=x.device)
    v = dev.values.float()
    out = torch.empty(idx.numel(), device=x.device)
    fma_out = torch.empty(x_access.fma_threads(idx.numel()), device=x.device)
    require(torch.equal(x_access.gather_store(xf, idx, out=out),
                        x_access.gather_store_plain(xf, idx)),
            "gather floor: gather_store vs plain")
    return dict(
        gather_elements=idx.numel(), gather_x_bytes=xf.numel() * 4,
        gather_store_ms=graph_ms(
            lambda: x_access.gather_store(xf, idx, out=out), reps),
        gather_fma_ms=graph_ms(
            lambda: x_access.gather_fma(xf, idx, v, out=fma_out), reps))


def tier_launch_counts():
    """Launches per entry point of the three SpMV wrappers."""
    from uspmv_tpu_torch.ops import scs_packed, scs_pieces, scs_spmv

    return {**scs_spmv.launch_counts(), **scs_packed.launch_counts(),
            **scs_pieces.launch_counts()}


def reset_tier_launch_counts():
    from uspmv_tpu_torch.ops import scs_packed, scs_pieces, scs_spmv

    for mod in (scs_spmv, scs_packed, scs_pieces):
        mod.reset_launch_count()


def path_g_operator(spec, mtx, C, sigma, label, fields, card, drive,
                    with_library, x_host=None):
    """One operator of path G: built, (``drive``: driven as a user would,
    with the launch counts read), checked against its plain version and
    scipy and for bit-equal repeats, then timed. Returns its record, which
    holds the per-kernel records under ``kernels`` and the main path's
    launches under ``main_path_launches``."""
    import warnings

    import numpy as np
    import torch

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.runtime.bench import bench_spmv

    what = f"path G {spec} C={C} s={sigma} {label}"
    cfg = Config(kernel_format="scs", chunk_size=C, sigma=sigma,
                 backend="cuda", **{"value_type": "sp", **fields})
    counts = np.bincount(mtx.I, minlength=mtx.n_rows)
    rec = dict(matrix=spec, C=C, sigma=sigma, run=label,
               config={k: str(v) for k, v in fields.items()})
    reset_tier_launch_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the SCS-explosion guard's warning
        op = SpmvOperator.from_mtx(cfg, mtx)
    torch.cuda.synchronize()
    rec.update(operator_build_s=time.perf_counter() - t0,
               impl=op.impl_name(), split_rows_threshold=op.split_threshold,
               n_pieces=op.n_pieces(), nnz_in_pieces=op.nnz_in_pieces(),
               beta=op.beta(), device_beta=op.device_beta(),
               ran_C=next(iter(op.scs.values())).C,
               nnz_per_precision=op.nnz_per_precision(),
               bytes_per_spmv=op.bytes_per_spmv())
    if drive:
        judged = ("G", spec, cfg.value_type) in L2_JUDGED
        rep, rep_l2 = validated_solve(op, mtx, 1, what, l2_judged=judged)
        res = bench_spmv(op, bench_time=0.3)
        main = {k: v for k, v in tier_launch_counts().items() if v}
        per_spmv = (len(op.devs) * (-(-cfg.block_vec_size // 8)
                                    if cfg.vector_layout == "rowwise" else 1)
                    + len(op.pieces))
        require(sum(main.values()) >= res.n_iterations * per_spmv,
                f"{what}: {main} launches for {res.n_iterations} iterations "
                f"of {per_spmv} launches")
        rec.update(validation=rep.summary(), validation_l2=rep_l2.summary(),
                   judged="L2 norm" if judged else "per element",
                   gflops=res.perf_gflops, gbps=res.effective_gbps,
                   n_iterations=res.n_iterations,
                   launches_per_spmv=per_spmv, main_path_launches=main)
    bs = cfg.block_vec_size
    if x_host is None:
        x_host = np.random.default_rng(0).standard_normal(
            (op.n_rows, bs) if bs > 1 else op.n_rows)
    x = op.make_x(x_host)
    tol = long_row_tol(x, float(counts.max()))
    y = op.spmv(x)
    require(torch.equal(y, op.spmv(x)), f"{what}: op.spmv differs from run "
            "to run")
    max_abs, rel = compare(y, plain_spmv(op, x), tol, what)
    # x and the values rounded as the operator holds them; hp and the
    # adaptive mixes round values to bf16, which scipy's f64 matrix does not
    x_round = x_host.astype(np.float32 if x.dtype == torch.float32
                            else np.float64).astype(np.float64)
    ref = mtx.to_scipy().tocsr() @ x_round
    rel_scipy = float(np.abs(op.to_host(y).astype(np.float64) - ref).max()
                      / np.abs(ref).max())
    scipy_tol = 1e-2 if "hp" in cfg.value_type else max(
        tol, 1e-6 if cfg.is_ap else 0.0)
    require(rel_scipy <= scipy_tol,
            f"{what}: vs scipy {rel_scipy:.3e} > {scipy_tol:g}")
    probe = time_ms(lambda: op.spmv(x), 3)
    reps = 100 if probe < 1.0 else 5
    out = torch.empty_like(x)
    ms = graph_ms(lambda: op.spmv(x, out=out), reps)
    loop_ms = time_ms(lambda: op.spmv(x), reps)
    flops, nbytes = op.flops_per_spmv(), op.bytes_per_spmv()
    b_ms, b_by = bound(nbytes, flops, x.dtype)
    esize = x.element_size()
    # the floor of an ideal CSR: value + int32 column per nonzero, row
    # pointers, x and y once, no padding
    vsize = {"dp": 8, "sp": 4, "hp": 2}.get(cfg.value_type, 8)
    csr_ms, _ = bound((vsize + 4) * op.nnz + 4 * (op.n_rows + 1)
                      + 2 * esize * op.n_rows * bs, flops, x.dtype)
    rec.update(max_row_nnz=int(counts.max()),
               mean_row_nnz=float(counts.mean()), n_rows=op.n_rows,
               nnz=op.nnz, spmv_graph_ms=ms, spmv_loop_ms=loop_ms,
               spmv_graph_gflops=flops / ms / 1e6, bound_ms=b_ms,
               bound_by=b_by, ideal_csr_bound_ms=csr_ms, tol=tol,
               max_abs_err=max_abs, rel_err=rel, rel_err_vs_scipy=rel_scipy,
               bit_equal_run_to_run=True,
               kernels=tier_stream_records(op, x, reps, tol, with_library),
               card=card)
    return rec, op, x, y


def path_g(matrices, card):
    """Phase 8: imbalanced rows at full size through the entry points.
    Returns (main path launches per entry point, {(run, entry): kernel
    record} of the RandomImbalanced runs at C=1024, sigma=1)."""
    import numpy as np
    import torch

    from uspmv_tpu_torch.io import generators
    from uspmv_tpu_torch.ops import scs_pieces, scs_solve
    from uspmv_tpu_torch.runtime import operator

    launches, tier_records = {}, {}

    def add_launches(rec):
        for entry, k in rec.get("main_path_launches", {}).items():
            launches[entry] = launches.get(entry, 0) + k

    for spec, make in SIZING:
        t0 = time.perf_counter()
        mtx = matrices[spec] if spec in matrices else make(generators)
        gen_s = time.perf_counter() - t0
        n = mtx.n_rows
        for C, sigma in ((1024, 1), (32, 512)):
            # cuSPARSE on the whole matrix, original row order, once
            I, J = (torch.as_tensor(a, device="cuda") for a in (mtx.I, mtx.J))
            V = torch.as_tensor(mtx.values, dtype=torch.float32,
                                device="cuda")
            recs = {}
            auto, op, x, y = path_g_operator(
                spec, mtx, C, sigma, "auto", {}, card, drive=True,
                with_library=True)
            add_launches(auto)
            o2n = torch.as_tensor(op.old_to_new, dtype=torch.int64,
                                  device="cuda")
            tol = auto["tol"]
            # op.spmv by a replayed graph and cuSPARSE in turns: spmv,
            # library, library, spmv
            call, lib_err = library_csr_call(
                I, J, V, n, x.index_select(0, o2n).contiguous(),
                y.index_select(0, o2n), tol)
            lib_ms = None
            if call:
                out = torch.empty_like(x)
                med, turns = time_turns({
                    "spmv": lambda: graph_ms(lambda: op.spmv(x, out=out),
                                             100),
                    "library": lambda: time_ms(call, 100)})
                lib_ms = med["library"]
                auto.update(spmv_turns_ms=med["spmv"], **turns)
                del out
            packed = op.is_packed()
            if spec == "FemTet3D,55":
                require(auto["impl"] == "cuda-scs-sp" and not op.pieces,
                        f"the control left its tier: {auto['impl']}")
            recs["auto"] = auto
            del op, x, y
            torch.cuda.empty_cache()
            for label, fields in (
                    ("other", dict(mixed_tiles=not packed)),
                    ("before", dict(split_rows_threshold=-1,
                                    mixed_tiles=False))):
                recs[label], op, x, y = path_g_operator(
                    spec, mtx, C, sigma, label, fields, card, drive=False,
                    with_library=False)
                del op, x, y
                torch.cuda.empty_cache()
            for label, rec in recs.items():
                emit("path_g", generate_s=gen_s, library_ms=lib_ms,
                     library_error=lib_err,
                     library_gflops=(2 * mtx.nnz / lib_ms / 1e6
                                     if lib_ms else None), **rec)
            if spec == "RandomImbalanced,500000,8" and (C, sigma) == (1024, 1):
                for entry, k in auto["kernels"].items():
                    tier_records[("sp", entry)] = k
                rand = mtx
    # RandomImbalanced at (1024, 1) per value type and with block vectors
    for label, fields in G_EXTRAS.items():
        rec, op, x, y = path_g_operator(
            "RandomImbalanced,500000,8", rand, 1024, 1, label, fields, card,
            drive=True, with_library=True)
        add_launches(rec)
        require("+pieces" in rec["impl"], f"path G {label}: {rec['impl']}")
        for entry, k in rec["kernels"].items():
            tier_records[(label, entry)] = k
        emit("path_g", **rec)
        del op, x, y
        torch.cuda.empty_cache()
    # solve mode with pieces and packed rows: the CUDA graph against the
    # loop, bit for bit; the fused kernel refuses. Every row is scaled to a
    # unit sum of |a|: scaling the whole matrix by its heaviest row's sum
    # would send the iterates to 0 within a few repetitions
    from uspmv_tpu_torch import Config, SpmvOperator

    scaled = rand.copy()
    scaled.values[:] = scaled.values / np.bincount(
        scaled.I, weights=np.abs(scaled.values),
        minlength=scaled.n_rows)[scaled.I]

    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=1024, sigma=1,
               value_type="sp", backend="cuda", random_init_x=True), scaled)
    x = op.make_x()
    k = 64
    reset_tier_launch_counts()
    operator.reset_graph_nodes_replayed()
    f0 = scs_solve.launch_count()
    l_prev, l_fin = op.solve(x, k, impl="loop")
    loop_launches = {e: c for e, c in tier_launch_counts().items() if c}
    for entry, c in loop_launches.items():
        launches[entry] = launches.get(entry, 0) + c
    require(op.solve_impl_name(k) == "graph", "path G solve: default impl")
    for _ in range(2):  # the capture, then a replay from the cache
        g_prev, g_fin = op.solve(x, k)
        torch.cuda.synchronize()
        require(torch.equal(g_fin, l_fin) and torch.equal(g_prev, l_prev),
                "path G solve: the graph differs from the loop")
    nodes = operator.graph_nodes_replayed()
    after = {e: c for e, c in tier_launch_counts().items() if c}
    # the loop launched each wrapper k times; the capture launched each once
    # to warm up, and the two graph solves launched nothing more: they
    # replayed k iterations of kernel nodes each (one per pieces launch)
    per_pieces = scs_pieces.KERNELS_PER_LAUNCH
    require(sum(loop_launches.values()) == k * (len(op.devs) + len(op.pieces))
            and after == {e: c + 1 for e, c in loop_launches.items()}
            and sum(nodes.values()) == 2 * k * (len(op.devs)
                                                + per_pieces * len(op.pieces))
            and scs_solve.launch_count() == f0,
            f"path G solve: loop launches {loop_launches}, after the graph "
            f"solves {after}, graph nodes {nodes}")
    require(not op.fused_solve_eligible(), "path G solve: fused eligible")
    try:
        op.solve(x, k, impl="fused")
    except ValueError:
        refused = True
    else:
        refused = False
    require(refused, "path G solve: the fused kernel took pieces")
    require(torch.isfinite(l_fin).all().item()
            and l_fin.abs().max().item() > 0,
            "path G solve: A^k x is not finite or vanished, so bit-equality "
            "shows nothing")
    graph_us = time_ms(lambda: op.solve(x, k), 20) / k * 1e3
    loop_us = time_ms(lambda: op.solve(x, k, impl="loop"), 5) / k * 1e3
    emit("path_g_solve", matrix="RandomImbalanced,500000,8", C=1024, sigma=1,
         impl=op.impl_name(), k=k, graph_equals_loop=True,
         fused_refused=True, loop_launches=loop_launches,
         graph_nodes_replayed=nodes, graph_us_per_iteration=graph_us,
         loop_us_per_iteration=loop_us,
         max_abs_y=l_fin.abs().max().item(), card=card)
    return launches, tier_records


def phase9(mtx, headline_ms, card):
    """Phase 9: the last TPU kernels through the port's probe and sweep
    entry points, each driven with its launch counts set to 0 before and
    read after. ``mtx`` is the headline's Laplace3D-128. Returns (launches
    per entry point, {entry point: its record for the kernels line})."""
    import torch

    from uspmv_tpu_torch.ops import scs_probe, scs_spmv, x_access
    from uspmv_tpu_torch.scripts import (
        ap_bench,
        gather_probe,
        perf_sweep,
        tile_cost,
    )

    launches, records = {}, {}
    t0 = time.perf_counter()

    # ---- 9a. the x-access kernels through gather_probe
    x_access.reset_launch_count()
    rows = gather_probe.run(gather_probe.build_parser().parse_args(
        ["--reps", "10"]))
    launches.update(x_access.launch_counts())
    require(all(r.get("correct", True) for r in rows),
            "gather_probe: a gather of the shape table is wrong")
    for r in rows:
        emit("gather_probe", card=card, **r)
    sweep = {(r["mode"], r["pattern"], r["x_elems"]): r for r in rows
             if r["probe"] == "sweep"}
    for entry, (replaces, key) in X_ACCESS.items():
        r = sweep[key]
        records[entry] = dict(
            source=X_ACCESS_SOURCE, replaces=replaces[0],
            also_replaces=replaces[1:], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            library_error=r["library_error"], library_call=r["library_call"],
            timed_on=f"gather_probe sweep, {key[0]} {key[1]}, x "
                     f"{4 * key[2] / 1e6:.1f} MB, {r['elements']} elements, "
                     "by a replayed CUDA graph")
    # the kernels at a small, ragged size against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(9)
    n = 1000
    x = torch.randn(4096, generator=gen, device="cuda")
    v = torch.randn(n, generator=gen, device="cuda")
    idx = torch.randint(0, 4096, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    require(torch.equal(x_access.gather_store(x, idx),
                        x_access.gather_store_plain(x, idx)),
            "gather_store vs plain, 1,000 elements")
    tol = x_access.fma_tol(n)
    compare(x_access.gather_fma(x, idx, v), x_access.gather_fma_plain(
        x, idx, v), tol, "gather_fma vs plain, 1,000 elements")
    compare(x_access.copy_fma(x, v), x_access.copy_fma_plain(x, v), tol,
            "copy_fma vs plain, 1,000 elements")
    t_9a = time.perf_counter() - t0

    # ---- 9b. the cost split and the unit stream through tile_cost
    scs_probe.reset_launch_count()
    scs_spmv.reset_launch_count()
    split = tile_cost.measure(mtx, "Laplace3D,128", torch.device("cuda", 0),
                              100)
    launches.update(scs_probe.launch_counts())
    launches[scs_spmv.UNIT_ENTRY] = scs_spmv.launch_counts()[
        scs_spmv.UNIT_ENTRY]
    by = {r["variant"]: r for r in split.rows}
    require(by["full"]["bit_equal_to_spmv"], "tile_cost: full != spmv_scs")
    for r in split.rows:
        emit("tile_cost", card=card, **r)
    # cuSPARSE on the same x: the matrix (beside full) and its all-ones
    # pattern (beside the unit stream)
    op, x, unit = split.op, split.x, split.unit
    full_lib = csr_library(op.devs["sp"], op.old_to_new, op.n_rows, x,
                           split.y, 100)
    keep = unit.col_idxs >= 0
    unit_lib = library_csr_ms(
        unit.row_idxs[keep], unit.col_idxs[keep],
        torch.ones(int(keep.sum().item()), device=x.device),
        unit.n_rows_padded, x, split.y_unit, TOL["sp"], 100)
    emit("tile_cost_library", matrix="Laplace3D,128", card=card,
         full_library_ms=full_lib[0], unit_library_ms=unit_lib[0],
         spmv_graph_us=by["spmv"]["us"], headline_kernel_ms=headline_ms,
         full_over_spmv=by["full"]["us"] / by["spmv"]["us"],
         unit_over_ones=by["unit"]["us"] / by["ones"]["us"])
    timed = "tile_cost on Laplace3D-128 (C=1024, sigma=1, sp), by a " \
            "replayed CUDA graph"
    for variant in scs_probe.VARIANTS:
        r = by[variant]
        lib = full_lib if variant == "full" else (
            None, "no one PyTorch call computes this variant")
        records[f"uspmv_scs_probe_{variant}"] = dict(
            source=PROBE_SOURCE, replaces="scripts/pallas_tile_cost.py:65",
            also_replaces=[], max_abs_err=r["max_abs_err"], ms=r["us"] / 1e3,
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=lib[0], library_error=lib[1],
            timed_on=timed + (", storing no row (threshold +inf); the error "
                              "with every row stored (-inf)"
                              if variant in scs_probe.THRESHOLDED else ""))
    r = by["unit"]
    records[scs_spmv.UNIT_ENTRY] = dict(
        source=KERNEL_SOURCE, replaces=PALLAS + ":858",
        also_replaces=[PALLAS + ":1558"], max_abs_err=r["max_abs_err"],
        ms=r["us"] / 1e3, plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=unit_lib[0],
        library_error=unit_lib[1],
        timed_on=timed + ", the all-ones pattern of the matrix")
    del split, op, x, unit
    torch.cuda.empty_cache()
    t_9b = time.perf_counter() - t0 - t_9a

    # ---- 9c. the C x sigma x bs sweep and the adaptive-precision table
    for mod, argv, m in (
            (perf_sweep, ["Laplace3D,128", "--bs_only", "--bench_time",
                          "0.05"], mtx),
            (perf_sweep, ["--bench_time", "0.02"], None),
            (ap_bench, ["Laplace3D,128", "--bench_time", "0.05"], mtx)):
        for r in mod.run(mod.build_parser().parse_args(argv), mtx=m):
            require(r["platform"] == "cuda" and r["gflops"] > 0,
                    f"{mod.__name__} {argv}: {r}")
            emit(mod.__name__.rsplit(".", 1)[1], card=card, **r)
    t_9c = time.perf_counter() - t0 - t_9a - t_9b
    emit("phase9", seconds_9a=t_9a, seconds_9b=t_9b, seconds_9c=t_9c,
         launches=launches)
    for entry, k in launches.items():
        require(k > 0, f"{entry} never launched in phase 9")
    return launches, records


# the halo exchange: the XLA hot path it replaces (not a Pallas kernel)
EXCHANGE_SOURCE = "uspmv_tpu_torch/csrc/halo_exchange.cu"
EXCHANGE_REPLACES = "uspmv_tpu/parallel/distributed.py:917-944"
# Laplace3D-128 split by rows into 4 shards of 32 planes: each inner shard
# needs one 128 x 128 plane from each neighbour, the outer ones one plane;
# the ring offsets 1 and 3 carry them, each padded to one plane per shard
LAPLACE128_R4_COMM = {"real": 6 * 128 * 128, "padded": 8 * 128 * 128}


def dist_plain(op, x):
    """A sharded op.spmv with every launch through its plain version, in
    op.spmv's order, into a new zeroed y (the exchange fills x's halo rows
    in place, as op.spmv does)."""
    import torch

    from uspmv_tpu_torch.ops.device_format import DevicePacked
    from uspmv_tpu_torch.ops.halo_exchange import halo_exchange_plain
    from uspmv_tpu_torch.ops.scs_packed import spmv_packed_plain
    from uspmv_tpu_torch.ops.scs_pieces import spmv_pieces_plain
    from uspmv_tpu_torch.ops.scs_spmv import spmv_scs_plain

    layout = op.config.vector_layout
    y = torch.zeros_like(x)
    for p in op.precisions:
        xp = op.x_for(p, x)
        ex = op.exchanges[p]
        if ex is not None and ex.n and op.config.comm_halos:
            halo_exchange_plain(ex, xp, layout)
        for r, sh in enumerate(op.streams[p]):
            xr = op.whole(xp) if op.halo_plans[p] is None \
                else op.shard_view(xp, r)
            for dev in (sh.main, sh.halo):
                if dev is not None:
                    plain = (spmv_packed_plain if isinstance(dev, DevicePacked)
                             else spmv_scs_plain)
                    plain(dev, xr, layout, op.shard_view(y, r,
                                                         dev.n_rows_padded))
            if sh.pieces is not None:
                spmv_pieces_plain(sh.pieces, xr, layout, op.shard_view(
                    y, r, sh.pieces.n_rows_padded))
    return y


def host_rel(got, want):
    import numpy as np

    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(np.asarray(got, dtype=np.float64) - want).max()
                 / np.abs(want).max())


def exchange_record(op, p, x, card, what):
    """The exchange kernel of precision p of ``op`` on the stacked x:
    bit-equal to its plain version, then the kernel, the plain version and
    the library pair index_select + index_copy_ timed by replayed CUDA
    graphs in turns. Returns the record for the kernels line."""
    import torch

    from uspmv_tpu_torch.ops import halo_exchange as hx

    ex = op.exchanges[p]
    layout = op.config.vector_layout
    # precision p's own buffer, its halo rows cleared
    x = op.x_for(p, x).clone()
    flat, dim = hx.flat_view(ex, x, layout)
    flat.index_fill_(dim, ex.dst.long(), 0)
    got, want = hx.halo_exchange(ex, x.clone(), layout), \
        hx.halo_exchange_plain(ex, x.clone(), layout)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"{what}: exchange != its plain version")
    require(not torch.equal(got, x), f"{what}: the exchange wrote nothing")
    max_abs = (got - want).abs().max().item()
    xk = got.clone()
    flat, dim = hx.flat_view(ex, xk, layout)
    dst64 = ex.dst.long()
    med, samples = time_turns({
        "kernel": lambda: graph_ms(lambda: hx.halo_exchange(ex, xk, layout),
                                   200),
        "plain": lambda: graph_ms(
            lambda: hx.halo_exchange_plain(ex, xk, layout), 200),
        "library": lambda: graph_ms(lambda: flat.index_copy_(
            dim, dst64, flat.index_select(dim, ex.src)), 200),
    })
    n_val = x.numel() // (ex.n_shards * ex.length)
    nbytes = ex.bound_bytes(x.element_size(), n_val)
    b_ms, b_by = bound(nbytes, 0, x.dtype)
    rec = dict(entry=hx._ENTRY_POINTS[x.dtype], pairs=ex.n,
               values_per_pair=n_val, bound_bytes=nbytes,
               max_abs_err=max_abs, ms=med["kernel"],
               plain_ms=med["plain"], library_ms=med["library"],
               library_error=None, bound_ms=b_ms, bound_by=b_by,
               timed_on=what)
    emit("halo_exchange", card=card, **rec, **samples)
    return rec


def phase10(mtx, card):
    """Phase 10: row-sharded execution on the card. ``mtx`` is the
    headline's Laplace3D-128. Each driven run (from_mtx, a validated solve,
    bench_spmv) sets the launch counts of every wrapper to 0 before and
    reads them after. Returns (the halo-exchange launches of those runs per
    entry point, {entry point: its record for the kernels line})."""
    import dataclasses

    import numpy as np
    import torch

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.io import generators
    from uspmv_tpu_torch.ops import halo_exchange as hx
    from uspmv_tpu_torch.ops import scs_packed, scs_pieces, scs_spmv
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator
    from uspmv_tpu_torch.parallel.partition import (
        halo_comm_volume,
        seg_work_sharing,
    )
    from uspmv_tpu_torch.runtime.bench import bench_solve, bench_spmv

    t_phase = time.perf_counter()
    wrappers = (scs_spmv, scs_packed, scs_pieces, hx)
    launches, records = {}, {}
    base = dict(kernel_format="scs", chunk_size=1024, sigma=1,
                value_type="sp", backend="cuda")
    rng = np.random.default_rng(10)

    def build(m, **kw):
        t0 = time.perf_counter()
        op = DistributedSpmvOperator.from_mtx(Config(**dict(base, **kw)), m)
        torch.cuda.synchronize()
        return op, time.perf_counter() - t0

    def drive(m, what, n_rev=5, l2_judged=False, **kw):
        """The entry points a user calls: from_mtx, a validated solve and
        one bench_spmv reading, with every launch count set to 0 before and
        read after; the halo exchange and a row kernel must have run."""
        for w in wrappers:
            w.reset_launch_count()
        op, build_s = build(m, **kw)
        rep, rep_l2 = validated_solve(op, m, n_rev, what, l2_judged=l2_judged)
        res = bench_spmv(op, bench_time=0.3)
        got = {}
        for w in wrappers:
            got.update({k: n for k, n in w.launch_counts().items() if n})
        require(any(k.startswith("uspmv_halo_exchange") for k in got),
                f"{what}: the halo exchange never launched: {got}")
        require(any(k.startswith(("uspmv_scs_spmv", "uspmv_scs_packed"))
                    for k in got), f"{what}: no row kernel launched: {got}")
        for k, n in got.items():
            if k.startswith("uspmv_halo_exchange"):
                launches[k] = launches.get(k, 0) + n
        info = dict(impl=op.impl_name(), build_s=build_s,
                    validation=rep.summary(), validation_l2=rep_l2.summary(),
                    main_path_launches=got,
                    comm=op.comm_volume_per_spmv())
        info.update(bench_gflops=res.perf_gflops,
                    bench_iterations=res.n_iterations,
                    bench_per_shard=res.per_shard)
        return op, info

    def check(op, x, x_host, want_host, tol, what):
        """y = op.spmv(x) against its plain version and against the
        single-device (or scipy) y on the host. Returns (y, fields)."""
        y = op.spmv(x)
        torch.cuda.synchronize()
        max_abs, rel = compare(y, dist_plain(op, x), tol, f"{what} vs plain")
        rel_want = host_rel(op.to_host(y), want_host)
        require(rel_want <= tol, f"{what}: vs the reference {rel_want:.3e}")
        return y, dict(max_abs_err=max_abs, rel_err_vs_plain=rel,
                       rel_err_vs_reference=rel_want)

    # ---- 10a. Laplace3D-128, sp, seg-rows, bulkvec, overlap on: R = 4, 8
    single = SpmvOperator.from_mtx(Config(**base), mtx)
    x_host = rng.standard_normal(mtx.n_rows)
    xs = single.make_x(x_host)
    ys = single.spmv(xs)
    y_single = single.to_host(ys)
    ops = {}
    for R in (4, 8):
        op, info = drive(mtx, f"Laplace3D-128 R={R}", n_shards=R)
        x = op.make_x(x_host)
        y, fields = check(op, x, x_host, y_single, TOL["sp"],
                          f"Laplace3D-128 R={R}")
        comm = info["comm"]["sp"]
        require(comm["real"] == halo_comm_volume(mtx, op.work_sharing),
                f"R={R}: comm volume {comm['real']}")
        if R == 4:
            require({k: comm[k] for k in ("real", "padded")}
                    == LAPLACE128_R4_COMM, f"R=4 comm volume {comm}")
        yo = torch.zeros_like(x)
        med, samples = time_turns({
            "sharded": lambda: graph_ms(lambda: op.spmv(x, out=yo), 50),
            "single": lambda: graph_ms(lambda: single.spmv(xs, out=ys), 50),
        })
        emit("dist_laplace128", R=R, **info, **fields,
             offsets=op.halo_plans["sp"].offsets, H=op.halo_plans["sp"].H,
             sharded_ms=med["sharded"], single_ms=med["single"], **samples,
             card=card)
        ops[R] = op
    op4 = ops.pop(4)
    del ops
    x4 = op4.make_x(x_host)
    y4 = op4.to_host(op4.spmv(x4))

    # overlap off (one launch per shard after the exchange) against on
    off, off_s = build(mtx, n_shards=4, overlap_comm=False)
    xo = off.make_x(x_host)
    _, fields = check(off, xo, x_host, y_single, TOL["sp"], "overlap off")
    yo, yf = torch.zeros_like(x4), torch.zeros_like(xo)
    med, samples = time_turns({
        "overlap_on": lambda: graph_ms(lambda: op4.spmv(x4, out=yo), 50),
        "overlap_off": lambda: graph_ms(lambda: off.spmv(xo, out=yf), 50),
    })
    emit("dist_overlap", R=4, impl_on=op4.impl_name(),
         impl_off=off.impl_name(), build_s_off=off_s, **fields,
         on_ms=med["overlap_on"], off_ms=med["overlap_off"], **samples,
         card=card)
    del off, xo, yf

    # the exchange kernel alone, on the R=4 plan (f32)
    rec = exchange_record(op4, "sp", op4.make_x(x_host), card,
                          "phase 10, Laplace3D-128 sp R=4 seg-rows, the "
                          "plan's 98,304 halo rows, replayed CUDA graphs")
    records[rec["entry"]] = rec

    # comm_halos=0 on the same streams: halo rows stay zero, y is wrong
    nohalo = dataclasses.replace(
        op4, config=dataclasses.replace(op4.config, comm_halos=False))
    y_wrong = nohalo.to_host(nohalo.spmv(nohalo.make_x(x_host)))
    ref = mtx.to_scipy().tocsr() @ x_host.astype(np.float32).astype(
        np.float64)
    rel_wrong = host_rel(y_wrong, ref)
    require(rel_wrong > 1e-2, f"comm_halos=0 gave y within {rel_wrong:.3e}")
    emit("dist_comm_halos_0", R=4, rel_err_vs_scipy=rel_wrong, card=card)
    del nohalo

    # k=64 solves by CUDA graph, sharded against single-device (x = 0:
    # the kernels' time does not depend on the values, and 64 products of
    # the unscaled Laplacian would overflow f32)
    sol = {}
    for name, o in (("sharded", op4), ("single", single)):
        res = bench_solve(o, 64, x=o.make_x(np.zeros(mtx.n_rows)),
                          bench_time=0.3)
        sol[name] = dict(impl=res.impl,
                         us_per_iteration=res.duration_kernel_s
                         / res.n_iterations * 1e6)
    emit("dist_solve_k64", R=4, **sol, card=card)

    # ap[dp_sp] (Laplace3D's 6.0 diagonal -> dp, the rest -> sp): the dp
    # stream needs no halo, the sp stream's exchange runs on f64 x
    ap, info = drive(mtx, "Laplace3D-128 R=4 ap[dp_sp]", n_shards=4,
                     value_type="ap[dp_sp]", ap_threshold_1=2.44)
    require(info["comm"]["dp"]["real"] == 0, f"ap: dp comm {info['comm']}")
    xa = ap.make_x(x_host)
    _, fields = check(ap, xa, x_host, mtx.to_scipy().tocsr() @ x_host,
                      TOL["sp"], "ap[dp_sp] R=4")
    # the sp stream's own x buffer takes the local rows of x every SpMV
    copy_bytes = 2 * ap.R * ap.n_rows_padded * xa.element_size()
    copy_ms = graph_ms(lambda: ap.x_for("sp", xa), 50)
    emit("dist_ap_dp_sp", R=4, **info, **fields, copy_in_ms=copy_ms,
         copy_in_bound_ms=bound(copy_bytes, 0, xa.dtype)[0], card=card)
    rec = exchange_record(ap, "sp", ap.make_x(x_host), card,
                          "phase 10, Laplace3D-128 ap[dp_sp] R=4: the sp "
                          "stream's halo rows in f64 x, replayed CUDA graphs")
    records[rec["entry"]] = rec
    del ap, xa

    # block vectors, bs=4 rowwise and colwise, against the one-vector op
    X = rng.standard_normal((mtx.n_rows, 4))
    cols = np.stack([op4.to_host(op4.spmv(op4.make_x(X[:, c])))
                     for c in range(4)], axis=1)
    for layout in ("rowwise", "colwise"):
        bop, build_s = build(mtx, n_shards=4, block_vec_size=4,
                             vector_layout=layout)
        _, fields = check(bop, bop.make_x(X), X, cols, TOL["sp"],
                          f"bs=4 {layout} R=4")
        emit("dist_block_vectors", R=4, layout=layout, bs=4,
             impl=bop.impl_name(), build_s=build_s, **fields, card=card)
        del bop

    # allgather: no plan, every shard reads the whole stacked x
    ag, build_s = build(mtx, n_shards=4, comm_mode="allgather")
    _, fields = check(ag, ag.make_x(x_host), x_host, y4, TOL["sp"],
                      "allgather R=4")
    emit("dist_allgather", R=4, build_s=build_s, **fields,
         comm=ag.comm_volume_per_spmv(), card=card)
    del ag, op4, x4, single, xs, ys

    # ---- 10b. RandomImbalanced-500k, R=4, seg-nnz: packed rows and pieces
    ri = generators.random_imbalanced(500_000, 8)
    one = SpmvOperator.from_mtx(Config(**base), ri)
    xr_host = rng.standard_normal(ri.n_rows)
    y_one = one.to_host(one.spmv(one.make_x(xr_host)))
    rop, info = drive(ri, "RandomImbalanced-500k R=4", n_rev=1,
                      l2_judged=True, n_shards=4, seg_method="seg-nnz")
    require("packed" in rop.impl_name() and "+pieces" in rop.impl_name(),
            f"RandomImbalanced R=4 runs {rop.impl_name()}")
    longest = int(np.bincount(ri.I, minlength=ri.n_rows).max())
    xr = rop.make_x(xr_host)
    tol = long_row_tol(xr, longest)
    _, fields = check(rop, xr, xr_host, y_one, tol, "RandomImbalanced R=4")
    comm = info["comm"]["sp"]
    require(comm["real"] == halo_comm_volume(ri, rop.work_sharing),
            f"RandomImbalanced comm volume {comm}")
    yr, xo1 = torch.zeros_like(xr), one.make_x(xr_host)
    yo1 = torch.zeros_like(xo1)
    med, samples = time_turns({
        "sharded": lambda: graph_ms(lambda: rop.spmv(xr, out=yr), 50),
        "single": lambda: graph_ms(lambda: one.spmv(xo1, out=yo1), 50),
    })
    emit("dist_random_imbalanced", R=4, **info, **fields, tol=tol,
         n_pieces=rop.n_pieces(), single_impl=one.impl_name(),
         sharded_ms=med["sharded"], single_ms=med["single"], **samples,
         card=card)
    del ri, one, rop, xr, yr, xo1, yo1

    # ---- 10c. the CLI, two processes at once, beside 10d (which times
    # nothing on the card)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "uspmv_tpu_torch", "phase10_cli")
    os.makedirs(out_dir, exist_ok=True)
    cli = [sys.executable, "-m", "uspmv_tpu_torch.cli"]
    runs = {
        "solve": cli + ["Laplace3D,128", "scs", "-c", "1024", "-sp",
                        "-n_shards", "4", "-mode", "s", "-validate", "1",
                        "-mtx_out", out_dir],
        "bench": cli + ["Laplace3D,64", "scs", "-c", "1024", "-sp",
                        "-n_shards", "4", "-mode", "b", "-print_comm_vol",
                        "1", "-bench_time", "0.2", "-mtx_out", out_dir],
    }
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 cwd=os.path.dirname(os.path.abspath(
                                     __file__)))
             for k, cmd in runs.items()}
    try:
        # ---- 10d. seg-metis against seg-nnz on Laplace3D-64
        m64 = generators.laplace3d(64)
        t0 = time.perf_counter()
        seg_work_sharing(m64, 4, "seg-metis")
        metis_s = time.perf_counter() - t0
        x64 = rng.standard_normal(m64.n_rows)
        ref64 = m64.to_scipy().tocsr() @ x64.astype(np.float32).astype(
            np.float64)
        vols = {}
        for seg in ("seg-metis", "seg-nnz"):
            o, build_s = build(m64, n_shards=4, seg_method=seg)
            _, fields = check(o, o.make_x(x64), x64, ref64, TOL["sp"],
                              f"Laplace3D-64 {seg}")
            vols[seg] = o.comm_volume_per_spmv()["sp"]
            emit("dist_seg", matrix="Laplace3D,64", seg=seg,
                 build_s=build_s, comm=vols[seg],
                 permuted=o.global_perm is not None, **fields, card=card)
            del o
        require(vols["seg-metis"]["real"] <= vols["seg-nnz"]["real"],
                f"seg-metis moved more than seg-nnz: {vols}")
        emit("dist_seg_metis", matrix="Laplace3D,64", partition_s=metis_s,
             real_metis=vols["seg-metis"]["real"],
             real_nnz=vols["seg-nnz"]["real"], card=card)

        # the CLI's output (10c)
        outs = {k: p.communicate(timeout=300) for k, p in procs.items()}
    finally:  # no process outlives the phase
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k, p in procs.items():
        require(p.returncode == 0, f"CLI {k}: rc {p.returncode}: "
                f"{outs[k][1][-2000:]}")
    require("[OK]" in outs["solve"][0],
            f"CLI solve: {outs['solve'][0][-2000:]}")
    require("shard 3: nnz=" in outs["bench"][0]
            and "comm volume:" in outs["bench"][0],
            f"CLI bench: {outs['bench'][0][-2000:]}")
    emit("dist_cli", solve=outs["solve"][0].strip().splitlines()[-3:],
         bench=[ln for ln in outs["bench"][0].splitlines()
                if "shard" in ln or "comm volume" in ln or "perf:" in ln],
         card=card)
    emit("phase10", seconds=time.perf_counter() - t_phase,
         halo_exchange_launches=launches)
    return launches, records


AUX_MATRICES = ("Hubbard,n_sites=13,n_fermions=6,U=1.3", "StokesSaddle,64")
AUX_SMALL = "Hubbard,n_sites=8,n_fermions=4,U=1.3"
AUX_DIR = os.path.join("build", "uspmv_tpu_torch", "chip_smoke_aux")
SELL_KERNEL = "scs_spmv_kernel"  # the SELL-C-sigma kernel of KERNEL_SOURCE


def cli_run(argv):
    """``uspmv_tpu_torch.cli.main(argv)`` with its standard output caught:
    (rc, the output, the JSON object of its last line or None)."""
    import contextlib
    import io

    from uspmv_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    text = buf.getvalue()
    lines = text.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    return rc, text, last


def cli_solve(argv, what):
    """A validated solve through the CLI (-json): its rc must be 0 and its
    flag OK. Returns (validation summary fields, impl)."""
    rc, text, last = cli_run([*argv, "-mode", "s", "-validate", "1",
                              "-json"])
    require(rc == 0 and last is not None
            and last["validation"]["flag"] == "OK",
            f"{what}: rc {rc}, {text[-600:]}")
    return last["validation"], last["impl"]


def cli_bench(argv, what):
    """Bench mode through the CLI (-json): the BenchResult's fields."""
    rc, text, last = cli_run([*argv, "-mode", "b", "-json"])
    require(rc == 0 and last is not None and last["perf_gflops"] > 0,
            f"{what}: rc {rc}, {text[-600:]}")
    return last


def aux_matrix(spec, card, rng):
    """Phase 11a: one generated matrix of the ScaMaC or Stokes class through
    the main path at sp, C=1024, sigma=1, default tiers: driven as a user
    would (from_mtx, a solve of 1 repetition validated per element, 0.3 s
    of bench_spmv) with the launch counts set to 0 before and read after;
    then op.spmv against its plain version and scipy, the other tier and
    BcooSpmvOperator (cuSPARSE) against it, and the three timed in turns:
    op.spmv and the other tier by replayed CUDA graphs, cuSPARSE by CUDA
    events. Returns the record."""
    import dataclasses
    import warnings

    import numpy as np
    import torch

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.config import dtype_for
    from uspmv_tpu_torch.io.generators import generate_matrix
    from uspmv_tpu_torch.ops.spmv_bcoo import BcooSpmvOperator
    from uspmv_tpu_torch.runtime.bench import bench_spmv

    what = f"11a {spec}"
    t0 = time.perf_counter()
    mtx = generate_matrix(spec)
    gen_s = time.perf_counter() - t0
    counts = np.bincount(mtx.I, minlength=mtx.n_rows)
    cfg = Config(kernel_format="scs", chunk_size=1024, sigma=1,
                 value_type="sp", backend="cuda")
    reset_tier_launch_counts()
    t0 = time.perf_counter()
    op = SpmvOperator.from_mtx(cfg, mtx)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rep, rep_l2 = validated_solve(op, mtx, 1, what)
    res = bench_spmv(op, bench_time=0.3)
    launches = {k: v for k, v in tier_launch_counts().items() if v}
    require(sum(launches.values()) >= res.n_iterations * len(op.devs),
            f"{what}: {launches} launches for {res.n_iterations} iterations")

    x_host = rng.standard_normal(mtx.n_rows)
    x = op.make_x(x_host)
    y = op.spmv(x)
    tol = long_row_tol(x, float(counts.max()))
    max_abs, rel = compare(y, plain_spmv(op, x), tol, what)
    rel_scipy = vs_scipy(op, mtx, x_host, y, tol, what)
    y_host = torch.from_numpy(op.to_host(y))

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        other = SpmvOperator.from_mtx(
            dataclasses.replace(cfg, mixed_tiles=not op.is_packed()), mtx)
    other_build_s = time.perf_counter() - t0
    x_o = other.make_x(x_host)
    compare(torch.from_numpy(other.to_host(other.spmv(x_o))), y_host, tol,
            f"{what}: the other tier against op.spmv")
    t0 = time.perf_counter()
    bop = BcooSpmvOperator.from_mtx(dataclasses.replace(cfg, impl="bcoo"),
                                    mtx)
    torch.cuda.synchronize()
    bcoo_build_s = time.perf_counter() - t0
    x_b = bop.make_x(x_host)
    compare(torch.from_numpy(bop.to_host(bop.spmv(x_b))), y_host, tol,
            f"{what}: cuSPARSE against op.spmv")

    out, out_o = torch.empty_like(x), torch.empty_like(x_o)
    reps = 50
    med, fields = time_turns({
        "kernel": lambda: graph_ms(lambda: op.spmv(x, out=out), reps),
        "other_tier": lambda: graph_ms(lambda: other.spmv(x_o, out=out_o),
                                       reps),
        "cusparse": lambda: time_ms(lambda: bop.spmv(x_b), reps),
    })
    # bound: the function's own bytes, each stored nonzero's value and
    # int32 column, x and y once; moved: what the tier streams, padding
    # included (bytes_per_spmv)
    flops, nbytes = op.flops_per_spmv(), op.bytes_per_spmv()
    val_b = torch.empty((), dtype=dtype_for(cfg.value_type)).element_size()
    fn_bytes = (mtx.nnz * (val_b + 4)
                + (mtx.n_rows + mtx.n_cols) * x.element_size())
    b_ms, b_by = bound(fn_bytes, flops, x.dtype)
    ms = med["kernel"]
    rec = dict(
        matrix=spec, n_rows=mtx.n_rows, nnz=mtx.nnz,
        min_row_nnz=int(counts.min()), max_row_nnz=int(counts.max()),
        mean_row_nnz=float(counts.mean()), generate_s=gen_s,
        operator_build_s=build_s, tier=op.impl_name(),
        beta=op.beta()["sp"], device_beta=op.device_beta()["sp"],
        split_rows_threshold=op.split_threshold, n_pieces=op.n_pieces(),
        validation=rep.summary(), validation_l2=rep_l2.summary(),
        bench_gflops=res.perf_gflops, bench_gbps=res.effective_gbps,
        n_iterations=res.n_iterations, main_path_launches=launches,
        max_abs_err=max_abs, rel_err=rel, rel_err_vs_scipy=rel_scipy,
        tol=tol, spmv_graph_ms=ms, gflops=flops / ms / 1e6,
        gbps=nbytes / ms / 1e6, moved_bytes=nbytes, bound_bytes=fn_bytes,
        bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
        moved_share=nbytes / HBM_BYTES_PER_S * 1e3 / ms,
        other_tier=other.impl_name(), other_tier_build_s=other_build_s,
        other_tier_graph_ms=med["other_tier"],
        other_tier_bytes_per_spmv=other.bytes_per_spmv(),
        cusparse_ms=med["cusparse"], cusparse_build_s=bcoo_build_s,
        cusparse_impl=bop.impl_name(), **fields, card=card)
    del op, other, bop, mtx
    torch.cuda.empty_cache()
    return rec


def read_coo_set(path):
    """The (row, col, value) triples of an .mtx file, sorted, as arrays."""
    import numpy as np

    from uspmv_tpu_torch.io.mmio import read_mtx

    m = read_mtx(path, native=False)
    order = np.lexsort((m.values, m.J, m.I))
    return m.I[order], m.J[order], m.values[order]


def aux_flags(card):
    """Phase 11d: -matrix_stats, -output_sparsity (split rows: the pieces
    folded back) and -debug 1 on a small Hubbard matrix; -log_prof on the
    headline's bench, whose trace must hold the marker and the SELL
    kernel's own name, with the profiler's cost against a bench without
    it."""
    import glob

    import numpy as np

    from uspmv_tpu_torch.config import host_values
    from uspmv_tpu_torch.formats.stats import get_matrix_stats
    from uspmv_tpu_torch.io.generators import generate_matrix
    from uspmv_tpu_torch.ops import scs_spmv
    from uspmv_tpu_torch.runtime import profiling

    rec = {}
    small = generate_matrix(AUX_SMALL)
    rc, text, _ = cli_run([AUX_SMALL, "scs", "-matrix_stats"])
    require(rc == 0 and text.strip() == get_matrix_stats(small).summary(),
            f"-matrix_stats: rc {rc}, {text[-400:]}")
    rec["matrix_stats"] = text.strip().splitlines()

    out_dir = os.path.join(AUX_DIR, "sparsity")
    os.makedirs(out_dir, exist_ok=True)
    for f in glob.glob(os.path.join(out_dir, "*.mtx")):
        os.remove(f)
    rc, text, _ = cli_run([AUX_SMALL, "scs", "-c", "32", "-s", "64", "-sp",
                           "-split_rows_threshold", "4", "-output_sparsity",
                           "-mtx_out", out_dir])
    path = os.path.join(out_dir, "sp_local_scs.mtx")
    require(rc == 0 and os.path.exists(path), f"-output_sparsity: rc {rc}")
    vals = host_values(small.values, "sp")
    keep = vals != 0
    order = np.lexsort((vals[keep], small.J[keep], small.I[keep]))
    want = (small.I[keep][order], small.J[keep][order], vals[keep][order])
    got = read_coo_set(path)
    # the file prints the f32 values to 16 digits: equal once rounded back
    got = (got[0], got[1], got[2].astype(np.float32))
    require(all(np.array_equal(a, b) for a, b in zip(got, want)),
            "-output_sparsity: the file is not the matrix's nonzeros")
    rec["output_sparsity"] = dict(file=path, nnz=int(got[0].size),
                                  equal_as_set=True)

    rc, text, _ = cli_run([AUX_SMALL, "scs", "-c", "32", "-sp", "-mode", "s",
                           "-rev", "2", "-debug", "1", "-mtx_out", AUX_DIR])
    dump = os.path.join(AUX_DIR, "uspmv_debug_rank0.log")
    require(rc == 0 and "[debug] sanity dumps" in text
            and os.path.exists(dump), f"-debug 1: rc {rc}, {text[-400:]}")
    with open(dump) as f:
        lines = f.read().splitlines()
    require(any("before_solve.x" in ln for ln in lines)
            and any("after_solve.y" in ln for ln in lines),
            f"-debug 1: dump {lines[:4]}")
    rec["debug"] = dict(dump=dump, lines=len(lines), check_finite="passed")

    head = ["Laplace3D,128", "scs", "-c", "1024", "-s", "1", "-sp",
            "-bench_time", "0.2", "-mtx_out", AUX_DIR]
    prof_dir = os.path.join(AUX_DIR, "prof")
    off = cli_bench(head, "-log_prof off")
    n0 = scs_spmv.launch_count()
    on = cli_bench([*head, "-log_prof", prof_dir], "-log_prof on")
    launched = scs_spmv.launch_count() - n0
    trace = profiling.last_trace_path()
    require(trace is not None and os.path.exists(trace),
            f"-log_prof: no trace in {prof_dir}")
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    marker = [e for e in events if e.get("name") == "spmv_scs_benchmark"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and SELL_KERNEL in e.get("name", "")]
    require(marker, "-log_prof: the trace holds no spmv_scs_benchmark range")
    require(kernels, f"-log_prof: the trace names no {SELL_KERNEL} (CUPTI "
            "did not record the kernel launched through ctypes)")
    dur = [e["dur"] for e in kernels if "dur" in e]
    rec["log_prof"] = dict(
        trace=trace, trace_bytes=os.path.getsize(trace),
        events=len(events), marker_ranges=len(marker),
        sell_kernel_events=len(kernels), sell_kernel_launches=launched,
        sell_kernel_name=kernels[0]["name"],
        sell_kernel_median_us=float(np.median(dur)) if dur else None,
        gflops_off=off["perf_gflops"], gflops_on=on["perf_gflops"],
        profiler_cost=off["perf_gflops"] / on["perf_gflops"] - 1.0,
        n_iterations_off=off["n_iterations"],
        n_iterations_on=on["n_iterations"])
    os.remove(trace)
    rec["card"] = card
    return rec


def aux_native(mtx, card):
    """Phase 11e: the native host library against the Python paths:
    read_mtx of a written Laplace3D-64 and convert_to_scs of the headline,
    bit-equal, with the seconds of each; from_mtx of the headline with the
    native path on and off."""
    import dataclasses

    import numpy as np
    import torch

    from uspmv_tpu_torch import Config, SpmvOperator, native
    from uspmv_tpu_torch.config import host_values
    from uspmv_tpu_torch.formats.scs import convert_to_scs
    from uspmv_tpu_torch.io.generators import laplace3d
    from uspmv_tpu_torch.io.mmio import read_mtx, write_mtx

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def same(a, b, what):
        for k, v in dataclasses.asdict(a).items():
            w = getattr(b, k)
            if isinstance(v, np.ndarray):
                ok = v.dtype == w.dtype and np.array_equal(v, w)
            else:
                ok = v == w
            require(ok, f"{what}: native and Python differ in {k}")

    _, lib_s = timed(lambda: native.load(required=True))
    path = os.path.join(AUX_DIR, "laplace3d_64.mtx")
    m64 = laplace3d(64)
    _, write_s = timed(lambda: write_mtx(path, m64))
    a, read_native_s = timed(lambda: read_mtx(path, native=True))
    b, read_python_s = timed(lambda: read_mtx(path, native=False))
    same(a, b, "read_mtx")
    os.remove(path)
    sp = dataclasses.replace(mtx, values=host_values(mtx.values, "sp"))
    a, conv_native_s = timed(lambda: convert_to_scs(sp, 1024, 1, native=True))
    b, conv_python_s = timed(lambda: convert_to_scs(sp, 1024, 1,
                                                    native=False))
    same(a, b, "convert_to_scs")
    del a, b
    cfg = Config(kernel_format="scs", chunk_size=1024, sigma=1,
                 value_type="sp", backend="cuda")
    build = {}
    for label in ("native", "python", "native_again"):
        if label == "python":
            os.environ["USPMV_DISABLE_NATIVE"] = "1"
        try:
            def run():
                op = SpmvOperator.from_mtx(cfg, mtx)
                torch.cuda.synchronize()
                return op
            _, build[label] = timed(run)
        finally:
            os.environ.pop("USPMV_DISABLE_NATIVE", None)
    torch.cuda.empty_cache()
    return dict(library=str(native.library_path()), load_s=lib_s,
                mtx_rows=m64.n_rows, mtx_nnz=m64.nnz, write_mtx_s=write_s,
                read_native_s=read_native_s, read_python_s=read_python_s,
                convert_native_s=conv_native_s,
                convert_python_s=conv_python_s,
                from_mtx_native_s=build["native"],
                from_mtx_python_s=build["python"],
                from_mtx_native_again_s=build["native_again"],
                bit_equal=True, card=card)


def aux_scripts(card):
    """Phase 11f: check_dp_emu and validate_campaign --quick on the card,
    through their entry points, their rows read back."""
    from uspmv_tpu_torch.scripts import check_dp_emu, validate_campaign

    rec = {}
    for name, mod, argv in (
            ("check_dp_emu", check_dp_emu, ["--bench_time", "0.3"]),
            ("validate_campaign", validate_campaign, ["--quick"])):
        out = os.path.join(AUX_DIR, f"{name}.jsonl")
        if os.path.exists(out):
            os.remove(out)
        t0 = time.perf_counter()
        rc, text = _script_run(mod, [*argv, "--backend", "cuda",
                                     "--out", out])
        seconds = time.perf_counter() - t0
        with open(out) as f:
            rows = [json.loads(ln) for ln in f]
        require(rc == 0 and rows, f"{name}: rc {rc}, {text[-800:]}")
        rec[name] = dict(seconds=seconds, rows=len(rows))
        if name == "check_dp_emu":
            rec[name]["results"] = rows
        else:
            rec[name]["failures"] = sum(r["rc"] != 0 for r in rows)
            require(rec[name]["failures"] == 0, f"{name}: failures")
            # every run on the card: the kernels or the vendor comparison
            on_card = [r for r in rows if r["impl"] and (
                "[cuda-" in r["impl"] or "[cusparse-" in r["impl"])]
            require(len(on_card) == len(rows),
                    f"{name}: {len(rows) - len(on_card)} runs off the card")
            rec[name]["impls"] = sorted({r["impl"] for r in rows})
    rec["card"] = card
    return rec


def _script_run(mod, argv):
    """An entry point's main(argv) with its standard output caught."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


def phase11(mtx, card):
    """Phase 11: the auxiliaries on the card. ``mtx`` is the headline's
    Laplace3D-128. Returns the SpMV wrappers' launches of the driven runs
    of 11a."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    os.makedirs(AUX_DIR, exist_ok=True)
    rng = np.random.default_rng(11)
    launches = {}
    # a. ScaMaC's Hubbard and the Stokes saddle point through the main path
    for spec in AUX_MATRICES:
        rec = aux_matrix(spec, card, rng)
        for k, v in rec["main_path_launches"].items():
            launches[k] = launches.get(k, 0) + v
        emit("aux_matrix", **rec)
    # b, c. -impl bcoo (cuSPARSE) and -impl xla (the plain path) through
    # the CLI on the headline, beside the kernel path
    head = ["Laplace3D,128", "scs", "-c", "1024", "-s", "1", "-mtx_out",
            AUX_DIR]
    rows = []
    for label, flags in (("kernels", ["-sp"]),
                         ("bcoo sp", ["-sp", "-impl", "bcoo"]),
                         ("bcoo hp", ["-hp", "-impl", "bcoo"]),
                         ("xla sp", ["-sp", "-impl", "xla"])):
        row = dict(run=label)
        if label != "kernels":
            val, impl = cli_solve([*head, *flags, "-rev", "5"],
                                  f"11b/c {label} solve")
            row.update(solve_impl=impl, validation=val["flag"],
                       max_rel=val["max_rel_diff"])
        res = cli_bench([*head, *flags, "-bench_time", "0.3"],
                        f"11b/c {label} bench")
        row.update(impl=res["impl"], gflops=res["perf_gflops"],
                   gbps=res["effective_gbps"],
                   bytes_per_spmv=res["memory_footprint_bytes"],
                   ms_per_spmv=res["duration_kernel_s"]
                   / res["n_iterations"] * 1e3)
        rows.append(row)
    want = {"kernels": "cuda-scs-sp", "bcoo sp": "cusparse-csr-sp",
            "bcoo hp": "cusparse-csr-hp", "xla sp": "torch-plain-scs-sp"}
    for row in rows:
        require(row["impl"] == want[row["run"]],
                f"11b/c {row['run']}: ran {row['impl']}")
    emit("aux_impls", matrix="Laplace3D,128", runs=rows, card=card)
    torch.cuda.empty_cache()
    # d. the flags
    emit("aux_flags", **aux_flags(card))
    # e. the native host library
    emit("aux_native", **aux_native(mtx, card))
    # f. the scripts
    emit("aux_scripts", **aux_scripts(card))
    emit("phase11", seconds=time.perf_counter() - t_phase,
         main_path_launches=launches)
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from uspmv_tpu_torch import Config, SpmvOperator, native
    from uspmv_tpu_torch.io.generators import (
        generate_matrix,
        laplace3d,
        random_banded,
    )
    from uspmv_tpu_torch.ops import _build, scs_pieces
    from uspmv_tpu_torch.ops.scs_spmv import (
        launch_count,
        launch_counts,
        reset_launch_count,
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

    # the native host library (g++) builds while nvcc builds the kernels;
    # whether the default ingest runs native is part of every set-up time
    host_lib = threading.Thread(target=native.available)
    host_lib.start()
    lib = _build.load_library()
    host_lib.join()
    emit("build", seconds=lib.build_seconds, built=lib.built,
         library=str(lib.path),
         ptxas=[ln.strip() for ln in lib.log.splitlines()
                if "registers" in ln or "Compiling entry" in ln],
         native_host_library=native.available(),
         native_error=native._error)
    # registers and local memory (spills) of the row-sum kernels
    resources = [r for r in _build.kernel_resources(lib.path)
                 if any(k in r["function"] for k in ROW_SUM_KERNELS)]
    require({k for k in ROW_SUM_KERNELS
             if any(k in r["function"] for r in resources)}
            == set(ROW_SUM_KERNELS),
            f"cuobjdump: row-sum kernels missing from {resources}")
    emit("kernel_resources", kernels=resources)

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

    # ---- 3c. the heavy-row pieces and packed-row kernels, small shapes
    small_tiers()

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
    rep, _ = validated_solve(op, mtx, 5, "headline solve")
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
    flops, nbytes = op.flops_per_spmv(), op.bytes_per_spmv()
    b_ms, b_by = bound(nbytes, flops, x.dtype)
    lib_ms, lib_err, samples = sell_vs_library(dev, op, x, y, 200)
    ms, plain_ms = samples.pop("kernel_ms"), samples.pop("plain_ms")
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
         rel_err_vs_scipy=rel_scipy, bound_ms=b_ms, bound_by=b_by,
         library_ms=lib_ms, library_error=lib_err, card=card)
    headline_ms = ms
    stream_records = {("headline", "sp"): dict(
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, library_error=lib_err)}
    del op, dev, x, y
    torch.cuda.empty_cache()

    # ---- 5. large x (on the TPU: the windowed kernel's regime)
    big = laplace3d(160)
    op = SpmvOperator.from_mtx(cfg, big)
    (dev,) = op.devs.values()
    x_host = rng.standard_normal(big.n_rows)
    x = op.make_x(x_host)
    y, max_abs, rel = kernel_vs_plain(dev, x, TOL["sp"], "large x")
    rel_scipy = vs_scipy(op, big, x_host, y, TOL["sp"], "large x")
    rep, _ = validated_solve(op, big, 1, "large-x solve")
    b_ms, b_by = bound(op.bytes_per_spmv(), op.flops_per_spmv(), x.dtype)
    lib_ms, lib_err, samples = sell_vs_library(dev, op, x, y, 100)
    ms, plain_ms = samples.pop("kernel_ms"), samples.pop("plain_ms")
    emit("large_x", matrix="Laplace3D,160", n_rows=op.n_rows, nnz=op.nnz,
         x_bytes=op.n_rows_padded * 4, max_abs_err=max_abs, rel_err=rel,
         rel_err_vs_scipy=rel_scipy, validation=rep.summary(),
         kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
         library_ms=lib_ms, library_error=lib_err, **samples, card=card)
    del op, dev, x, y, big
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

    # ---- 7a. solve mode on small shapes: fused vs loop vs plain, graph
    solve_small(cuda)
    graph_small(rng)

    # ---- 7b. path F: solve at full size through the entry points
    lap_scaled = mtx.copy()
    lap_scale = unit_row_sums(lap_scaled)
    fem55 = generate_matrix("FemTet3D,55")
    fem55_scaled = fem55.copy()
    fem55_scale = unit_row_sums(fem55_scaled)
    fem9 = generate_matrix("FemTet3D,9")
    fem9_scale = unit_row_sums(fem9)
    solve_launches = {}
    replayed = {}
    # ap[dp_sp] thresholds: Laplace3D's 6.0 diagonal, FemTet3D's diagonal
    # (> 1.05 >= every off-diagonal) -> dp, the rest -> sp. Laplace3D's
    # solves are validated on the unscaled matrix from the default x, per
    # element. FemTet3D's are not: its constant vector is the eigenvector
    # of the smallest eigenvalue, and 5 repetitions amplify an f32 rounding
    # of it by (largest / smallest eigenvalue)^5 ~ 89^5, scaled or not.
    for spec, m, scale, thr, unscaled in (
            ("Laplace3D,128", lap_scaled, lap_scale, 2.44, mtx),
            ("FemTet3D,55", fem55_scaled, fem55_scale, 1.05, None),
            ("FemTet3D,9", fem9, fem9_scale, 1.05, None)):
        spmv_counts, fused_counts, nodes = solve_path(spec, m, scale, thr,
                                                      card, unscaled)
        for entry, n in spmv_counts.items():
            main_launches[entry] += n
        for entry, n in fused_counts.items():
            solve_launches[entry] = solve_launches.get(entry, 0) + n
        for entry, n in nodes.items():
            replayed[entry] = replayed.get(entry, 0) + n
    del fem55_scaled, fem9
    solve_records = {}
    for entry, value_type in SOLVE_INSTANTIATIONS.items():
        got, rec, n = fused_record(lap_scaled, mtx, value_type, card)
        require(got == entry, f"{value_type} ran {got}, expected {entry}")
        solve_launches[entry] = solve_launches.get(entry, 0) + n
        solve_records[entry] = rec
        torch.cuda.empty_cache()

    # ---- 7c. the library surface and the CG example
    interface_and_cg(mtx, lap_scaled, rng, card)
    del lap_scaled

    # ---- 8. path G: imbalanced rows at full size
    tier_launches, tier_records = path_g({"FemTet3D,55": fem55}, card)
    del fem55
    torch.cuda.empty_cache()

    # ---- 9. the last TPU kernels: x access, cost split, unit stream, sweeps
    probe_launches, probe_records = phase9(mtx, headline_ms, card)

    # ---- 10. row-sharded execution: R shards on the card, halo exchange
    dist_launches, dist_records = phase10(mtx, card)

    # ---- 11. the auxiliaries: ScaMaC/Stokes, bcoo, xla, flags, native
    phase11(mtx, card)

    kernels = []
    for entry, (replaces, path, prec) in INSTANTIATIONS.items():
        rec = stream_records[(path, prec)]
        require(main_launches[entry] > 0, f"{entry} never launched")
        kernels.append({
            "name": entry.replace("uspmv_", ""), "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": PALLAS + replaces[0],
            "also_replaces": [PALLAS + r for r in replaces[1:]],
            "launches": main_launches[entry],
            "graph_nodes_replayed": replayed.get(entry, 0),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_error": rec["library_error"],
            "timed_on": f"path {path}, {prec} stream",
        })
    for entry, value_type in SOLVE_INSTANTIATIONS.items():
        rec = solve_records[entry]
        require(solve_launches[entry] > 0, f"{entry} never launched")
        kernels.append({
            "name": entry.replace("uspmv_", ""), "route": "cuda",
            "source": SOLVE_SOURCE, "replaces": PALLAS + ":1898",
            "launches": solve_launches[entry],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "library_error": rec["library_error"],
            "timed_on": f"path F, Laplace3D-128 {value_type}, one launch "
                        f"of k={rec['k']} iterations",
            "us_per_iteration": rec["us_per_iteration"],
            "bound_us_per_iteration": rec["bound_us_per_iteration"],
            "bound_bytes": rec["bound_bytes"],
        })
    for entry, (replaces, run, stream) in TIER_INSTANTIATIONS.items():
        rec = tier_records[(run, entry)]
        require(rec["stream"] == stream, f"{entry}: timed on {rec['stream']}")
        require(tier_launches.get(entry, 0) > 0, f"{entry} never launched")
        pieces = "pieces" in entry
        kernels.append({
            "name": entry.replace("uspmv_", ""), "route": "cuda",
            "source": PIECES_SOURCE if pieces else PACKED_SOURCE,
            "replaces": PALLAS + replaces,
            "also_replaces": [PALLAS + ":1201"] if pieces else [],
            "launches": tier_launches[entry],
            "kernels_per_launch": (scs_pieces.KERNELS_PER_LAUNCH if pieces
                                   else 1),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_error": rec["library_error"],
            "timed_on": f"path G, RandomImbalanced-500k C=1024 sigma=1 "
                        f"{run}, {stream} stream, by a replayed CUDA graph",
            "bound_bytes": rec["bound_bytes"], "nnz": rec["nnz"],
            "gather_floor_upper_ms": rec.get("gather_store_ms"),
        })
    for entry, rec in probe_records.items():
        kernels.append({
            "name": entry.replace("uspmv_", ""), "route": "cuda",
            "source": rec["source"], "replaces": rec["replaces"],
            "also_replaces": rec["also_replaces"],
            "launches": probe_launches[entry],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_error": rec["library_error"],
            "timed_on": rec["timed_on"],
        })
    for entry, rec in dist_records.items():
        require(dist_launches.get(entry, 0) > 0, f"{entry} never launched")
        kernels.append({
            "name": entry.replace("uspmv_", ""), "route": "cuda",
            "source": EXCHANGE_SOURCE, "replaces": EXCHANGE_REPLACES,
            "replaces_kind": "XLA hot path (jnp.take, ppermute, "
                             ".at[].set), not a Pallas kernel",
            "launches": dist_launches[entry],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_call": "index_select + index_copy_",
            "library_error": rec["library_error"],
            "timed_on": rec["timed_on"], "pairs": rec["pairs"],
            "bound_bytes": rec["bound_bytes"],
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
