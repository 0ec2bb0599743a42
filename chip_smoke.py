#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (uspmv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA device, nvcc and
nvidia-smi. Phases, each printing JSON lines:

  1. environment: torch, CUDA, nvcc, and the card's name and power limit;
  2. build: nvcc compiles uspmv_tpu_torch/csrc/*.cu for sm_90a, one
     process per source, all at once (the seconds of each); the
     registers and local memory of the row-sum kernels (cuobjdump);
  3. kernel vs plain, small shapes:
     a. the sp and dp operators on Laplace3D-32 at (C, sigma) in
        {(1024, 1), (32, 512), (1, 1)} and RandomBanded-200k at (1024, 1);
     b. every instantiated (values, x) dtype pair of the kernel, one vector,
        bs in {4, 8} rowwise and bs in {3, 4, 8, 16} colwise, each plain and
        in the accumulate form y += A x, on Laplace3D-32 and
        RandomBanded-200k; each colwise block bit-equal to one launch per
        vector and to the rowwise form of the same block (3d likewise);
     c. the heavy-row pieces and packed-row kernels (slice 5) through
        operators on a 4,600-row imbalanced matrix at C=32, sigma=64 (one
        row of 3,000+ elements, 600 empty rows at the end: whole row groups
        without elements): sp, dp, hp and ap[dp_sp_hp] (all five dtype
        pairs of the pieces, all three of the packed rows), split
        thresholds 2 (a row with more pieces than a warp has lanes), 32
        and 1024, one vector, rowwise bs 4 and 8 and colwise bs 4 and 9,
        the write and the accumulate form; each kernel against its plain
        version, and twice in a row bit-equal (the pieces' counters and
        slots back at 0), each block vector of the pieces bit-equal to a
        one-vector launch;
     d. padded streams: path E's configuration on WideSpectrum-20 (three
        streams whose groups of 16 rows are shorter than their chunks),
        every (values, x) pair, layout and the accumulate form against the
        plain version; and x = inf at the padding's column, non-finite in
        exactly the rows that read it or whose group is longer than they
        are (the plain version, as the JAX kernels: or whose chunk is);
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
     of 5 repetitions validated OK, bench_spmv for 0.3 s) with the launch
     counts set to 0 before and read after, then the whole SpMV and each
     precision stream compared and timed against the plain version (the
     kernels by a replayed CUDA graph, the plain version by events):
       A  Laplace3D-128  ap[dp_sp] -dp_emu, ap_threshold_1 = 2.44
       B  Laplace3D-128  ap[sp_hp], ap_threshold_1 = 2.44
       C  Laplace3D-128  hp
       D  Laplace3D-128  sp, block vectors bs=8 and bs=4, rowwise and
          colwise (each read the matrix once: the kernel carries 8
          columns or vectors), with cuSPARSE's SpMM in turns: A @ X
          rowwise, A @ X.t() colwise, and A @ X.t().contiguous() made
          beforehand, beside the CUDA kernels the profiler sees in the
          former (does PyTorch copy X first?)
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
        C=1024 sigma=1 sp, k=512, 0.3 s per impl: Laplace3D-128, FemTet3D-55
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
     SpmvOperator.from_mtx twice each: with the defaults ("auto": rows
     split at the automatic threshold, the tier chosen by beta) and with
     the other tier forced ("other": mixed_tiles the opposite of what auto
     chose, which locates the cross-over of the two tiers). Each is
     compared with its plain version, with scipy in f64, and run twice bit-equal;
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
     and sp with rowwise and colwise bs 4 and 8 (the packed kernel's
     colwise vectors read each group once, the pieces kernel's vectors of
     either layout each record once; each pieces block bit-equal to a
     launch per vector; cuSPARSE's SpMM beside the block vectors'
     kernels), and a CUDA-graph solve of k=64 bit-equal to the loop. In
     the driven runs each kernel and cuSPARSE on its
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
        script's default sweep on Laplace3D-64 (C x sigma in (1, 1),
        (16, 512), (1024, 1), (1024, 1024), sp and hp, bs 1, 4, 8, 16,
        32: 40 points), and ap_bench on Laplace3D-128, with short bench
        times, every row emitted;
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
        (every campaign run on cuda-* or cusparse-*), their rows read back;
 12. the sharded operator over processes (slice 11: parallel/multihost.py,
     the pack and unpack kernels of csrc/halo_exchange.cu). Its runs start
     worker processes of this script (``--phase12-worker SPEC``), each of
     which joins the run, sets the launch counts to 0, builds the operator,
     drives it and reads the counts; no process outlives the phase:
     a. the pack and unpack kernels on process 0's rows of the R=4 plan of
        Laplace3D-128 split over 2 processes, f32 and f64: bit-equal to
        their plain versions, then kernel, plain version and
        index_select / index_copy_ timed by replayed graphs in turns;
     b. the headline (Laplace3D-128, scs -c 1024 -sp, 4 shards) as 2
        processes x 2 shards on cuda:0 (CUDA_VISIBLE_DEVICES=0: gloo
        through pinned host buffers): y bit-equal to the one-process R=4
        operator's; the SpMV by a loop of launches beside the one-process
        R=4 and single-device operators (in turns, in this process), the
        pack, copy out, gloo all-to-all, copy in and unpack; then the CLI
        on 2 processes: a validated solve ([OK] on process 0 alone) and
        bench mode with -print_comm_vol (host0=/host1= and shard lines);
     c. crs -dp -rand_x 1 on Laplace3D-64 as 4 processes x 1 shard (every
        exchange crosses a process), validated against scipy to < 1e-13
        (the f64 pack and unpack), beside the CLI runs of b;
     d. with two or more cards, b over NCCL, one process per card (and 4 x
        1 shard with four cards): y bit-equal, the SpMV and the all-to-all
        timed; the transfer captured in CUDA graphs: a bench batch and a
        solve of 5 bit-equal to their loops, bench_spmv timed by graph,
        op.spmv by a replayed graph beside its loop; on one card a line
        says it did not run and why (over gloo, b, the bench and the solve
        must run the loop);
     e. solve_diag on Laplace3D-128 sp and FemTet3D-9: t(k) = a + b k for
        the loop, graph and fused solves.
     ``python3 chip_smoke.py --only 12`` runs phases 1, 2 and 12 alone,
     ``--only 12d`` phases 1, 2, the references of 12b and 12d;
 13. the harness by replayed CUDA graph (slice 13):
     a. bench_spmv's timing, GFLOP/s and time per SpMV beside op.spmv timed
        by a replayed graph and by a loop of launches, in turns, on the
        headline, RandomImbalanced-500k and BandedImbalanced-500k at
        (1024, 1), FemTet3D-9, the headline sharded at R=4 (overlap on and
        off) and R=8, ap[dp_sp] -dp_emu, rowwise bs 8, -impl xla and
        -impl bcoo; by graph the bench may take at most 1.10 times the
        graph's time per SpMV;
     b. bench_solve by graph (m replays, x copied in once) against m calls
        of op.solve(x, k, "graph") (a copy in and two clones out each) on
        FemTet3D-9 and Laplace3D-128 at k = 2, 16 and 512, in turns, the
        bench's buffers bit-equal to the loop of launches.
     ``--only 13`` runs phases 1, 2 and 13 alone;
 14. the headline program, ``bench_torch.py`` (the port's counterpart of
     bench.py), in a process of its own, its record file under
     build/uspmv_tpu_torch/chip_smoke_bench/:
     a. a whole run: exit 0, no error, each of its seven ``*_gflops`` a
        number > 0, vs_baseline > 0, timing "graph", and its headline
        within 10% of 13a's bench_spmv on the same matrix; its record is
        printed as one line;
     b. a run whose USPMV_BENCH_PHASE_DEADLINE_S fires the watchdog inside
        the headline's timed batches (from a's progress lines and its last
        batches' length), while the card is busy: the partial record must
        parse, with value null and the watchdog's error, and the exit must
        be non-zero.
     ``--only 14`` runs phases 1, 2, 13a's headline case and 14;
 15. one process over several card groups (the rows that cross
     cards by pack, peer copy and unpack), the headline (Laplace3D-128,
     C=1024, sigma=1, sp, seg-rows, overlap on); each driven run
     (from_mtx, a validated solve of 5, bench_spmv 0.3 s by graph) sets
     the launch counts to 0 before and needs the pack, the unpack and the
     SELL kernel after:
     a. on every host, R=4 as two groups on card 0: y bit-equal to the
        one-group operator's and to phase 10's y; both SpMVs by a graph in
        turns; the pack, copy, unpack and exchange each alone by graph;
     b. with two or more cards, the peer access of every pair, then R=4
        and R=8 over min(R, cards) cards by the default placement:
        transport "peer", y bit-equal to the same R on one card (overlap
        on and off), the SpMV by one graph across the cards in turns with
        one card's, overlap off beside it, and the exchange's parts each
        alone.
     ``--only 15`` runs phases 1, 2 and 15 (on a host of four cards for b;
     ``--only 12d`` in the same call gives NCCL's 4 x 1 beside it).
 16. processes of several cards each (parallel/multihost.local_cards: a
     process takes visible cards // processes on the host), the rows
     between processes staged through each process's lead card for one
     NCCL all-to-all, the headline (C=1024, sigma=1, sp, seg-rows,
     overlap on), worker processes as in phase 12:
     a. on every host, in phase 12: 12b's 2 x 2 shards with two card
        groups a process, both on cuda:0 (``devices``, gloo through
        pinned host buffers): y bit-equal to the one-process R=4
        operator's, a validated solve of 2, "gloo-staged+peer";
     b. with four cards, 2 processes x 2 cards at R=4 and R=8: y
        bit-equal to the same R on one card, a validated solve of 5, the
        solve and a bench batch by graph bit-equal to their loops,
        bench_spmv by graph, each process on two distinct cards, and the
        parts each alone by graph across its cards (packs, peer copies,
        staging copies, the all-to-all, unstaging copies, unpacks), a
        torch.profiler timeline of one SpMV per process; the
        SpMV by a replayed graph in turns with 12d's 4 x 1, 12d's 2 x 1
        (two processes of one card each, CUDA_VISIBLE_DEVICES=0,1, as 12d
        runs it now) and phase 15's one process over the four cards, then
        back.
     ``--only 16`` runs phases 1, 2 and 16 (four cards; its kernels line
     holds the pack, unpack and exchange with phase 16's launches),
     ``--only 16a`` phases 1, 2, 12b's references and 16a.

Since the bench times replays of a captured graph, every driven run counts
a kernel's launches through its wrapper plus its kernel nodes replayed from
graphs (runtime/operator.graph_nodes_replayed), and the kernel line's
``launches`` counts both; 7c runs the CG example by graph batches and by
eager steps (the same iterations, x bit-equal) and times both.

Beside each kernel's time the script prints its bound (bytes over the
card's HBM rate from uspmv_tpu_torch/runtime/card.py, 3,350 GB/s on an H100
SXM, or flops over the peak of its type if larger) and ``library_ms``, the
time of ``torch.sparse_csr_tensor(...) @ x`` on the same matrix in the
original row order: a yardstick only, the port never calls it (null with
the error text where PyTorch has no CSR product for the dtypes). The bytes
of a bound are the function's own: each stored nonzero's value and int32
column, x read and y written once (for the fused solve the matrix's once
per iteration, x0 in and two vectors out once); what the layout streams,
padding and chunk or row-group metadata included, is ``moved_bytes``.

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

import faulthandler
import json
import os
import re
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
# H100 SXM data sheet: FLOP/s outside the tensor cores (the HBM rate is
# uspmv_tpu_torch/runtime/card.py's, by the card's name)
PEAK_FLOPS = {"torch.float32": 67e12, "torch.float64": 34e12}
SOLVE_K = 512
# what the kernel line's "launches" counts, since the bench times replays
LAUNCHES_COUNTED = ("launches through the kernel's wrapper plus its kernel "
                    "nodes replayed from CUDA graphs (bench batches, graph "
                    "solves) on the main path")
# the kernels whose registers the build phase reports (cuobjdump)
ROW_SUM_KERNELS = ("scs_spmv_kernel", "scs_ones_kernel", "scs_packed_kernel",
                   "scs_solve_kernel", "scs_pieces_kernel",
                   "scs_pieces_block_kernel")
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
    ("D-colwise-4", "Laplace3D,128", dict(value_type="sp", block_vec_size=4,
                                          vector_layout="colwise")),
    ("E", "WideSpectrum,55", dict(value_type="ap[dp_sp_hp]",
                                  dp_emulation=True, ap_threshold_1=1e-2,
                                  ap_threshold_2=1e-5)),
]
# (layout, bs) of the small-shape checks; bs=1 is one vector [n_pad];
# colwise 3 runs the guard, 16 two passes of 8
SHAPES = [("rowwise", 1), ("rowwise", 4), ("rowwise", 8), ("colwise", 3),
          ("colwise", 4), ("colwise", 8), ("colwise", 16)]
# the SpMMV forms of path D, each a line of its own in the kernels line
SPMMV_PATHS = ("D-rowwise-8", "D-rowwise-4", "D-colwise-8", "D-colwise-4")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


_LAP = [time.perf_counter()]


def lap(part):
    """Print the seconds since the previous lap, naming the part that
    just ended: the laps of a run add up to its whole time."""
    now = time.perf_counter()
    emit("lap", part=part, seconds=now - _LAP[0])
    _LAP[0] = now


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def driver_version():
    """The card's driver version: a programmatic dependent launch (the halo
    kernels) inside a CUDA-graph capture needs a recent one."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def acc_tol(x):
    """Tolerance by the accumulator (x) dtype."""
    import torch

    return TOL["dp"] if x.dtype == torch.float64 else TOL["sp"]


def hbm_bytes_per_s():
    """The first card's HBM rate (uspmv_tpu_torch/runtime/card.py); a card
    the table does not know fails the run rather than take a guessed
    rate."""
    import torch

    from uspmv_tpu_torch.runtime import card

    name = torch.cuda.get_device_name(0)
    rate = card.hbm_bytes_per_s(name)
    require(rate is not None, f"no HBM rate on record for {name!r} in "
            "uspmv_tpu_torch/runtime/card.py")
    return rate


def bound(nbytes, flops, x_dtype):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of bytes over the HBM rate and flops over the peak of the type."""
    t_bytes = nbytes / hbm_bytes_per_s()
    t_ops = flops / PEAK_FLOPS[str(x_dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def own_bytes(dev, n_rows, x, bs=1, passes=1):
    """The bytes of the function y = A x of stream ``dev`` itself: each
    stored nonzero's value and int32 column read once (``passes`` times: a
    solve of k iterations streams the matrix k times), and x read and y
    written once over the ``n_rows`` real rows, ``bs`` values a row.
    Padding and chunk or row-group metadata are the layout's, not the
    function's: they count in the moved bytes (``stream_bytes``)."""
    return (passes * dev.nnz * (dev.values.element_size() + 4)
            + 2 * n_rows * bs * x.element_size())


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


def csr_library_call(dev, old_to_new, n_rows, x, y, tol=None,
                     layout="rowwise"):
    """``torch.sparse_csr_tensor(...) @ x`` (cuSPARSE) on the matrix of
    ``dev`` in the original row order (``library_csr_call``). ``y`` is the
    kernel's result for the same x: the library's must agree with it within
    ``tol`` (default: the tolerance of x's dtype)."""
    import torch

    rows_dim = 1 if layout == "colwise" and x.dim() == 2 else 0

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
                            x.index_select(rows_dim, o2n).contiguous(),
                            y.index_select(rows_dim, o2n), tol or acc_tol(x),
                            layout)


def library_csr_ms(rows, cols, vals, n, x, want, tol, reps):
    """Time ``torch.sparse_csr_tensor(...) @ x`` (cuSPARSE) for the n x n
    matrix of the given triples (``library_csr_call``). Returns (ms, None),
    or (None, error text) where PyTorch has no CSR product for the dtypes."""
    call, err = library_csr_call(rows, cols, vals, n, x, want, tol)
    return (time_ms(call, reps), None) if call else (None, err)


def library_csr_call(rows, cols, vals, n, x, want, tol, layout="rowwise"):
    """``torch.sparse_csr_tensor(...) @ x`` (cuSPARSE) for the n x n matrix
    of the given triples (device tensors, in the index space of x, int32
    indices in the CSR), values widened to x's dtype (bf16 values too, the
    rule of ops/spmv_bcoo.py: cuSPARSE takes no bf16 matrix with an f32
    x); its result must agree with ``want``. Colwise block vectors x
    [bs, n] are given as ``x.t()``, the view (``want`` [bs, n] too).
    Returns (the call, None), or (None, error text) where PyTorch has no
    CSR product for the dtypes."""
    import torch

    if layout == "colwise" and x.dim() == 2:
        x, want = x.t(), want.t()

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


def cuda_kernel_names(fn):
    """The names of the CUDA kernels one call of ``fn`` runs, as
    torch.profiler (CUPTI) records them; [] where it records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA})


def spmm_library_calls(dev, op, x, y, layout):
    """cuSPARSE on stream ``dev``'s matrix for x in ``layout``, as calls to
    time in turns: {"library": the one PyTorch call on the same inputs}
    (A @ X rowwise; colwise A @ X.t(), a column-major view that PyTorch may
    copy first), and colwise also {"library_x_copied": A @ X.t()
    made contiguous beforehand, the same product without that copy}.
    Returns (calls, error, the CUDA kernels of the colwise call)."""
    call, err = csr_library_call(dev, op.old_to_new, op.n_rows, x, y,
                                 layout=layout)
    if not call:
        return {}, err, None
    calls = {"library": call}
    if layout != "colwise" or x.dim() == 1:
        return calls, None, None
    copied, _ = csr_library_call(dev, op.old_to_new, op.n_rows,
                                 x.t().contiguous(), y.t())
    calls["library_x_copied"] = copied
    return calls, None, cuda_kernel_names(call)


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


def time_pair(kernel, plain, reps=100, graph=False):
    """(kernel ms, plain ms, samples) in the order plain, kernel, kernel,
    plain on the same tensors; each is the median of its two runs. With
    ``graph`` the kernel is timed by a replayed CUDA graph (``graph_ms``:
    it writes into a buffer it was given), else by CUDA events around a
    loop, which reads the host where a launch is shorter than its
    enqueue."""
    import numpy as np

    t_plain = [time_ms(plain, reps)]
    timer = graph_ms if graph else time_ms
    t_kern = [timer(kernel, reps) for _ in range(2)]
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


def colwise_bits(dev, x, y, y0, what):
    """A colwise block's y (``y0``: the y it was added into, or None)
    against one launch per vector and against the rowwise form of the same
    block, bit for bit: the kernel sums each vector in the same order
    whatever the vectors beside it."""
    import torch

    from uspmv_tpu_torch.ops.scs_spmv import spmv_scs

    for v in range(x.shape[0]):
        one = spmv_scs(dev, x[v].contiguous(),
                       y=None if y0 is None else y0[v].clone())
        require(torch.equal(y[v], one), f"{what}: vector {v} differs from "
                "its own launch")
    rows = spmv_scs(dev, x.t().contiguous(), "rowwise",
                    None if y0 is None else y0.t().contiguous())
    require(torch.equal(y.t(), rows), f"{what}: differs from the rowwise "
            "form")


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
                    if layout == "colwise":
                        colwise_bits(dev, x, y, y0 if acc else None, what)
                    key = f"{layout}-{bs}{'-acc' if acc else ''}"
                    worst[key] = rel
            emit("kernel_vs_plain_pairs", matrix=name, C=1024, sigma=1,
                 entry=entry, values=str(vdt), x=str(xdt),
                 rel_err=worst, tol=acc_tol(x))
            del dev


# phase 3d: path E's configuration on a WideSpectrum small enough for every
# pair and layout: three streams whose groups are shorter than their chunks
PADDED_SMALL = ("WideSpectrum,20", PATHS[-1][2])


def padded_small(cuda, rng_seed=3):
    """Phase 3d: every instantiation, layout and the accumulate form on
    the three padded streams of PADDED_SMALL (each stream's values rounded
    to the pair's value type), against the plain version; then x = inf at
    the padding's column: non-finite exactly in the rows that read that
    column or whose group is longer than they are (the plain version: or
    whose chunk is)."""
    import dataclasses

    import numpy as np
    import torch

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.io.generators import generate_matrix
    from uspmv_tpu_torch.ops import scs_spmv
    from uspmv_tpu_torch.ops.device_format import (
        build_device_scs,
        row_group_lengths,
    )

    spec, fields = PADDED_SMALL
    op = SpmvOperator.from_mtx(Config(
        kernel_format="scs", chunk_size=1024, sigma=1, backend="cpu",
        **fields), generate_matrix(spec))
    gen = torch.Generator().manual_seed(rng_seed)
    for p, scs in op.scs.items():
        row_group = row_group_lengths(scs.row_counts_new, scs.C)
        counts = scs.row_counts_new.astype(np.int64)
        pad_col = int(scs.old_to_new_idx[0])
        real = ~scs.padding_mask()
        uses = np.zeros(scs.n_rows_padded, dtype=bool)
        uses[scs.flat_row_idx()[real & (scs.col_idxs == pad_col)]] = True
        chunk_len = np.repeat(scs.chunk_lengths.astype(np.int64), scs.C)
        for (vdt, xdt), entry in scs_spmv._ENTRY_POINTS.items():
            rounded = dataclasses.replace(scs, values=torch.from_numpy(
                scs.values.astype(np.float64)).to(vdt).double().numpy())
            dev = build_device_scs(rounded, cuda, vdt)
            require(dev.nnz < dev.n_read < dev.n_elements,
                    f"{spec} {p}: no padding past the groups' lengths")
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
                    what = f"{spec} {p} {entry} {layout} bs={bs} acc={acc}"
                    n0 = scs_spmv.launch_counts()[entry]
                    y = scs_spmv.spmv_scs(dev, x, layout,
                                          y0.clone() if acc else None)
                    torch.cuda.synchronize()
                    require(scs_spmv.launch_counts()[entry] == n0 + 1,
                            f"{what}: launch not counted")
                    ref = scs_spmv.spmv_scs_plain(
                        dev, x, layout, y0.clone() if acc else None)
                    _, rel = compare(y, ref, acc_tol(x), what)
                    if layout == "colwise":
                        colwise_bits(dev, x, y, y0 if acc else None, what)
                    worst[f"{layout}-{bs}{'-acc' if acc else ''}"] = rel
            x = torch.randn(n, generator=gen,
                            dtype=torch.float64).to(xdt).to(cuda)
            x[pad_col] = float("inf")
            bad = ~np.isfinite(scs_spmv.spmv_scs(dev, x).cpu().numpy())
            plain_bad = ~np.isfinite(
                scs_spmv.spmv_scs_plain(dev, x).cpu().numpy())
            require(np.array_equal(bad, uses | (counts < row_group)),
                    f"{spec} {p} {entry}: x[0] = inf reaches other rows")
            require(np.array_equal(plain_bad, uses | (counts < chunk_len)),
                    f"{spec} {p} {entry}: the plain version's inf rows")
            emit("kernel_vs_plain_padded", matrix=spec, stream=p, C=1024,
                 sigma=1, entry=entry, values=str(vdt), x=str(xdt),
                 nnz=dev.nnz, slots_read=dev.n_read,
                 n_elements=dev.n_elements, rel_err=worst,
                 tol=acc_tol(x), inf_rows=int(bad.sum()),
                 inf_rows_plain=int(plain_bad.sum()))
            del dev


def shard_parts(op, p):
    """Per shard of a sharded operator, its SELL parts of stream ``p``
    (main: the interior rows when overlapped, else every row; halo: the
    halo-column part): nonzeros, stored slots, slots the kernel reads and
    whether it reads them by group lengths."""
    return [{part: dict(nnz=d.nnz, n_elements=d.n_elements,
                        slots_read=d.n_read,
                        group_lengths=bool(d.group_length_bytes))
             for part, d in (("main", sh.main), ("halo", sh.halo))
             if d is not None and hasattr(d, "n_read")}
            for sh in op.streams[p]]


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
    reset_tier_launch_counts()
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
    n_before = sum(with_replays(launch_counts()).values())
    res = bench_spmv(op, bench_time=0.3)
    # the main path's launches and replayed graph nodes, per instantiation
    counts = with_replays(launch_counts())
    bench_launches = sum(counts.values()) - n_before
    streams = len(op.devs)
    require(res.timing == "graph", f"{name}: bench timed by {res.timing}")
    require(bench_launches >= res.n_iterations * streams,
            f"{name}: {bench_launches} launches and graph nodes for "
            f"{res.n_iterations} timed iterations of {streams} streams")
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
    # the kernels by replayed graph: path A's dp stream (17.5 us at its
    # bound) is shorter than the host's enqueue
    out = torch.empty_like(y)
    ms, plain_ms, samples = time_pair(lambda: op.spmv(x, out=out),
                                      lambda: plain_spmv(op, x), graph=True)
    flops, nbytes = op.flops_per_spmv(), op.bytes_per_spmv()
    layout = cfg.vector_layout
    stream_rec = {}
    for p, dev in op.devs.items():
        y_s = spmv_scs(dev, x, layout)
        s_abs, s_rel = compare(y_s, spmv_scs_plain(dev, x, layout),
                               acc_tol(x), f"{name} {p} stream")
        # moved: the stored stream, padding included, once per pass;
        # bound: the function's own bytes
        s_bytes = (op.matrix_passes() * dev.stream_bytes()
                   + 2 * op.n_rows_padded * bs * x.element_size())
        fn_bytes = own_bytes(dev, op.n_rows, x, bs)
        b_ms, b_by = bound(fn_bytes, 2 * dev.nnz * bs, x.dtype)
        calls, lib_err, lib_kernels = spmm_library_calls(dev, op, x, y_s,
                                                         layout)
        # plain version and cuSPARSE by events, the kernel by a replayed
        # graph, in turns: plain, kernel, library .., .. library, kernel,
        # plain
        timers = {"plain": lambda: time_ms(
                      lambda: spmv_scs_plain(dev, x, layout), 100),
                  "kernel": lambda: graph_ms(
                      lambda: spmv_scs(dev, x, layout, out=out), 100)}
        timers.update({k: (lambda c=c: time_ms(c, 100))
                       for k, c in calls.items()})
        med, turns = time_turns(timers)
        s_ms, s_plain_ms, lib_ms = (med["kernel"], med["plain"],
                                    med.get("library"))
        stream_rec[p] = dict(
            entry=entry_point(dev.values.dtype, wd), nnz=dev.nnz,
            n_elements=dev.n_elements, slots_read=dev.n_read,
            group_length_bytes=dev.group_length_bytes, ms=s_ms,
            plain_ms=s_plain_ms,
            gbps=s_bytes / s_ms / 1e6, plain_gbps=s_bytes / s_plain_ms / 1e6,
            moved_bytes=s_bytes, bound_bytes=fn_bytes,
            max_abs_err=s_abs, rel_err=s_rel, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library_error=lib_err,
            library_x_copied_ms=med.get("library_x_copied"),
            library_kernels=lib_kernels, **turns)
    emit("path", path=name, matrix=spec, C=1024, sigma=1,
         config={k: v for k, v in fields.items()}, impl=op.impl_name(),
         n_rows=op.n_rows, nnz=op.nnz, nnz_per_precision=npp,
         beta=op.beta(), n_dropped=op.n_dropped, operator_build_s=build_s,
         validation=rep.summary(), gflops=res.perf_gflops,
         gbps=res.effective_gbps, n_iterations=res.n_iterations,
         timing=res.timing, timing_samples_s=res.timing_samples_s,
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
            res = bench_solve(op, k, x=x, bench_time=0.3, impl=impl)
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
        res = bench_solve(op, k, bench_time=0.3, impl="fused")
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
    # the bytes A^k x0 must move: the matrix's own bytes once per iteration
    # (at 117-176 MB it exceeds the 50 MB L2), x0 read once, the two
    # returned vectors written once; the iterates between may stay in L2.
    # Moved: the stored stream, padding included, once per iteration
    nbytes = own_bytes(dev, op.n_rows, x, passes=k) \
        + op.n_rows * x.element_size()
    moved = k * dev.stream_bytes() + 3 * x.numel() * x.element_size()
    b_ms, b_by = bound(nbytes, k * op.flops_per_spmv(), x.dtype)
    rec = dict(max_abs_err=max_abs, rel_err=rel, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               library_error="no single PyTorch call computes A^k x",
               k=k, us_per_iteration=ms / k * 1e3,
               bound_us_per_iteration=b_ms / k * 1e3, bound_bytes=nbytes,
               moved_bytes=moved, gbps_of_bound_bytes=nbytes / ms / 1e6,
               **samples)
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
    graphs = []

    def graph_batches(step):
        graphs.append(example.GraphBatches(step))
        return graphs[-1]

    runs = {}
    for name, batches in (("eager", example.eager_batches),
                          ("graph", graph_batches)):
        # warm-up, one batch
        example.cg(h, b, tol=tol, maxiter=example.BATCH, batches=batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_cg, it, res = example.cg(h, b, tol=tol, maxiter=maxiter,
                                   batches=batches)
        torch.cuda.synchronize()
        runs[name] = (x_cg, it, res, time.perf_counter() - t0)
    x_cg, it, res, seconds = runs["graph"]
    x_e, it_e, res_e, seconds_e = runs["eager"]
    require(it == it_e and res == res_e and np.array_equal(x_cg, x_e),
            f"CG: the graph batches ({it} iterations, residual {res:.3e}) "
            f"differ from the eager steps ({it_e}, {res_e:.3e})")
    err = float(np.linalg.norm(x_cg - x_true) / np.linalg.norm(x_true))
    require(res <= tol * 10, f"CG: residual {res:.3e} after {it} iterations")
    require(np.isfinite(err) and err < 1e-3, f"CG: solution error {err:.3e}")
    # one batch by replay alone, the graph's own cost per iteration (the
    # timed run above includes its captures)
    replay = graphs[-1].graphs[example.BATCH].replay
    replay_us = time_ms(replay, 10) / example.BATCH * 1e3
    emit("cg", matrix="Laplace3D,128", value_type="sp", tol=tol,
         maxiter=maxiter, iterations=it, rel_residual=res,
         solution_rel_error=err, graph_bit_equal_to_eager=True,
         seconds=seconds, us_per_iteration=seconds / it * 1e6,
         eager_seconds=seconds_e, eager_us_per_iteration=seconds_e / it * 1e6,
         graph_replay_us_per_iteration=replay_us,
         graph_sizes=sorted(graphs[-1].graphs), card=card)


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


def pieces_one_by_one(pc, x, layout, y0):
    """The pieces' block product as one launch of the pieces kernel per
    vector, stacked in the block's layout."""
    import torch

    from uspmv_tpu_torch.ops import scs_pieces

    cols = layout == "rowwise"
    ones = [scs_pieces.spmv_pieces(
        pc, (x[:, v] if cols else x[v]).contiguous(), "rowwise",
        (y0[:, v] if cols else y0[v]).clone())
        for v in range(x.shape[1] if cols else x.shape[0])]
    return torch.stack(ones, dim=1 if cols else 0)


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
            for layout, bs in (("rowwise", 1), ("rowwise", 4),
                               ("rowwise", 8), ("colwise", 4),
                               ("colwise", 9)):
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
                        if bs > 1:
                            require(torch.equal(got[0], pieces_one_by_one(
                                pc, x, layout, y0)), f"{what}: {entry} "
                                "differs from a launch per vector")
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
             shapes=["rowwise-1", "rowwise-4", "rowwise-8", "colwise-4",
                     "colwise-9"],
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
    "sp-colwise-4": dict(value_type="sp", block_vec_size=4,
                         vector_layout="colwise"),
    "sp-rowwise-8": dict(value_type="sp", block_vec_size=8,
                         vector_layout="rowwise"),
    "sp-colwise-8": dict(value_type="sp", block_vec_size=8,
                         vector_layout="colwise"),
}
# the pieces kernel's block-vector forms, each timed in its own run of
# path G (a kernel-line entry each)
PIECES_SPMMV_RUNS = ("sp-rowwise-4", "sp-rowwise-8", "sp-colwise-4",
                     "sp-colwise-8")


def tier_stream_records(op, x, reps, tol, with_library):
    """Each kernel of ``op.spmv`` on its own, on x (one vector or block
    vectors): ms by a replayed CUDA graph, its plain version's ms, the
    bound of the bytes it moves and cuSPARSE's ms on the same sub-matrix
    (SpMM for block vectors, colwise on the view X.t()). Returns {entry
    point: record}."""
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
        # bound: the function's own bytes; moved: the stored stream with
        # its row-group records (or padding) once per pass
        moved = op.matrix_passes(packed) * dev.stream_bytes() + xy_bytes
        nbytes = own_bytes(dev, op.n_rows, x, bs)
        b_ms, b_by = bound(nbytes, 2 * dev.nnz * bs, x.dtype)
        call, lib_err = None, "not timed in this run"
        if with_library:
            keep = slice(None) if packed else dev.values != 0
            call, lib_err = library_csr_call(
                dev.row_idxs[keep], dev.col_idxs[keep], dev.values[keep], n,
                x, y, tol, layout)
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
            bound_by=b_by, bound_bytes=nbytes, moved_bytes=moved,
            max_abs_err=max_abs, rel_err=rel, library_ms=med.get("library"),
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
        # bound: the function's own bytes (the CSR stream and the parents'
        # runs and rows) once, and per vector x at the distinct columns the
        # pieces read and the parents' rows of y read and written; moved:
        # the kernel's records and counters with the stream once per pass
        # of 8 vectors, the long records' slots per vector
        nbytes = pc.function_bytes(bs, x.element_size())
        xy = (nbytes - pc.bound_bytes()) // bs
        b_ms, b_by = bound(nbytes, 2 * pc.nnz * bs, x.dtype)
        one_by_one = None
        if x.dim() == 2:
            one_by_one = torch.equal(y, pieces_one_by_one(pc, x, layout, y0))
            require(one_by_one, f"{entry} {layout} bs={bs}: differs from "
                    "a launch per vector")
            require(not pc.arrivals.any().item()
                    and not pc.slots.any().item(),
                    f"{entry}: a counter or slot left set")
        call, lib_err = None, "not timed in this run"
        if with_library:
            call, lib_err = library_csr_call(
                pc.piece_rows[pc.piece_idxs.long()], pc.col_idxs, pc.values,
                n, x, y, tol, layout)
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
            moved_bytes=pc.stream_bytes(bs) + bs * xy,
            bit_equal_to_one_vector_launches=one_by_one,
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
    """The three SpMV wrappers' launch counts and the graph nodes replayed
    set to 0."""
    from uspmv_tpu_torch.ops import scs_packed, scs_pieces, scs_spmv
    from uspmv_tpu_torch.runtime.operator import reset_graph_nodes_replayed

    for mod in (scs_spmv, scs_packed, scs_pieces):
        mod.reset_launch_count()
    reset_graph_nodes_replayed()


def with_replays(counts):
    """``counts`` (launches per entry point) plus the kernel nodes that CUDA
    graphs replayed per entry point since the last reset
    (runtime/operator.graph_nodes_replayed). On the card ``bench_spmv``
    times replays of a captured batch, whose kernels no wrapper launches:
    what a main path ran is the sum of both."""
    from uspmv_tpu_torch.runtime.operator import graph_nodes_replayed

    out = dict(counts)
    for entry, n in graph_nodes_replayed().items():
        out[entry] = out.get(entry, 0) + n
    return out


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
    from uspmv_tpu_torch.ops.device_format import vector_pass_count
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
        require(res.timing == "graph", f"{what}: bench timed by {res.timing}")
        main = {k: v for k, v in with_replays(tier_launch_counts()).items()
                if v}
        per_spmv = (len(op.devs) * (vector_pass_count(cfg.block_vec_size)
                                    if cfg.vector_layout == "rowwise" else 1)
                    + len(op.pieces))
        require(sum(main.values()) >= res.n_iterations * per_spmv,
                f"{what}: {main} launches for {res.n_iterations} iterations "
                f"of {per_spmv} launches")
        rec.update(validation=rep.summary(), validation_l2=rep_l2.summary(),
                   judged="L2 norm" if judged else "per element",
                   gflops=res.perf_gflops, gbps=res.effective_gbps,
                   n_iterations=res.n_iterations, timing=res.timing,
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
            # the other tier forced, where the two tiers cross over
            recs["other"], op, x, y = path_g_operator(
                spec, mtx, C, sigma, "other", dict(mixed_tiles=not packed),
                card, drive=False, with_library=False)
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
            k["run_launches"] = rec["main_path_launches"].get(entry, 0)
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
    from uspmv_tpu_torch.scripts.microbench import take_mul

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
    # x_gather_fma in turns with microbench's take_mul (the gather and the
    # product in one PyTorch expression; no one call computes the
    # per-thread sums) on the sweep row's shape, by replayed graphs
    mode, pattern, n_x = X_ACCESS["uspmv_x_gather_fma"][1]
    n = sweep[(mode, pattern, n_x)]["elements"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    v = torch.randn(n, generator=gen, device="cuda")
    xf = torch.randn(n_x, generator=gen, device="cuda")
    idx = gather_probe.sweep_index(pattern, n, n_x, gen,
                                   torch.device("cuda", 0))
    part = torch.empty(x_access.fma_threads(n), device="cuda")
    med, turns = time_turns({
        "kernel": lambda: graph_ms(
            lambda: x_access.gather_fma(xf, idx, v, part), 20),
        "library": lambda: graph_ms(lambda: take_mul(v, xf, idx), 20)})
    records["uspmv_x_gather_fma"].update(
        ms=med["kernel"], library_ms=med["library"], library_error=None,
        library_call="microbench take_mul: v * torch.index_select(x, 0, "
                     "idx)",
        timed_on=records["uspmv_x_gather_fma"]["timed_on"]
        + ", in turns with take_mul (kernel, library, library, kernel)")
    emit("x_gather_fma_vs_take_mul", elements=n, x_elems=n_x,
         kernel_ms=med["kernel"], take_mul_ms=med["library"], **turns,
         card=card)
    del v, xf, idx, part
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
            require(r["platform"] == "cuda" and r["gflops"] > 0
                    and r["timing"] == "graph",
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
        grp = op.groups[0]  # every shard on card 0
        xp = op.x_for(p, x, grp)
        ex = grp.exchanges[p]
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
    bit-equal to its plain version, then the kernel, its launch floor (the
    same entry point on a plan of the first pair alone), the plain version
    and the library pair index_select + index_copy_ timed by replayed CUDA
    graphs in turns. Returns the record for the kernels line."""
    import dataclasses

    import torch

    from uspmv_tpu_torch.ops import halo_exchange as hx

    grp = op.groups[0]  # every shard on card 0
    ex = grp.exchanges[p]
    layout = op.config.vector_layout
    # precision p's own buffer, its halo rows cleared
    x = op.x_for(p, x, grp).clone()
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
    one = dataclasses.replace(ex, src=ex.src[:1], dst=ex.dst[:1])
    med, samples = time_turns({
        "kernel": lambda: graph_ms(lambda: hx.halo_exchange(ex, xk, layout),
                                   200),
        "floor": lambda: graph_ms(lambda: hx.halo_exchange(one, xk, layout),
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
               floor_ms=med["floor"],
               above_floor_ms=med["kernel"] - med["floor"],
               plain_ms=med["plain"], library_ms=med["library"],
               library_error=None, bound_ms=b_ms, bound_by=b_by,
               geometry=hx.device_geometry("exchange", ex, xk, None, layout),
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
    from uspmv_tpu_torch.runtime import operator
    from uspmv_tpu_torch.runtime.bench import bench_solve, bench_spmv

    t_phase = time.perf_counter()
    wrappers = (scs_spmv, scs_packed, scs_pieces, hx)
    launches, records = {}, {}
    base = dict(kernel_format="scs", chunk_size=1024, sigma=1,
                value_type="sp", backend="cuda")
    rng = np.random.default_rng(10)

    def build(m, **kw):
        t0 = time.perf_counter()
        # every shard on the first card, on a host with several too
        op = DistributedSpmvOperator.from_mtx(
            Config(**dict(base, **kw)), m,
            devices=[torch.device("cuda", 0)])
        torch.cuda.synchronize()
        return op, time.perf_counter() - t0

    def drive(m, what, n_rev=5, l2_judged=False, **kw):
        """The entry points a user calls: from_mtx, a validated solve and
        one bench_spmv reading, with every launch count set to 0 before and
        read after; the halo exchange and a row kernel must have run."""
        for w in wrappers:
            w.reset_launch_count()
        operator.reset_graph_nodes_replayed()
        op, build_s = build(m, **kw)
        rep, rep_l2 = validated_solve(op, m, n_rev, what, l2_judged=l2_judged)
        res = bench_spmv(op, bench_time=0.3)
        require(res.timing == "graph", f"{what}: bench timed by {res.timing}")
        got = {}
        for w in wrappers:
            got.update(w.launch_counts())
        got = {k: n for k, n in with_replays(got).items() if n}
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
        info.update(bench_gflops=res.perf_gflops, bench_timing=res.timing,
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
             parts=shard_parts(op, "sp"),
             offsets=op.halo_plans["sp"].offsets, H=op.halo_plans["sp"].H,
             sharded_ms=med["sharded"], single_ms=med["single"], **samples,
             card=card)
        ops[R] = op
    op4 = ops.pop(4)
    del ops
    x4 = op4.make_x(x_host)
    y4 = op4.to_host(op4.spmv(x4))
    PHASE10_Y4["y"] = y4

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
         parts_off=shard_parts(off, "sp"), card=card)
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
    copy_ms = graph_ms(lambda: ap.x_for("sp", xa, ap.groups[0]), 50)
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

    lap("10a")

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

    lap("10b")

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
    lap("10c-d")
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
    require(res.timing == "graph", f"{what}: bench timed by {res.timing}")
    launches = {k: v for k, v in with_replays(tier_launch_counts()).items()
                if v}
    require(sum(launches.values()) >= res.n_iterations * len(op.devs),
            f"{what}: {launches} launches and graph nodes for "
            f"{res.n_iterations} iterations")

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
        n_iterations=res.n_iterations, timing=res.timing,
        main_path_launches=launches,
        max_abs_err=max_abs, rel_err=rel, rel_err_vs_scipy=rel_scipy,
        tol=tol, spmv_graph_ms=ms, gflops=flops / ms / 1e6,
        gbps=nbytes / ms / 1e6, moved_bytes=nbytes, bound_bytes=fn_bytes,
        bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
        moved_share=nbytes / hbm_bytes_per_s() * 1e3 / ms,
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
    from uspmv_tpu_torch.runtime.operator import graph_nodes_replayed

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
    g0 = sum(graph_nodes_replayed().values())
    on = cli_bench([*head, "-log_prof", prof_dir], "-log_prof on")
    launched = scs_spmv.launch_count() - n0
    replayed = sum(graph_nodes_replayed().values()) - g0
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
    # the bench replays a captured graph: its kernels, not only the
    # capture's one warm-up launch, must be in the trace
    require(on["timing"] == off["timing"] == "graph"
            and len(kernels) > launched,
            f"-log_prof: {len(kernels)} {SELL_KERNEL} events for "
            f"{launched} launches and {replayed} graph nodes replayed "
            f"(timing {on['timing']})")
    dur = [e["dur"] for e in kernels if "dur" in e]
    rec["log_prof"] = dict(
        trace=trace, trace_bytes=os.path.getsize(trace),
        events=len(events), marker_ranges=len(marker),
        sell_kernel_events=len(kernels), sell_kernel_launches=launched,
        sell_kernel_graph_nodes_replayed=replayed, timing=on["timing"],
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
    lap("11a")
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
        row.update(impl=res["impl"], timing=res["timing"],
                   gflops=res["perf_gflops"], gbps=res["effective_gbps"],
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
    lap("11b-c")
    # d. the flags
    emit("aux_flags", **aux_flags(card))
    lap("11d")
    # e. the native host library
    emit("aux_native", **aux_native(mtx, card))
    lap("11e")
    # f. the scripts
    emit("aux_scripts", **aux_scripts(card))
    lap("11f")
    emit("phase11", seconds=time.perf_counter() - t_phase,
         main_path_launches=launches)
    return launches


# ----------------------------------------------------------------- phase 12

PACK_REPLACES = "uspmv_tpu/parallel/distributed.py:940"  # jnp.take pack
UNPACK_REPLACES = "uspmv_tpu/parallel/distributed.py:943"  # .at[].set
PHASE12_DIR = os.path.join("build", "uspmv_tpu_torch", "phase12")
HEADLINE_R4 = dict(kernel_format="scs", chunk_size=1024, sigma=1,
                   value_type="sp", n_shards=4)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_main(spec_json):
    """One process of a phase 12 run (``chip_smoke.py --phase12-worker
    SPEC``): join the run, build the sharded operator of ``matrix`` and
    ``config`` with the launch counts set to 0, one op.spmv and to_host of
    x from ``x_seed``, then (``rev``) a solve of rev repetitions from the
    configuration's x validated against scipy on process 0, then (``reps``)
    the SpMV by a loop of launches and the transfer's parts timed; the
    counts read after. Process 0 saves y; every process writes its JSON
    record to ``out``.<pid>.json."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from uspmv_tpu_torch import Config
    from uspmv_tpu_torch.io.generators import generate_matrix
    from uspmv_tpu_torch.ops import halo_exchange as hx
    from uspmv_tpu_torch.ops import scs_packed, scs_pieces, scs_spmv
    from uspmv_tpu_torch.ops.vectors import init_x_host
    from uspmv_tpu_torch.parallel import multihost
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator
    from uspmv_tpu_torch.runtime.bench import timing_of
    from uspmv_tpu_torch.runtime.validate import validate_solve

    spec = json.loads(spec_json)
    pid = spec["pid"]
    # a hung worker prints its threads' stacks before its parent kills it
    faulthandler.dump_traceback_later(spec.get("stack_dump_s", 270))
    info = multihost.initialize(spec["coordinator"], spec["n"], pid,
                                spec["local_devices"], backend="cuda")
    rec = dict(process=pid, multihost=info)
    try:
        wrappers = (scs_spmv, scs_packed, scs_pieces, hx)
        for w in wrappers:
            w.reset_launch_count()
        mtx = generate_matrix(spec["matrix"])
        t0 = time.perf_counter()
        cfg = Config(backend="cuda", **spec["config"])
        op = DistributedSpmvOperator.from_mtx(cfg, mtx,
                                              devices=spec.get("devices"))
        for d in op.devices():
            torch.cuda.synchronize(d)
        rec.update(build_s=time.perf_counter() - t0, impl=op.impl_name(),
                   shards=[op.shards.start, op.shards.stop],
                   groups=[[g.shards.start, g.shards.stop]
                           for g in op.groups],
                   devices=[str(d) for d in op.devices()],
                   transport=op.transport(),
                   per_host=op.comm_volume_per_host(),
                   per_card=op.comm_volume_per_card(),
                   solve_impl=op.solve_impl_name(5),
                   bench_timing=timing_of(op))
        x_host = np.random.default_rng(spec["x_seed"]).standard_normal(
            mtx.n_rows)
        x = op.make_x(x_host)
        y_host = op.to_host(op.spmv(x))
        if pid == 0:
            np.save(spec["out"] + ".y.npy", y_host)
        if spec.get("rev"):
            x0 = init_x_host(cfg, op.n_rows, op.matrix_stats,
                             dtype=np.float64)
            _, ys = op.solve(op.make_x(x0), spec["rev"])
            got = op.to_host(ys)
            if pid == 0:
                np.save(spec["out"] + ".ys.npy", got)
                rep = validate_solve(mtx, x0, np.asarray(got, np.float64),
                                     spec["rev"], value_type=cfg.value_type,
                                     hp_nnz_fraction=op.hp_nnz_fraction())
                rec.update(flag=rep.flag, max_rel_diff=rep.max_rel_diff,
                           rel_l2=rep.rel_l2, validation=rep.summary())
        launches = {}
        for w in wrappers:
            launches.update({k: n for k, n in w.launch_counts().items()
                             if n})
        rec["main_path_launches"] = launches
        if spec.get("reps"):
            rec.update(time_worker(op, x, spec["reps"]))
        if spec.get("graph"):
            rec.update(graph_worker(op, x))
        if spec.get("parts"):
            rec.update(parts_worker(op, x))
        if spec.get("trace"):
            rec.update(trace_worker(op, x))
    finally:
        multihost.shutdown()
    with open(f"{spec['out']}.{pid}.json", "w") as f:
        json.dump(rec, f)
    return 0


def worker_ms(fn, reps, devices=None):
    """Milliseconds per call of ``fn`` over ``reps`` calls by CUDA events
    on the process's lead card (the end after every card of ``devices``),
    the largest of the processes' (the all-reduces outside the events)."""
    import torch

    from uspmv_tpu_torch.parallel import multihost
    from uspmv_tpu_torch.runtime.operator import join_cards

    devices = devices or [torch.device("cuda", torch.cuda.current_device())]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    multihost.agree_max(0.0)
    start.record()
    for _ in range(reps):
        fn()
    join_cards(devices)
    end.record()
    end.synchronize()
    return multihost.agree_max(start.elapsed_time(end) / reps)


def parts_worker(op, x, reps=200):
    """Phase 16: precision sp's transfer over the process's card groups,
    each part alone by a CUDA graph of ``reps`` calls across its cards
    (``cards_graph_ms``; every process captures and replays the same, the
    slowest process's time): every group's pack, the peer copies between
    its groups, the staging copies into the lead card's send buffer, the
    NCCL all-to-all on the lead card, the unstaging copies and every
    group's unpack; and the rows each part moves."""
    import torch.distributed as dist

    from uspmv_tpu_torch.ops import halo_exchange as hx
    from uspmv_tpu_torch.parallel import multihost
    from uspmv_tpu_torch.runtime.operator import parts_of

    layout = op.config.vector_layout
    groups, xs = op.groups, parts_of(x)
    b, st = op.lead["sp"], op.stage["sp"]
    sends = [g.tbufs["sp"]["send"] for g in groups]
    recvs = [g.tbufs["sp"]["recv"] for g in groups]
    peer = op.peer.get("sp", [])

    def pack():
        for g, t in zip(groups, xs):
            hx.halo_pack(g.transfers["sp"], t, g.tbufs["sp"]["send"], layout)

    def unpack():
        for g, t in zip(groups, xs):
            hx.halo_unpack(g.transfers["sp"], g.tbufs["sp"]["recv"], t,
                           layout)

    parts = {"pack": pack,
             "peer": lambda: hx.peer_copy(peer, sends, recvs),
             "stage": lambda: hx.peer_copy(st.stage, sends, [b["send"]]),
             "all_to_all": lambda: dist.all_to_all_single(
                 b["recv"], b["send"], st.recv_counts, st.send_counts),
             "unstage": lambda: hx.peer_copy(st.unstage, [b["recv"]],
                                             recvs),
             "unpack": unpack}
    out = {"parts_own_ms": {}}
    for k, fn in parts.items():
        ms = cards_graph_ms(op.devices(), fn, reps)
        out["parts_own_ms"][k] = ms  # this process's
        out[f"{k}_ms"] = multihost.agree_max(ms)
    out.update(rows_packed=sum(g.transfers["sp"].n_send for g in groups),
               rows_peer=sum(m.n for m in peer),
               rows_staged=st.n_send, rows_unstaged=st.n_recv,
               copies_staged=len(st.stage), copies_unstaged=len(st.unstage),
               all_to_all_split=[st.send_counts, st.recv_counts])
    return out


def graph_worker(op, x):
    """With the transfer captured (NCCL): a bench batch of 10 SpMVs and a
    solve of 5 by CUDA graph, each bit-equal to its loop of launches (y
    gathered to the host in every process); bench_spmv's timing and time
    per SpMV; op.spmv by a replayed graph of 100 SpMVs and by a loop of
    100 launches, by events, the slowest process's."""
    import numpy as np
    import torch

    from uspmv_tpu_torch.runtime.bench import bench_spmv
    from uspmv_tpu_torch.runtime.operator import each

    def clone():
        return each(torch.clone, x)

    want = op.to_host(op.spmv(clone()))
    g = op.batch_graph(x, 10)
    op.replay(g)
    spmv_equal = bool(np.array_equal(op.to_host(g.bufs[0]), want))
    loop = [op.to_host(v) for v in op.solve(clone(), 5, "loop")]
    graph = [op.to_host(v) for v in op.solve(clone(), 5, "graph")]
    solve_equal = all(np.array_equal(a, b) for a, b in zip(loop, graph))
    res = bench_spmv(op, x=x, bench_time=0.2)
    g100 = op.batch_graph(x, 100)
    graph_ms = worker_ms(lambda: op.replay(g100), 3, op.devices()) / 100
    loop_ms = worker_ms(lambda: op.spmv(x, out=g100.bufs[0]), 100,
                        op.devices())
    return dict(graph_spmv_bit_equal=spmv_equal,
                graph_solve_bit_equal=solve_equal,
                bench_timing=res.timing, bench_gflops=res.perf_gflops,
                bench_ms_per_spmv=res.duration_kernel_s / res.n_iterations
                * 1e3, bench_n_iterations=res.n_iterations,
                spmv_graph_ms=graph_ms, spmv_graph_loop_ms=loop_ms)


def time_worker(op, x, reps):
    """The SpMV by a loop of ``reps`` launches (CUDA events, the largest
    of the processes), and the parts of precision sp's transfer, each
    ``reps`` times: the pack kernel and the unpack kernel (events), and
    under gloo the copy out (to the pinned buffer, the host waiting on it),
    the gloo all-to-all and the copy in (host clock); under NCCL the
    all-to-all on the card's buffers (events); then the whole transfer
    (pack, move, unpack) by the host clock."""
    import torch
    import torch.distributed as dist

    from uspmv_tpu_torch.ops import halo_exchange as hx
    from uspmv_tpu_torch.parallel import multihost

    def events(fn):
        return worker_ms(fn, reps)

    def host(fn):
        torch.cuda.synchronize()
        multihost.agree_max(0.0)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return multihost.agree_max((time.perf_counter() - t0) / reps * 1e3)

    y = torch.zeros_like(x)
    for _ in range(10):
        op.spmv(x, out=y)
    out = dict(spmv_loop_ms=events(lambda: op.spmv(x, out=y)),
               spmv_loop_host_ms=host(lambda: op.spmv(x, out=y)))
    tr, b, st = op.groups[0].transfers["sp"], op.lead["sp"], op.stage["sp"]
    layout = op.config.vector_layout
    out["pack_ms"] = events(lambda: hx.halo_pack(tr, x, b["send"], layout))
    out["unpack_ms"] = events(lambda: hx.halo_unpack(tr, b["recv"], x,
                                                     layout))

    def move():
        dist.all_to_all_single(b["recv"], b["send"], st.recv_counts,
                               st.send_counts)

    if "host_send" in b:
        def copy_out():
            b["host_send"].copy_(b["send"], non_blocking=True)
            b["copied_out"].record()
            b["copied_out"].synchronize()

        def gloo():
            dist.all_to_all_single(b["host_recv"], b["host_send"],
                                   st.recv_counts, st.send_counts)

        out.update(copy_out_ms=host(copy_out), gloo_ms=host(gloo),
                   copy_in_ms=host(lambda: b["recv"].copy_(
                       b["host_recv"], non_blocking=True)))
    else:
        out["nccl_ms"] = events(move)
    out["transfer_ms"] = host(lambda: op._receive("sp", x,
                                                  *op._send("sp", x)))
    out.update(n_send=tr.n_send, n_recv=tr.n_recv,
               transport=multihost.transport())
    return out


def trace_worker(op, x, n=5):
    """One SpMV as the card sees it: n replays of a one-SpMV graph, each
    after a barrier (an all-reduce, left out) and apart from the next,
    under torch.profiler (CUPTI); the replay of median length as its
    device activities in start order: [card, name, start and duration in
    us from its first activity]. An error string where the profiler saw
    no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from uspmv_tpu_torch.parallel import multihost

    g = op.batch_graph(x, 1)
    for _ in range(3):
        op.replay(g)
    devices = op.devices()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            multihost.agree_max(0.0)
            op.replay(g)
            for d in devices:
                torch.cuda.synchronize(d)
            time.sleep(0.003)
    evs = sorted((e.time_range.start, e.time_range.end, e.device_index,
                  e.name) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "AllReduce" not in e.name)
    if not evs:
        return {"trace_error": "no device activity recorded"}
    runs, end = [], None
    for ev in evs:
        if end is None or ev[0] > end + 1000:
            runs.append([])
        runs[-1].append(ev)
        end = ev[1] if end is None else max(end, ev[1])
    spans = [max(e[1] for e in r) - r[0][0] for r in runs]
    r = runs[sorted(range(len(runs)),
                    key=spans.__getitem__)[len(runs) // 2]]
    t0 = r[0][0]
    return {"trace_span_us": [float(v) for v in spans],
            "trace": [[int(d), name[:60], round(a - t0, 2), round(b - a, 2)]
                      for a, b, d, name in r]}


def run_workers(spec, n, local_devices, one_card, visible=None):
    """Start n worker processes of ``spec`` (``one_card``: all on cuda:0,
    the card shared through gloo; ``visible``: the CUDA_VISIBLE_DEVICES of
    the run, else every card). Returns (the processes, the path prefix of
    their files) for ``worker_records``."""
    os.makedirs(PHASE12_DIR, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(here, PHASE12_DIR, spec["name"])
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    if one_card or visible:
        env["CUDA_VISIBLE_DEVICES"] = "0" if one_card else visible
    procs = []
    for pid in range(n):
        job = dict(spec, pid=pid, n=n, local_devices=local_devices,
                   coordinator=f"127.0.0.1:{port}", out=out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             "--phase12-worker", json.dumps(job)], cwd=here, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs, out


def wait_all(procs, timeout=300):
    """The outputs of ``procs``; every one is killed when one outlives
    ``timeout`` or after the wait, so no process outlives the phase. A
    timeout raises with the end of every process's output (a worker of
    this script dumps its threads' stacks before: ``worker_main``)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [p.communicate()[0][-4000:] for p in procs[len(outs):]]
        raise RuntimeError(
            f"processes outlived {timeout} s; the output of those still "
            "running: " + json.dumps(tails)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def worker_records(procs_out, what, timeout=300):
    """Wait for the workers of ``run_workers``: (their records, process 0's
    y, the path prefix of their files); raises where one failed."""
    import numpy as np

    procs, out = procs_out
    rcs, outs = wait_all(procs, timeout)
    require(rcs == [0] * len(procs),
            f"{what}: worker rcs {rcs}: {[o[-1500:] for o in outs]}")
    recs = []
    for pid in range(len(procs)):
        with open(f"{out}.{pid}.json") as f:
            recs.append(json.load(f))
    return recs, np.load(out + ".y.npy"), out


def cli_processes(argv, n, local_devices):
    """The CLI line on n processes sharing cuda:0 (gloo through pinned
    host buffers)."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="0")
    return [subprocess.Popen(
        [sys.executable, "-m", "uspmv_tpu_torch.cli", *argv,
         "-coordinator", f"127.0.0.1:{port}", "-n_processes", str(n),
         "-process_id", str(pid), "-local_devices", str(local_devices)],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(n)]


def transfer_record(op, dtype, card):
    """Phase 12a: process 0's pack and unpack of ``op``'s sp plan split
    over 2 processes of 2 shards, on x of ``dtype``: each bit-equal to its
    plain version, then the kernel, the plain version and the library call
    (index_select for the pack, index_copy_ for the unpack) timed by
    replayed CUDA graphs in turns, with the launch floor (the same entry
    point on one row). Returns {entry point: record}."""
    import dataclasses

    import numpy as np
    import torch

    from uspmv_tpu_torch.ops import halo_exchange as hx
    from uspmv_tpu_torch.parallel.halo import split_exchange_rows

    L = op.lengths["sp"]
    _, _, send, recv = split_exchange_rows(op.halo_plans["sp"], L,
                                           np.array([0, 0, 1, 1]), 0)
    cuda = torch.device("cuda", 0)
    tr = hx.build_device_transfer(send, recv, 2, L, True, cuda)
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((2, L), generator=gen, device=cuda).to(dtype)
    flat = x.view(-1)
    buf = torch.zeros(tr.n_send, dtype=dtype, device=cuda)
    inc = torch.randn(tr.n_recv, generator=gen, device=cuda).to(dtype)
    recv64 = tr.recv.long()
    got = hx.halo_pack(tr, x, buf.clone())
    want = hx.halo_pack_plain(tr, x, buf.clone())
    got_u = hx.halo_unpack(tr, inc, x.clone())
    want_u = hx.halo_unpack_plain(tr, inc, x.clone())
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"pack {dtype} != its plain version")
    require(torch.equal(got_u, want_u),
            f"unpack {dtype} != its plain version")
    require(not torch.equal(got_u, x), f"unpack {dtype} wrote nothing")
    xu = x.clone()
    flat_u = xu.view(-1)
    # the launch floor: the same entry points on a plan of one row
    one = dataclasses.replace(tr, send=tr.send[:1], recv=tr.recv[:1],
                              send_counts=[1], recv_counts=[1])
    buf1, inc1 = buf[:1], inc[:1]
    recs = {}
    for kind, n, kernel, floor, plain, library, err in (
            ("pack", tr.n_send,
             lambda: hx.halo_pack(tr, x, buf),
             lambda: hx.halo_pack(one, x, buf1),
             lambda: hx.halo_pack_plain(tr, x, buf),
             lambda: torch.index_select(flat, 0, tr.send, out=buf),
             (got - want).abs().max().item()),
            ("unpack", tr.n_recv,
             lambda: hx.halo_unpack(tr, inc, xu),
             lambda: hx.halo_unpack(one, inc1, xu),
             lambda: hx.halo_unpack_plain(tr, inc, xu),
             lambda: flat_u.index_copy_(0, recv64, inc),
             (got_u - want_u).abs().max().item())):
        med, samples = time_turns({
            "kernel": lambda: graph_ms(kernel, 200),
            "floor": lambda: graph_ms(floor, 200),
            "plain": lambda: graph_ms(plain, 200),
            "library": lambda: graph_ms(library, 200)})
        nbytes = tr.bound_bytes(x.element_size(), pack=kind == "pack")
        b_ms, b_by = bound(nbytes, 0, x.dtype)
        table = (hx.PACK_ENTRY_POINTS if kind == "pack"
                 else hx.UNPACK_ENTRY_POINTS)
        rec = dict(entry=table[dtype], kind=kind, rows=n, max_abs_err=err,
                   ms=med["kernel"], floor_ms=med["floor"],
                   above_floor_ms=med["kernel"] - med["floor"],
                   plain_ms=med["plain"],
                   library_ms=med["library"], library_error=None,
                   geometry=hx.device_geometry(
                       kind, tr, x, buf if kind == "pack" else inc),
                   library_call=("torch.index_select" if kind == "pack"
                                 else "Tensor.index_copy_"),
                   bound_bytes=nbytes, bound_ms=b_ms, bound_by=b_by,
                   timed_on="phase 12a, Laplace3D-128 sp R=4 seg-rows, "
                            "process 0 of 2 (shards 0-1): its rows to "
                            "send or receive, replayed CUDA graphs")
        emit("halo_transfer_kernel", card=card, **rec, **samples)
        recs[rec["entry"]] = rec
    return recs


def transfer_kernels(launches, records):
    """The kernels line's entries of the pack and unpack kernels."""
    out = []
    for entry, rec in records.items():
        require(launches.get(entry, 0) > 0, f"{entry} never launched")
        out.append({
            "name": entry.replace("uspmv_", ""), "route": "cuda",
            "source": EXCHANGE_SOURCE,
            "replaces": (PACK_REPLACES if rec["kind"] == "pack"
                         else UNPACK_REPLACES),
            "replaces_kind": "XLA hot path (jnp.take / .at[].set around a "
                             "ppermute that crosses a process), not a "
                             "Pallas kernel",
            "launches": launches[entry],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_call": rec["library_call"],
            "library_error": rec["library_error"],
            "timed_on": rec["timed_on"], "rows": rec["rows"],
            "bound_bytes": rec["bound_bytes"], "floor_ms": rec["floor_ms"],
            "above_floor_ms": rec["above_floor_ms"],
        })
    return out


def nccl_runs(b_spec, y4, mtx, card, ref_ms):
    """Phase 12d: the run of 12b over NCCL, one process per card, 2 x 2
    shards and, with four cards, 4 x 1: y bit-equal to the one-process
    R=4 operator's (``y4``), the SpMV by a loop of launches beside
    ``ref_ms`` (the one-process R=4 and single-device loops) and the
    transfer's parts. On one card a line says why it did not run. Returns
    the workers' records."""
    import numpy as np
    import torch

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        emit("multiprocess_nccl", skipped=True, device_count=n_cards,
             reason="one card: NCCL refuses two ranks on one device "
                    "(Duplicate GPU detected), so the processes of 12b and "
                    "12c share it over gloo; NCCL needs a card per process",
             card=card)
        return []
    out = []
    for n, D in ((2, 2), (4, 1)):
        if n > n_cards:
            continue
        # 2 x 2 on two cards, one a process (on four it would take two
        # cards a process: phase 16)
        recs, y, _ = worker_records(
            run_workers(dict(b_spec, name=f"12d-{n}", graph=True,
                             stack_dump_s=100), n, D, one_card=False,
                        visible="0,1" if n == 2 else None),
            f"12d {n}", timeout=130)
        require(np.array_equal(y, y4),
                f"12d: y of {n} processes over NCCL != one process")
        r0 = recs[0]
        require(r0["transport"] == "nccl", f"12d: {r0['transport']}")
        require(all(r["graph_spmv_bit_equal"] and r["graph_solve_bit_equal"]
                    and r["bench_timing"] == "graph"
                    and r["solve_impl"] == "graph" for r in recs),
                "12d: the CUDA graph over NCCL: " + json.dumps(
                    [{k: r[k] for k in ("graph_spmv_bit_equal",
                                        "graph_solve_bit_equal",
                                        "bench_timing", "solve_impl")}
                     for r in recs]))
        emit("multiprocess_nccl", skipped=False, processes=n,
             shards_per_process=D, device_count=n_cards,
             bit_equal_to_one_process=True, impl=r0["impl"],
             devices=[r["multihost"]["device"] for r in recs],
             spmv_loop_ms=r0["spmv_loop_ms"],
             spmv_loop_host_ms=r0["spmv_loop_host_ms"],
             gflops=2 * mtx.nnz / r0["spmv_loop_ms"] / 1e6,
             one_process_r4_loop_ms=ref_ms["one_process_r4"],
             single_device_loop_ms=ref_ms["single_device"],
             pack_ms=r0["pack_ms"], unpack_ms=r0["unpack_ms"],
             nccl_ms=r0["nccl_ms"], transfer_ms=r0["transfer_ms"],
             solve_impl=r0["solve_impl"], bench_timing=r0["bench_timing"],
             bench_gflops=r0["bench_gflops"],
             bench_ms_per_spmv=r0["bench_ms_per_spmv"],
             bench_n_iterations=r0["bench_n_iterations"],
             spmv_graph_ms=r0["spmv_graph_ms"],
             spmv_graph_loop_ms=r0["spmv_graph_loop_ms"],
             graph_gflops=2 * mtx.nnz / r0["spmv_graph_ms"] / 1e6,
             graph_bit_equal_to_loop=True,
             rows_sent=[r["n_send"] for r in recs],
             main_path_launches=[r["main_path_launches"] for r in recs],
             card=card)
        out += recs
    return out


def references(mtx, x_seed):
    """The one-process R=4 and single-device operators of the headline, y4
    of the R=4 one from the seeded x, and both SpMVs by a loop of 200
    launches in turns: (op4, y4, {name: median ms}, samples)."""
    import numpy as np
    import torch

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator

    op4 = DistributedSpmvOperator.from_mtx(
        Config(backend="cuda", **HEADLINE_R4), mtx,
        devices=[torch.device("cuda", 0)])
    single = SpmvOperator.from_mtx(Config(
        backend="cuda", **{k: v for k, v in HEADLINE_R4.items()
                           if k != "n_shards"}), mtx)
    x_host = np.random.default_rng(x_seed).standard_normal(mtx.n_rows)
    x4, xs = op4.make_x(x_host), single.make_x(x_host)
    y4 = op4.to_host(op4.spmv(x4))
    yo4, yos = torch.zeros_like(x4), torch.zeros_like(xs)
    med, samples = time_turns({
        "one_process_r4": lambda: time_ms(
            lambda: op4.spmv(x4, out=yo4), 200),
        "single_device": lambda: time_ms(
            lambda: single.spmv(xs, out=yos), 200)})
    return op4, y4, med, samples


def start_16a(b_spec):
    """Phase 16a: start 12b's run (the headline as 2 processes x 2 shards,
    sharing cuda:0 over gloo) with two card groups a process, both on
    cuda:0 (``devices``): phase 16's placement rehearsed on one card."""
    return run_workers(dict(b_spec, name="16a", reps=0, rev=2,
                            devices=["cuda:0", "cuda:0"]), 2, 2,
                       one_card=True)


def finish_16a(workers, y4, card):
    """Wait for 16a's workers: y bit-equal to the one-process R=4
    operator's (``y4``), four groups in the name, both moves in the
    transport, the loop over gloo, the solve [OK] and every process's
    pack and unpack launched. Returns the halo launches per entry
    point."""
    import numpy as np

    recs, y, _ = worker_records(workers, "16a")
    require(np.array_equal(y, y4),
            "16a: y of 2 processes x 2 groups != the one-process R=4 "
            "operator's")
    r0 = recs[0]
    keys = ("impl", "transport", "flag", "groups", "bench_timing",
            "solve_impl")
    require(r0["impl"] == "cuda-dist4-4cards-scs-sp"
            and r0["transport"] == "gloo-staged+peer" and r0["flag"] == "OK"
            and all(r["bench_timing"] == r["solve_impl"] == "loop"
                    and len(r["groups"]) == 2 for r in recs),
            f"16a: {[{k: r.get(k) for k in keys} for r in recs]}")
    launches = {}
    for r in recs:
        for k in ("uspmv_halo_pack_f32", "uspmv_halo_unpack_f32"):
            require(r["main_path_launches"].get(k, 0) > 0,
                    f"16a: process {r['process']} never ran {k}")
        for k, n in r["main_path_launches"].items():
            if k.startswith("uspmv_halo_"):
                launches[k] = launches.get(k, 0) + n
    emit("process_cards_rehearsal", matrix="Laplace3D,128", processes=2,
         groups_per_process=2, devices=[r["devices"] for r in recs],
         impl=r0["impl"], transport=r0["transport"],
         groups=[r["groups"] for r in recs], validation=r0["validation"],
         bit_equal_to_one_process=True,
         build_s=[r["build_s"] for r in recs], per_card=r0["per_card"],
         main_path_launches=[r["main_path_launches"] for r in recs],
         card=card)
    return launches


def phase12_nccl_only(mtx, card):
    """``--only 12d``: the references of 12b and the NCCL runs alone."""
    _, y4, med, _ = references(mtx, 12)
    b_spec = dict(name="12b", matrix="Laplace3D,128", config=HEADLINE_R4,
                  x_seed=12, reps=200)
    nccl_runs(b_spec, y4, mtx, card, med)


def phase12(mtx, card):
    """Phase 12: the sharded operator over processes (parallel/multihost.py)
    on the card. ``mtx`` is the headline's Laplace3D-128. Returns (the pack
    and unpack launches of the workers' main path, per entry point, {entry
    point: its record for the kernels line}, the halo launches of 16a's
    workers)."""
    import numpy as np
    import torch

    from uspmv_tpu_torch import Config
    from uspmv_tpu_torch.io.generators import generate_matrix
    from uspmv_tpu_torch.ops.vectors import init_x_host
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator
    from uspmv_tpu_torch.runtime.validate import validate_solve
    from uspmv_tpu_torch.scripts import solve_diag

    t_phase = time.perf_counter()
    launches, records = {}, {}

    def add_launches(recs):
        for r in recs:
            for k, n in r["main_path_launches"].items():
                if k.startswith(("uspmv_halo_pack", "uspmv_halo_unpack")):
                    launches[k] = launches.get(k, 0) + n

    # ---- 12a. pack and unpack against their plain versions; and the
    # references of 12b: the one-process R=4 and single-device operators
    # by a loop of launches (before the workers start: nothing else runs
    # on the card while they are timed)
    x_seed = 12
    op4, y4, med, samples = references(mtx, x_seed)
    for dtype in (torch.float32, torch.float64):
        records.update(transfer_record(op4, dtype, card))

    # ---- 12b. the headline as 2 processes x 2 shards on cuda:0 (gloo)
    b_spec = dict(name="12b", matrix="Laplace3D,128", config=HEADLINE_R4,
                  x_seed=x_seed, reps=200)
    recs, y, _ = worker_records(run_workers(b_spec, 2, 2, one_card=True),
                                "12b")
    require(np.array_equal(y, y4),
            "12b: y of 2 processes != the one-process R=4 operator's")
    require(all(r["bench_timing"] == "loop" and r["solve_impl"] == "loop"
                for r in recs),
            f"12b: over gloo the bench and the solve must run the loop: "
            f"{[(r['bench_timing'], r['solve_impl']) for r in recs]}")
    add_launches(recs)
    require(all(any(k.startswith("uspmv_halo_pack") for k in
                    r["main_path_launches"]) for r in recs),
            f"12b: a process never packed: {recs}")
    r0 = recs[0]
    emit("multiprocess_headline", matrix="Laplace3D,128", processes=2,
         shards_per_process=2, transport=r0["transport"],
         impl=r0["impl"], solve_impl=r0["solve_impl"],
         bench_timing=r0["bench_timing"], bit_equal_to_one_process=True,
         build_s=[r["build_s"] for r in recs],
         spmv_loop_ms=r0["spmv_loop_ms"],
         spmv_loop_host_ms=r0["spmv_loop_host_ms"],
         gflops=2 * mtx.nnz / r0["spmv_loop_ms"] / 1e6,
         one_process_r4_loop_ms=med["one_process_r4"],
         single_device_loop_ms=med["single_device"], **samples,
         pack_ms=r0["pack_ms"], unpack_ms=r0["unpack_ms"],
         copy_out_ms=r0["copy_out_ms"], gloo_ms=r0["gloo_ms"],
         copy_in_ms=r0["copy_in_ms"], transfer_ms=r0["transfer_ms"],
         rows_sent=[r["n_send"] for r in recs],
         per_host=r0["per_host"],
         main_path_launches=[r["main_path_launches"] for r in recs],
         card=card)

    # ---- 12b (the CLI) and 12c, at once
    out_dir = os.path.abspath(os.path.join(PHASE12_DIR, "cli"))
    os.makedirs(out_dir, exist_ok=True)
    head = ["Laplace3D,128", "scs", "-c", "1024", "-sp", "-n_shards", "4",
            "-mtx_out", out_dir]
    clis = {
        "solve": cli_processes([*head, "-mode", "s", "-validate", "1",
                                "-verbose", "1"], 2, 2),
        "bench": cli_processes([*head, "-mode", "b", "-bench_time", "0.3",
                                "-print_comm_vol", "1", "-verbose", "1"],
                               2, 2),
    }
    c_spec = dict(name="12c", matrix="Laplace3D,64", x_seed=13, rev=2,
                  config=dict(kernel_format="crs", chunk_size=1, sigma=1,
                              value_type="dp", random_init_x=True,
                              n_shards=4))
    c_workers = run_workers(c_spec, 4, 1, one_card=True)
    a_workers = start_16a(b_spec)
    try:
        cli_out = {k: wait_all(p) for k, p in clis.items()}
        c_recs, c_y, c_out = worker_records(c_workers, "12c")
        launches_16a = finish_16a(a_workers, y4, card)
    finally:
        for p in [*(q for ps in clis.values() for q in ps), *c_workers[0],
                  *a_workers[0]]:
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, (rcs, outs) in cli_out.items():
        require(rcs == [0, 0], f"12b CLI {k}: rcs {rcs}: {outs[0][-2000:]}")
    solve_out, bench_out = cli_out["solve"][1][0], cli_out["bench"][1][0]
    require("[OK]" in solve_out and "gloo-staged" in solve_out,
            f"12b CLI solve: {solve_out[-2000:]}")
    require("[OK]" not in cli_out["solve"][1][1], "12b: process 1 printed")
    require("host0=" in bench_out and "host1=" in bench_out
            and "shard 3:" in bench_out, f"12b CLI bench: {bench_out[-2000:]}")
    emit("multiprocess_cli", solve=[ln for ln in solve_out.splitlines()
                                    if "impl:" in ln or "[OK]" in ln
                                    or "[multihost]" in ln],
         bench=[ln for ln in bench_out.splitlines()
                if "per host" in ln or "shard" in ln or "perf:" in ln
                or "comm volume" in ln], card=card)
    c0 = c_recs[0]
    # the same run in one process: the process count must change no bit.
    # Per element, dp CRS on Laplace3D-64 from a random x is 1e-12 off
    # scipy in one process as well (rows whose sum nearly cancels), so the
    # reference's dp unit tolerance 1e-13 holds the relative L2 norm
    m64 = generate_matrix(c_spec["matrix"])
    one_cfg = Config(backend="cuda", **c_spec["config"])
    one = DistributedSpmvOperator.from_mtx(
        one_cfg, m64, devices=[torch.device("cuda", 0)])
    x0 = init_x_host(one_cfg, one.n_rows, one.matrix_stats,
                     dtype=np.float64)
    y1 = one.to_host(one.spmv(one.make_x(np.random.default_rng(
        c_spec["x_seed"]).standard_normal(m64.n_rows))))
    ys1 = one.to_host(one.solve(one.make_x(x0), c_spec["rev"])[1])
    rep1 = validate_solve(m64, x0, ys1, c_spec["rev"], value_type="dp")
    require(np.array_equal(c_y, y1)
            and np.array_equal(np.load(c_out + ".ys.npy"), ys1),
            "12c: y of 4 processes != the one-process operator's")
    require(c0["flag"] == "OK" and c0["rel_l2"] < 1e-13
            and c0["max_rel_diff"] == rep1.max_rel_diff,
            f"12c: {c0.get('validation')} (one process: {rep1.summary()})")
    require(c0["impl"] == "cuda-dist4-scs-dp", f"12c runs {c0['impl']}")
    add_launches(c_recs)
    emit("multiprocess_one_shard_each", matrix="Laplace3D,64", processes=4,
         impl=c0["impl"], transport=c0["multihost"]["transport"],
         validation=c0["validation"], max_rel_diff=c0["max_rel_diff"],
         rel_l2=c0["rel_l2"], one_process_validation=rep1.summary(),
         bit_equal_to_one_process=True,
         main_path_launches=[r["main_path_launches"] for r in c_recs],
         card=card)
    del one, m64

    # ---- 12d. NCCL, one process per card
    add_launches(nccl_runs(b_spec, y4, mtx, card, med))
    del op4
    torch.cuda.empty_cache()

    # ---- 12e. solve_diag: launch cost against per-iteration cost
    rows = solve_diag.run(solve_diag.build_parser().parse_args(
        ["Laplace3D,128", "FemTet3D,9", "--out",
         os.path.join(PHASE12_DIR, "solve_diag.jsonl")]))
    modes = {(r["matrix"], r["mode"]) for r in rows}
    require({(m, k) for m in ("Laplace3D,128", "FemTet3D,9")
             for k in ("loop", "graph", "fused")} <= modes,
            f"12e: solve_diag ran {sorted(modes)}")
    for r in rows:
        emit("solve_diag", card=card, **r)
    for k in ("uspmv_halo_pack_f32", "uspmv_halo_unpack_f32",
              "uspmv_halo_pack_f64", "uspmv_halo_unpack_f64"):
        require(launches.get(k, 0) > 0, f"phase 12: {k} never launched")
    emit("phase12", seconds=time.perf_counter() - t_phase,
         transfer_launches=launches, launches_16a=launches_16a)
    return launches, records, launches_16a


# ----------------------------------------------------------------- phase 13

# (label, matrix, configuration beyond sp at C=1024, sigma=1) of the bench
# by replayed graph against op.spmv by graph and by a loop of launches
PHASE13_CASES = [
    ("headline", "Laplace3D,128", {}),
    ("RandomImbalanced-500k", "RandomImbalanced,500000,8", {}),
    ("BandedImbalanced-500k", "BandedImbalanced,500000,64,8", {}),
    ("FemTet3D-9", "FemTet3D,9", {}),
    ("sharded R=4 overlap on", "Laplace3D,128", dict(n_shards=4)),
    ("sharded R=4 overlap off", "Laplace3D,128",
     dict(n_shards=4, overlap_comm=False)),
    ("sharded R=8", "Laplace3D,128", dict(n_shards=8)),
    ("ap[dp_sp]", "Laplace3D,128", dict(value_type="ap[dp_sp]",
                                        dp_emulation=True,
                                        ap_threshold_1=2.44)),
    ("rowwise bs 8", "Laplace3D,128", dict(block_vec_size=8,
                                           vector_layout="rowwise")),
    ("impl xla", "Laplace3D,128", dict(impl="xla")),
    ("impl bcoo", "Laplace3D,128", dict(impl="bcoo")),
]
# bench_spmv's time per SpMV over op.spmv's by a replayed graph, at most
BENCH_OVER_GRAPH = 1.10
PHASE13_SOLVE_K = (2, 16, 512)


def bench_graph_case(label, spec, fields, m, card):
    """One case of 13a on matrix ``m``: bench_spmv beside op.spmv by a
    replayed graph and by a loop of launches, in turns; returns the emitted
    record (``gflops``: the bench's, from the median of its two runs)."""
    import numpy as np
    import torch

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.ops.spmv_bcoo import BcooSpmvOperator
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator
    from uspmv_tpu_torch.runtime.bench import bench_spmv, timing_of

    cfg = Config(kernel_format="scs", chunk_size=1024, sigma=1,
                 backend="cuda", **{"value_type": "sp", **fields})
    if cfg.n_shards > 1:  # every shard on card 0, on a host with several too
        op = DistributedSpmvOperator.from_mtx(
            cfg, m, devices=[torch.device("cuda", 0)])
    else:
        op = (BcooSpmvOperator if cfg.impl == "bcoo"
              else SpmvOperator).from_mtx(cfg, m)
    x = op.make_x()
    out = torch.zeros_like(x)
    reps = 100 if time_ms(lambda: op.spmv(x, out=out), 3) < 1.0 else 20
    results = []

    def bench():
        results.append(bench_spmv(op, x=x, bench_time=0.2))
        return (results[-1].duration_kernel_s
                / results[-1].n_iterations * 1e3)

    # in turns: bench, graph, loop, loop, graph, bench
    timers = {"bench": bench}
    if timing_of(op) == "graph":
        timers["graph"] = lambda: graph_ms(lambda: op.spmv(x, out=out),
                                           reps)
    timers["loop"] = lambda: time_ms(lambda: op.spmv(x, out=out), reps)
    med, turns = time_turns(timers)
    res = results[-1]
    bench_ms, graph = med["bench"], med.get("graph")
    flops = op.flops_per_spmv()
    ratio = bench_ms / graph if graph else None
    rec = dict(case=label, matrix=spec, impl=res.impl,
               timing=res.timing, gflops=flops / bench_ms / 1e6,
               bench_gflops=[r.perf_gflops for r in results],
               bench_ms_per_spmv=bench_ms,
               n_iterations=[r.n_iterations for r in results],
               spmv_graph_ms=graph, spmv_loop_ms=med["loop"],
               graph_gflops=flops / graph / 1e6 if graph else None,
               loop_gflops=flops / med["loop"] / 1e6,
               bench_over_graph=ratio, limit=BENCH_OVER_GRAPH, **turns,
               card=card)
    emit("bench_graph", **rec)
    require(all(r.timing == res.timing for r in results)
            and np.isfinite(res.perf_gflops) and res.perf_gflops > 0,
            f"13a {label}: GFLOP/s {res.perf_gflops}")
    if res.timing == "graph":
        require(ratio <= BENCH_OVER_GRAPH,
                f"13a {label}: bench {bench_ms:.5f} ms per SpMV against "
                f"{graph:.5f} by graph ({ratio:.3f}x > "
                f"{BENCH_OVER_GRAPH}): the bench is host-bound")
    else:
        require(False, f"13a {label}: timed by {res.timing}")
    del op, x, out
    torch.cuda.empty_cache()
    return rec


def phase13(mtx, card):
    """Phase 13: the harness by replayed CUDA graph. ``mtx`` is the
    headline's Laplace3D-128.
      a. for each of PHASE13_CASES, bench_spmv's timing, GFLOP/s and time
         per SpMV beside op.spmv timed by a replayed CUDA graph and by a
         loop of launches (CUDA events), the three in turns; by graph the
         bench may take at most BENCH_OVER_GRAPH times the graph's time per
         SpMV (the medians of two runs each);
      b. bench_solve by graph on FemTet3D-9 and Laplace3D-128 (value-scaled,
         as path F) at k in PHASE13_SOLVE_K: the new batch (m replays, x
         copied in once) against m calls of op.solve(x, k, "graph") (a copy
         in and two clones out per solve), in turns, and the bench's
         buffers bit-equal to the loop of launches.
    Returns 13a's records by case label."""
    import torch

    from uspmv_tpu_torch import Config, SpmvOperator
    from uspmv_tpu_torch.io import generators
    from uspmv_tpu_torch.runtime.bench import bench_solve

    t_phase = time.perf_counter()
    sizing = dict(SIZING)
    matrices = {"Laplace3D,128": mtx}

    def matrix(spec):
        if spec not in matrices:
            matrices[spec] = (sizing[spec](generators) if spec in sizing
                              else generators.generate_matrix(spec))
        return matrices[spec]

    records = {label: bench_graph_case(label, spec, fields, matrix(spec),
                                       card)
               for label, spec, fields in PHASE13_CASES}

    base = dict(kernel_format="scs", chunk_size=1024, sigma=1,
                value_type="sp", backend="cuda", mixed_tiles=False,
                random_init_x=True)
    for spec in ("FemTet3D,9", "Laplace3D,128"):
        m = matrix(spec).copy()
        unit_row_sums(m)
        op = SpmvOperator.from_mtx(Config(**base), m)
        x = op.make_x()
        for k in PHASE13_SOLVE_K:
            one = time_ms(lambda: op.solve(x, k, "graph"), 2)
            solves = max(3, min(200, int(50.0 / one)))
            results = []

            def new():
                res = bench_solve(op, k, x=x, bench_time=0.1, impl="graph")
                results.append(res)
                return res.duration_kernel_s / res.n_iterations * 1e3

            med, turns = time_turns({
                "old": lambda: time_ms(lambda: op.solve(x, k, "graph"),
                                       solves) / k,
                "new": new})
            g = op.solve_graph(x, k)
            got = (g.bufs[k & 1].clone() if k > 1 else x.clone(),
                   g.bufs[(k - 1) & 1].clone())
            want = op.solve(x, k, "loop")
            require(torch.equal(got[1], want[1])
                    and torch.equal(got[0], want[0]),
                    f"13b {spec} k={k}: the bench's graph differs from the "
                    "loop of launches")
            require(all(r.timing == "graph" for r in results),
                    f"13b {spec} k={k}: timed by {results[0].timing}")
            emit("bench_solve_graph", matrix=spec, k=k, impl=results[0].impl,
                 timing=results[0].timing,
                 new_us_per_iteration=med["new"] * 1e3,
                 old_us_per_iteration=med["old"] * 1e3,
                 old_solves_per_sample=solves,
                 n_iterations=[r.n_iterations for r in results],
                 bit_equal_to_loop=True, **turns, card=card)
        del op, x
        torch.cuda.empty_cache()
    emit("phase13", seconds=time.perf_counter() - t_phase)
    return records


# ----------------------------------------------------------------- phase 14

BENCH_DIR = os.path.join("build", "uspmv_tpu_torch", "chip_smoke_bench")
# the program's headline against 13a's bench_spmv on the same matrix
HEADLINE_VS_13A = 0.10
# "[bench_torch] t=<s> s <key>: <what>" on the program's standard error
_PROGRESS = re.compile(
    r"^\[bench_torch\] t=([0-9.]+) s (\w+): .* (built|landed)$")


def bench_torch_run(env_extra, timeout):
    """``python bench_torch.py`` from the root of the checkout, with its
    record file under BENCH_DIR; returns (exit code, its last line parsed,
    {(case, "built" | "landed"): seconds after the watchdog was armed},
    seconds, its standard error)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, USPMV_OUTPUT_DIR=os.path.join(root, BENCH_DIR),
               **env_extra)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.join(root, "bench_torch.py")],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=timeout)
    seconds = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    require(lines, f"bench_torch.py printed nothing (rc {p.returncode}): "
            f"{p.stderr[-3000:]}")
    try:
        rec = json.loads(lines[-1])
    except json.JSONDecodeError:
        require(False, f"bench_torch.py's last line is not JSON: "
                f"{lines[-1][:500]}")
    progress = {}
    for ln in p.stderr.splitlines():
        m = _PROGRESS.match(ln)
        if m:
            progress[(m.group(2), m.group(3))] = float(m.group(1))
    return p.returncode, rec, progress, seconds, p.stderr


def phase14(mtx, headline_gflops, card):
    """Phase 14: the headline program, bench_torch.py, as a user runs it,
    in a process of its own on the card. ``mtx`` is the headline's
    Laplace3D-128, ``headline_gflops`` 13a's bench_spmv on it.
      a. a whole run: exit 0, no error, every ``*_gflops`` a number > 0,
         vs_baseline > 0, timing "graph", the headline within
         HEADLINE_VS_13A of 13a's, its line appended to the record file;
      b. a run whose USPMV_BENCH_PHASE_DEADLINE_S fires the watchdog inside
         the headline's timed batches, while the card is busy: a's progress
         lines say when its headline operator was built, and its final
         batch took t = n_iterations 2 nnz / GFLOP/s. The batches double
         until one takes the bench time, then two more of that size run:
         about 4 t from built to landed. The deadline is built + t, inside
         a batch whether b stops doubling at a's size, one size earlier
         (b's batches end near built + 2 t) or one later, so the batch
         size's nearness to the bench time on the card moves nothing. The
         partial record must parse, with value null and the watchdog's
         error; the exit non-zero; b's operator built and no number
         landed."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    os.makedirs(BENCH_DIR, exist_ok=True)
    rc, rec, progress, seconds, err = bench_torch_run({}, 900)
    emit("bench_torch", rc=rc, seconds=seconds, record=rec,
         progress={f"{k} {w}": t for (k, w), t in progress.items()},
         headline_13a_gflops=headline_gflops, card=card)
    require(rc == 0 and "error" not in rec,
            f"14a: bench_torch.py rc {rc}: {err[-3000:]}")
    gflops = {k: v for k, v in rec.items() if k.endswith("_gflops")}
    require(len(gflops) == 7 and all(
        isinstance(v, (int, float)) and v > 0 for v in gflops.values()),
        f"14a: extras {gflops}")
    require(isinstance(rec["value"], float) and rec["value"] > 0
            and isinstance(rec["vs_baseline"], float)
            and rec["vs_baseline"] > 0, f"14a: value {rec['value']}, "
            f"vs_baseline {rec['vs_baseline']}")
    require(rec["timing"] == "graph", f"14a: timed by {rec['timing']}")
    off = abs(rec["value"] / headline_gflops - 1)
    require(off <= HEADLINE_VS_13A,
            f"14a: headline {rec['value']:.1f} GFLOP/s, 13a "
            f"{headline_gflops:.1f} ({100 * off:.1f}% apart)")
    with open(os.path.join(BENCH_DIR, "spmv_bench_torch.jsonl")) as f:
        saved = json.loads(f.read().splitlines()[-1])
    require({k: saved[k] for k in rec} == rec,
            "14a: the record file's last line is not the printed record")

    t_batch = rec["n_iterations"] * 2 * mtx.nnz / (rec["value"] * 1e9)
    landed = progress[("headline", "landed")]
    deadline = progress[("headline", "built")] + t_batch
    require(deadline < landed - t_batch,
            f"14b: a deadline of {deadline:.3f} s falls in a's last batch "
            f"({progress}, batch {t_batch:.3f} s)")
    rc, part, progress, seconds, err = bench_torch_run(
        {"USPMV_BENCH_PHASE_DEADLINE_S": f"{deadline:.3f}"}, 300)
    emit("bench_torch_watchdog", rc=rc, seconds=seconds, record=part,
         deadline_s=deadline, a_headline_landed_s=landed,
         a_timed_batch_s=t_batch,
         progress={f"{k} {w}": t for (k, w), t in progress.items()},
         card=card)
    require(rc != 0, "14b: the watchdog's run exited 0")
    require(part.get("value", 0) is None
            and part.get("error", "").startswith("cuda-hung-mid-run"),
            f"14b: partial record {part}")
    require(("headline", "built") in progress
            and ("headline", "landed") not in progress,
            f"14b: the watchdog fired outside the headline's bench "
            f"({progress})")
    emit("phase14", seconds=time.perf_counter() - t_phase)


# ----------------------------------------------------------------- phase 15

# phase 10's one-group y of the headline at R=4 (x from its seed 10), which
# phase 15's two groups on one card must equal bit for bit
PHASE10_Y4 = {}
CARDS_R = (4, 8)


def cards_graph_ms(devices, fn, reps):
    """Milliseconds per call of ``fn``, which launches on the cards of
    ``devices``: reps calls captured into one CUDA graph across the cards
    (runtime/operator.capture_over: the first card's capture stream forks
    to a stream of each other card and joins them back) and replayed on
    the first card, timed by CUDA events there (a replay ends after every
    card's nodes). ``fn`` allocates nothing."""
    import torch

    from uspmv_tpu_torch.ops.scs_spmv import record_captured_launches
    from uspmv_tpu_torch.runtime.operator import capture_over

    devices = list(dict.fromkeys(devices))
    fn()  # built, loaded, peer access enabled before the capture
    for d in devices:
        torch.cuda.synchronize(d)
    graph = torch.cuda.CUDAGraph()
    with record_captured_launches(), capture_over(graph, devices):
        for _ in range(reps):
            fn()
    with torch.cuda.device(devices[0]):
        return time_ms(graph.replay, 3) / reps


def op_graph_ms(op, x, out, reps=50):
    """op.spmv(x, out=out) by ``cards_graph_ms`` on the op's cards."""
    return cards_graph_ms(op.devices(), lambda: op.spmv(x, out=out), reps)


def exchange_parts_ms(op, x, y, reps=200):
    """The exchange of the sp stream of a sharded operator over several
    card groups, each part alone by a graph across the cards: every
    group's pack, the copies between the groups, every group's unpack, the
    exchanges inside the groups, and (``rows``, 50 reps) every shard's row
    launches without any exchange. Returns ({part: ms per call},
    samples)."""
    import torch

    from uspmv_tpu_torch.ops import halo_exchange as hx

    layout = op.config.vector_layout
    xs = list(x) if isinstance(x, tuple) else [x]
    groups = op.groups
    sends = [g.tbufs["sp"]["send"] for g in groups]
    recvs = [g.tbufs["sp"]["recv"] for g in groups]

    def pack():
        for g, t in zip(groups, xs):
            hx.halo_pack(g.transfers["sp"], t, g.tbufs["sp"]["send"], layout)

    def unpack():
        for g, t in zip(groups, xs):
            hx.halo_unpack(g.transfers["sp"], g.tbufs["sp"]["recv"], t,
                           layout)

    def exchange():
        for g, t in zip(groups, xs):
            if g.exchanges["sp"] is not None and g.exchanges["sp"].n:
                hx.halo_exchange(g.exchanges["sp"], t, layout)

    parts = {"pack": pack,
             "copy": lambda: hx.peer_copy(op.peer["sp"], sends, recvs),
             "unpack": unpack}
    if any(g.exchanges["sp"].n for g in groups):  # shards that share a card
        parts["exchange"] = exchange
    ys = list(y) if isinstance(y, tuple) else [y]

    def rows():
        op._rows("sp", "main", xs, ys, False)
        op._rows("sp", "halo", xs, ys, True)

    timers = {k: (lambda f=f: cards_graph_ms(op.devices(), f, reps))
              for k, f in parts.items()}
    timers["rows"] = lambda: cards_graph_ms(op.devices(), rows, 50)
    med, samples = time_turns(timers)
    torch.cuda.synchronize()
    return med, samples


def phase15(mtx, card):
    """Phase 15: one process over several card groups. ``mtx``
    is the headline's Laplace3D-128 (C=1024, sigma=1, sp, seg-rows,
    bulkvec, overlap on). Each driven run (from_mtx, a validated solve of 5
    repetitions, bench_spmv 0.3 s by graph) sets every launch count to 0
    before and reads it after; the pack and unpack kernels, the exchange
    and the SELL kernel must have run. Returns the halo kernels' launches
    per entry point of 15b's runs (the default placement over the cards:
    the main path's), those of 15a's (two groups on card 0, a placement
    only tests give), and the records."""
    import itertools

    import numpy as np
    import torch

    from uspmv_tpu_torch import Config
    from uspmv_tpu_torch.ops import halo_exchange as hx
    from uspmv_tpu_torch.ops import scs_packed, scs_pieces, scs_spmv
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator
    from uspmv_tpu_torch.runtime import operator
    from uspmv_tpu_torch.runtime.bench import bench_spmv

    t_phase = time.perf_counter()
    wrappers = (scs_spmv, scs_packed, scs_pieces, hx)
    base = dict(kernel_format="scs", chunk_size=1024, sigma=1,
                value_type="sp", backend="cuda")
    c0 = torch.device("cuda", 0)
    x_host = np.random.default_rng(10).standard_normal(mtx.n_rows)
    launches = {"15a": {}, "15b": {}}
    records = {}
    need = ("uspmv_halo_pack_f32", "uspmv_halo_unpack_f32",
            "uspmv_scs_spmv_f32_f32")

    def build(devices, **kw):
        t0 = time.perf_counter()
        op = DistributedSpmvOperator.from_mtx(
            Config(**dict(base, **kw)), mtx, devices=devices)
        for d in op.devices():
            torch.cuda.synchronize(d)
        return op, time.perf_counter() - t0

    def drive(what, part, devices, **kw):
        for w in wrappers:
            w.reset_launch_count()
        operator.reset_graph_nodes_replayed()
        op, build_s = build(devices, **kw)
        rep, rep_l2 = validated_solve(op, mtx, 5, what)
        res = bench_spmv(op, bench_time=0.3)
        require(res.timing == "graph", f"{what}: bench timed by {res.timing}")
        got = {}
        for w in wrappers:
            got.update(w.launch_counts())
        got = {k: n for k, n in with_replays(got).items() if n}
        for k in need:
            require(got.get(k, 0) > 0, f"{what}: {k} never launched: {got}")
        for k, n in got.items():
            if k.startswith("uspmv_halo_"):
                launches[part][k] = launches[part].get(k, 0) + n
        return op, dict(impl=op.impl_name(), build_s=build_s,
                        transport=op.transport(),
                        devices=[str(d) for d in op.devices()],
                        shards=[[g.shards.start, g.shards.stop]
                                for g in op.groups],
                        validation=rep.summary(),
                        validation_l2=rep_l2.summary(),
                        solve_impl=op.solve_impl_name(5),
                        main_path_launches=got,
                        comm_per_card=op.comm_volume_per_card(),
                        bench_gflops=res.perf_gflops,
                        bench_timing=res.timing,
                        bench_iterations=res.n_iterations)

    # ---- 15a. every host: R=4 as two groups on card 0 (the rehearsal of
    # pack -> copy -> unpack), bit-equal to phase 10's one group
    one, _ = build([c0], n_shards=4)
    xo = one.make_x(x_host)
    y_one = one.to_host(one.spmv(xo))
    if "y" in PHASE10_Y4:
        require(np.array_equal(y_one, PHASE10_Y4["y"]),
                "15a: the one-group y differs from phase 10's")
    two, info = drive("R=4 as two groups on card 0", "15a", [c0, c0],
                      n_shards=4)
    require(two.n_cards == 2 and two.transport() == "peer",
            f"15a: {two.n_cards} groups, transport {two.transport()}")
    x2 = two.make_x(x_host)
    y2 = two.spmv(x2)
    require(np.array_equal(two.to_host(y2), y_one),
            "15a: two groups on card 0 != one group, bit for bit")
    yo = torch.zeros_like(xo)
    med, samples = time_turns({
        "two_groups": lambda: op_graph_ms(two, x2, y2),
        "one_group": lambda: op_graph_ms(one, xo, yo)})
    parts, part_samples = exchange_parts_ms(two, x2, y2)
    rec = dict(R=4, **info, bit_equal_to_one_group=True,
               compared_with_phase10="y" in PHASE10_Y4,
               two_groups_ms=med["two_groups"], one_group_ms=med["one_group"],
               parts_ms=parts, **samples, **part_samples, card=card)
    emit("cards_rehearsal", **rec)
    records["rehearsal"] = rec
    del two, x2, y2, one, xo, yo
    torch.cuda.empty_cache()
    lap("15a")

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        emit("cards", skipped=True, device_count=n_cards,
             reason="one card: the shards of an operator share it; 15a "
                    "rehearsed the transfer between two groups on it",
             card=card)
        emit("phase15", seconds=time.perf_counter() - t_phase,
             halo_launches=launches)
        return launches["15b"], launches["15a"], records

    # ---- 15b. two or more cards: peer access, the headline over them
    peer = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
            for a, b in itertools.permutations(range(n_cards), 2)}
    emit("cards_peer_access", device_count=n_cards, peer=peer, card=card)
    for R in CARDS_R:
        what = f"Laplace3D-128 R={R} over the cards"
        op, info = drive(what, "15b", None, n_shards=R)
        G = min(R, n_cards)
        require(op.n_cards == G, f"{what}: {op.n_cards} cards, not {G}")
        require(op.transport() == "peer",
                f"{what}: transport {op.transport()}, peer access {peer}")
        one, one_s = build([c0], n_shards=R)
        x, xo = op.make_x(x_host), one.make_x(x_host)
        y, yo = op.spmv(x), one.spmv(xo)
        want = one.to_host(yo)
        require(np.array_equal(op.to_host(y), want),
                f"{what}: y != the same R on one card, bit for bit")
        # replayed graphs over the cards: a bench batch, and a solve of 5
        # from the seeded x against one card's, bit for bit
        g = op.batch_graph(x, 3)
        op.replay(g, 2)
        require(np.array_equal(op.to_host(g.bufs[0]), want),
                f"{what}: a replayed batch != one card's y")
        got = op.solve(op.make_x(x_host), 5)
        ref = one.solve(one.make_x(x_host), 5)
        require(all(np.array_equal(op.to_host(a), one.to_host(b))
                    for a, b in zip(got, ref)),
                f"{what}: a graph solve of 5 != one card's")
        med, samples = time_turns({
            "cards": lambda: op_graph_ms(op, x, y),
            "one_card": lambda: op_graph_ms(one, xo, yo)})
        parts, part_samples = exchange_parts_ms(op, x, y)
        # overlap off against the same on one card (the interior and halo
        # parts of overlap on sum a row in another order)
        off, _ = build(None, n_shards=R, overlap_comm=False)
        one_off, _ = build([c0], n_shards=R, overlap_comm=False)
        xf = off.make_x(x_host)
        yf = off.spmv(xf)
        want_off = one_off.to_host(one_off.spmv(one_off.make_x(x_host)))
        require(np.array_equal(off.to_host(yf), want_off),
                f"{what}, overlap off: y != one card's")
        g = off.batch_graph(xf, 3)
        off.replay(g, 2)
        require(np.array_equal(off.to_host(g.bufs[0]), want_off),
                f"{what}, overlap off: a replayed batch != one card's y")
        off_ms = op_graph_ms(off, xf, yf)
        del one_off
        rec = dict(R=R, cards=G, **info, bit_equal_to_one_card=True,
                   graph_batch_and_solve_bit_equal=True,
                   one_card_build_s=one_s, cards_ms=med["cards"],
                   one_card_ms=med["one_card"], overlap_off_ms=off_ms,
                   cards_gflops=2 * mtx.nnz / med["cards"] / 1e6,
                   parts_ms=parts,
                   rows_moved=sum(g.transfers["sp"].n_recv
                                  for g in op.groups),
                   rows_exchanged_in_cards=sum(
                       g.exchanges["sp"].n for g in op.groups),
                   **samples, **part_samples, card=card)
        emit("cards_headline", **rec)
        records[f"R={R}"] = rec
        del op, one, off, x, xo, xf, y, yo, yf
        torch.cuda.empty_cache()
        lap(f"15b R={R}")
    emit("phase15", seconds=time.perf_counter() - t_phase,
         halo_launches=launches)
    return launches["15b"], launches["15a"], records


# ----------------------------------------------------------------- phase 16

PHASE16_R = (4, 8)


def phase16(mtx, card):
    """Phase 16, on four cards: the headline (``mtx``, Laplace3D-128;
    C=1024, sigma=1, sp, seg-rows, overlap on) as 2 processes x 2 cards
    under NCCL, the rows between processes staged through each process's
    lead card. At R=4 and R=8: y bit-equal to the same R on one card, a
    solve of 5 validated ([OK]) and by graph bit-equal to its loop, a
    replayed bench batch bit-equal, bench_spmv by graph, each process's
    two distinct cards, and the parts each alone (``parts_worker``). The
    SpMV by a replayed graph in turns (2 x 2, 12d's 4 x 1 and 2 x 1, phase
    15's one process over the four cards; then back) at R=4, and a
    profiler timeline of one SpMV per process (``trace_worker``) of the
    first 2 x 2, 4 x 1 and 2 x 1 runs. Returns (the halo
    launches of the 2 x 2 runs per entry point, the kernels line's
    entries of the pack, unpack and exchange)."""
    import numpy as np
    import torch

    from uspmv_tpu_torch import Config
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        emit("process_cards", skipped=True, device_count=n_cards,
             reason="needs four cards: two processes of two cards each; "
                    "16a rehearses the placement on one card",
             card=card)
        return {}, []
    c0 = torch.device("cuda", 0)
    x_seed = 16
    x_host = np.random.default_rng(x_seed).standard_normal(mtx.n_rows)
    ones, want, spread, spread_x = {}, {}, {}, {}
    for R in PHASE16_R:
        cfg = Config(backend="cuda", **dict(HEADLINE_R4, n_shards=R))
        ones[R] = DistributedSpmvOperator.from_mtx(cfg, mtx, devices=[c0])
        want[R] = ones[R].to_host(ones[R].spmv(ones[R].make_x(x_host)))
        # phase 15's placement: one process over the four cards
        spread[R] = DistributedSpmvOperator.from_mtx(cfg, mtx)
        spread_x[R] = spread[R].make_x(x_host)
        require(np.array_equal(
            spread[R].to_host(spread[R].spmv(spread_x[R])), want[R]),
            f"16: one process over the cards at R={R} != one card")
    lap("16 references")
    launches = {}
    base = dict(matrix="Laplace3D,128", x_seed=x_seed, stack_dump_s=150)

    def run(name, R, n, full, visible=None):
        spec = dict(base, name=f"16-{name}",
                    config=dict(HEADLINE_R4, n_shards=R), graph=True,
                    rev=5 if full else 0, parts=full and not visible
                    and n == 2, trace=full)
        recs, y, _ = worker_records(
            run_workers(spec, n, R // n, False, visible), f"16 {name}",
            timeout=240)
        require(np.array_equal(y, want[R]),
                f"16 {name}: y != the same R on one card, bit for bit")
        require(all(r["graph_spmv_bit_equal"] and r["graph_solve_bit_equal"]
                    and r["bench_timing"] == "graph"
                    and r["solve_impl"] == "graph" for r in recs),
                f"16 {name}: the graphs: " + json.dumps(
                    [{k: r[k] for k in ("graph_spmv_bit_equal",
                                        "graph_solve_bit_equal",
                                        "bench_timing", "solve_impl")}
                     for r in recs]))
        if full:
            require(recs[0]["flag"] == "OK",
                    f"16 {name}: {recs[0].get('validation')}")
        if n == 2 and not visible:
            for r in recs:
                devs = r["multihost"]["devices"]
                require(len(set(devs)) == 2 and r["devices"] == devs
                        and r["transport"] == "nccl+peer"
                        and r["impl"] == f"cuda-dist{R}-4cards-scs-sp",
                        f"16 {name}: process {r['process']}: {devs}, "
                        f"{r['devices']}, {r['transport']}, {r['impl']}")
                for k, c in r["main_path_launches"].items():
                    if k.startswith("uspmv_halo_"):
                        launches[k] = launches.get(k, 0) + c
        lap(f"16 {name}")
        return recs

    def one_process_ms(R):
        op, x = spread[R], spread_x[R]
        g = op.batch_graph(x, 100)
        return worker_ms(lambda: op.replay(g), 3, op.devices()) / 100

    # 2 x 2 cards; 4 x 1 card; 2 x 1 card (two cards visible); one
    # process over the four cards
    turns = {"2x2": [], "4x1": [], "2x1": [], "1x4": []}
    full = {}
    for k in [*turns, *reversed(turns)]:
        if k == "1x4":
            turns[k].append(one_process_ms(4))
            continue
        first = k not in full
        recs = run(f"{k}-R4" + ("" if first else "-again"), 4,
                   4 if k == "4x1" else 2, first,
                   "0,1" if k == "2x1" else None)
        full.setdefault(k, recs)
        turns[k].append(recs[0]["spmv_graph_ms"])
    r8 = run("2x2-R8", 8, 2, True)
    ms8 = one_process_ms(8)
    med = {k: float(np.median(v)) for k, v in turns.items()}
    for k in ("4x1", "2x1"):
        emit("process_cards_yardstick_trace", config=k, R=4,
             trace_span_us=[r.get("trace_span_us") for r in full[k]],
             trace=[r.get("trace", r.get("trace_error")) for r in full[k]],
             card=card)
    for R, recs, one_ms in ((4, full["2x2"], med["1x4"]), (8, r8, ms8)):
        r0 = recs[0]
        emit("process_cards_headline", R=R, processes=2,
             cards_per_process=2, device_count=n_cards,
             bit_equal_to_one_card=True, graph_bit_equal_to_loop=True,
             validation=r0["validation"], impl=r0["impl"],
             transport=r0["transport"],
             devices=[r["multihost"]["devices"] for r in recs],
             groups=[r["groups"] for r in recs],
             build_s=[r["build_s"] for r in recs],
             spmv_graph_ms=(med["2x2"] if R == 4 else r0["spmv_graph_ms"]),
             spmv_graph_samples_ms=(turns["2x2"] if R == 4
                                    else [r0["spmv_graph_ms"]]),
             spmv_graph_loop_ms=r0["spmv_graph_loop_ms"],
             bench_timing=r0["bench_timing"],
             bench_gflops=r0["bench_gflops"],
             bench_ms_per_spmv=r0["bench_ms_per_spmv"],
             nccl_4x1_ms=med["4x1"] if R == 4 else None,
             nccl_4x1_samples_ms=turns["4x1"] if R == 4 else None,
             nccl_2x1_ms=med["2x1"] if R == 4 else None,
             nccl_2x1_samples_ms=turns["2x1"] if R == 4 else None,
             one_process_four_cards_ms=one_ms,
             one_process_samples_ms=turns["1x4"] if R == 4 else [one_ms],
             parts_ms={k: recs[0][f"{k}_ms"]
                       for k in recs[0].get("parts_own_ms", {})},
             parts_own_ms=[r.get("parts_own_ms") for r in recs],
             trace_span_us=[r.get("trace_span_us") for r in recs],
             trace=[r.get("trace", r.get("trace_error")) for r in recs],
             rows=[{k: r[k] for k in ("rows_packed", "rows_peer",
                                      "rows_staged", "rows_unstaged",
                                      "copies_staged", "copies_unstaged",
                                      "all_to_all_split")} for r in recs],
             per_card=r0["per_card"], per_host=r0["per_host"],
             main_path_launches=[r["main_path_launches"] for r in recs],
             card=card)
    del spread, spread_x
    torch.cuda.empty_cache()
    # the kernels line: the pack and unpack on 12a's rows, the exchange on
    # the in-card pairs of R=8 on one card, with phase 16's launches
    records = transfer_record(ones[4], torch.float32, card)
    xr = ones[8].make_x(x_host)
    ex = exchange_record(ones[8], "sp", xr, card,
                         "phase 16, Laplace3D-128 sp R=8 on one card: the "
                         "in-card pairs, replayed CUDA graphs")
    kernels = transfer_kernels(launches, records)
    require(launches.get(ex["entry"], 0) > 0,
            f"16: {ex['entry']} never launched")
    kernels.append({
        "name": ex["entry"].replace("uspmv_", ""), "route": "cuda",
        "source": EXCHANGE_SOURCE, "replaces": EXCHANGE_REPLACES,
        "launches": launches[ex["entry"]], "max_abs_err": ex["max_abs_err"],
        "ms": ex["ms"], "plain_ms": ex["plain_ms"],
        "bound_ms": ex["bound_ms"], "bound_by": ex["bound_by"],
        "library_ms": ex["library_ms"],
        "library_call": "index_select + index_copy_",
        "library_error": ex["library_error"], "timed_on": ex["timed_on"]})
    emit("phase16", seconds=time.perf_counter() - t_phase,
         halo_launches=launches)
    return launches, kernels


def main():
    import torch

    if sys.argv[1:2] == ["--phase12-worker"]:
        return worker_main(sys.argv[2])
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
    from uspmv_tpu_torch.runtime.card import card_name_and_power_limit

    t_start = time.perf_counter()
    card = card_name_and_power_limit()
    kind = torch.cuda.get_device_name(0)
    cuda = torch.device("cuda", 0)
    nvcc = _build.find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc_version, driver=driver_version(), device=kind,
         device_count=torch.cuda.device_count(), card=card)

    # the native host library (g++) builds while nvcc builds the kernels;
    # whether the default ingest runs native is part of every set-up time
    host_lib = threading.Thread(target=native.available)
    host_lib.start()
    lib = _build.load_library()
    host_lib.join()
    emit("build", seconds=lib.build_seconds, built=lib.built,
         step_seconds=lib.step_seconds, library=str(lib.path),
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
    spilled = [r["function"] for r in resources
               if "scs_pieces_" in r["function"] and (r["local"] or r["stack"])]
    require(not spilled, f"pieces kernels with local memory: {spilled}")
    emit("kernel_resources", kernels=resources)
    lap("1-2 environment and build")

    if sys.argv[1:2] == ["--only"] and sys.argv[2:3] in (["13"], ["14"]):
        mtx = laplace3d(128)
        if sys.argv[2] == "13":
            phase13(mtx, card)
        else:  # 13a's headline case is phase 14's yardstick
            phase14(mtx, bench_graph_case("headline", "Laplace3D,128", {},
                                          mtx, card)["gflops"], card)
        emit("done", seconds_total=time.perf_counter() - t_start)
        print(json.dumps({"kernels": []}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:2] == ["--only"] and sys.argv[2:3] in (["16"], ["16a"]):
        # phase 16 on four cards (kernels line: its pack, unpack and
        # exchange), or 16a alone on one
        mtx = laplace3d(128)
        if sys.argv[2] == "16":
            kernels = phase16(mtx, card)[1]
        else:
            _, y4, _, _ = references(mtx, 12)
            finish_16a(start_16a(dict(
                name="12b", matrix="Laplace3D,128", config=HEADLINE_R4,
                x_seed=12)), y4, card)
            kernels = []
        emit("done", seconds_total=time.perf_counter() - t_start)
        print(json.dumps({"kernels": kernels}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:2] == ["--only"] and sys.argv[2:3] == ["15"]:
        phase15(laplace3d(128), card)
        emit("done", seconds_total=time.perf_counter() - t_start)
        print(json.dumps({"kernels": []}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:2] == ["--only"] and sys.argv[2:3] in (["12"], ["12d"]):
        # phase 12 alone, or its NCCL runs alone (on a host with several
        # cards); the kernels line holds the pack and unpack entries
        if sys.argv[2] == "12d":
            phase12_nccl_only(laplace3d(128), card)
            kernels = []
        else:
            kernels = transfer_kernels(*phase12(laplace3d(128), card)[:2])
        emit("done", seconds_total=time.perf_counter() - t_start)
        print(json.dumps({"kernels": kernels}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

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

    lap("3a")

    # ---- 3b. every instantiation, layout and the accumulate form
    small_shapes(cuda)
    lap("3b")

    # ---- 3c. the heavy-row pieces and packed-row kernels, small shapes
    small_tiers()
    lap("3c")

    # ---- 3d. padded streams: the row loop stops at each group's length
    padded_small(cuda)
    lap("3d")

    # ---- 4. headline: the main path, as a user drives it
    mtx = laplace3d(128)
    cfg = Config(kernel_format="scs", chunk_size=1024, sigma=1,
                 value_type="sp", backend="cuda")
    reset_tier_launch_counts()
    t0 = time.perf_counter()
    op = SpmvOperator.from_mtx(cfg, mtx)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(op.impl_name() == "cuda-scs-sp", f"impl {op.impl_name()}")
    rep, _ = validated_solve(op, mtx, 5, "headline solve")
    n_before_bench = sum(with_replays(launch_counts()).values())
    res = bench_spmv(op, bench_time=1.0)
    # launched by the wrapper or replayed from the bench's graph
    main_launches = with_replays(launch_counts())
    bench_launches = sum(main_launches.values()) - n_before_bench
    require(res.timing == "graph", f"headline bench timed by {res.timing}")
    require(bench_launches >= res.n_iterations,
            f"bench launched or replayed the kernel {bench_launches} times "
            f"for {res.n_iterations} timed iterations")
    require(np.isfinite(res.perf_gflops) and res.perf_gflops > 0,
            f"GFLOP/s {res.perf_gflops}")

    (dev,) = op.devs.values()
    x_host = rng.standard_normal(mtx.n_rows)
    x = op.make_x(x_host)
    y, max_abs, rel = kernel_vs_plain(dev, x, TOL["sp"], "headline")
    rel_scipy = vs_scipy(op, mtx, x_host, y, TOL["sp"], "headline")
    # bound: the function's own bytes; moved: bytes_per_spmv, the stored
    # stream with its padding and chunk metadata
    flops, nbytes = op.flops_per_spmv(), op.bytes_per_spmv()
    fn_bytes = own_bytes(dev, op.n_rows, x)
    b_ms, b_by = bound(fn_bytes, flops, x.dtype)
    lib_ms, lib_err, samples = sell_vs_library(dev, op, x, y, 200)
    ms, plain_ms = samples.pop("kernel_ms"), samples.pop("plain_ms")
    emit("headline", matrix="Laplace3D,128", C=1024, sigma=1,
         value_type="sp", n_rows=op.n_rows, nnz=op.nnz,
         n_elements=dev.n_elements, beta=op.beta()["sp"],
         operator_build_s=build_s, validation=rep.summary(),
         gflops=res.perf_gflops, gbps=res.effective_gbps,
         n_iterations=res.n_iterations, timing=res.timing,
         bench_launches=bench_launches,
         main_path_launches=sum(main_launches.values()),
         timing_samples_s=res.timing_samples_s,
         kernel_ms=ms, kernel_gflops=flops / ms / 1e6,
         kernel_gbps=nbytes / ms / 1e6,
         plain_ms=plain_ms, plain_gflops=flops / plain_ms / 1e6,
         plain_gbps=nbytes / plain_ms / 1e6, **samples,
         bytes_per_spmv=nbytes, moved_bytes=nbytes, bound_bytes=fn_bytes,
         max_abs_err=max_abs, rel_err=rel,
         rel_err_vs_scipy=rel_scipy, bound_ms=b_ms, bound_by=b_by,
         library_ms=lib_ms, library_error=lib_err, card=card)
    headline_ms = ms
    stream_records = {("headline", "sp"): dict(
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, library_error=lib_err)}
    del op, dev, x, y
    torch.cuda.empty_cache()

    lap("4 headline")

    # ---- 5. large x (on the TPU: the windowed kernel's regime)
    big = laplace3d(160)
    op = SpmvOperator.from_mtx(cfg, big)
    (dev,) = op.devs.values()
    x_host = rng.standard_normal(big.n_rows)
    x = op.make_x(x_host)
    y, max_abs, rel = kernel_vs_plain(dev, x, TOL["sp"], "large x")
    rel_scipy = vs_scipy(op, big, x_host, y, TOL["sp"], "large x")
    rep, _ = validated_solve(op, big, 1, "large-x solve")
    fn_bytes = own_bytes(dev, op.n_rows, x)
    b_ms, b_by = bound(fn_bytes, op.flops_per_spmv(), x.dtype)
    lib_ms, lib_err, samples = sell_vs_library(dev, op, x, y, 100)
    ms, plain_ms = samples.pop("kernel_ms"), samples.pop("plain_ms")
    emit("large_x", matrix="Laplace3D,160", n_rows=op.n_rows, nnz=op.nnz,
         x_bytes=op.n_rows_padded * 4, max_abs_err=max_abs, rel_err=rel,
         rel_err_vs_scipy=rel_scipy, validation=rep.summary(),
         kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
         bound_bytes=fn_bytes, moved_bytes=op.bytes_per_spmv(),
         library_ms=lib_ms, library_error=lib_err, **samples, card=card)
    del op, dev, x, y, big
    torch.cuda.empty_cache()

    lap("5 large x")

    # ---- 6. the paths of slice 2
    matrices = {"Laplace3D,128": mtx}
    path_launches = {}
    for name, spec, fields in PATHS:
        if spec not in matrices:
            t0 = time.perf_counter()
            matrices[spec] = generate_matrix(spec)
            emit("generate", matrix=spec, n_rows=matrices[spec].n_rows,
                 nnz=matrices[spec].nnz, seconds=time.perf_counter() - t0)
        counts, streams = run_path(name, spec, matrices[spec], fields, rng)
        path_launches[name] = counts
        for entry, n in counts.items():
            main_launches[entry] = main_launches.get(entry, 0) + n
        for p, rec in streams.items():
            stream_records[(name, p)] = rec
        torch.cuda.empty_cache()

    lap("6 paths A-E")

    # ---- 7a. solve mode on small shapes: fused vs loop vs plain, graph
    solve_small(cuda)
    graph_small(rng)
    lap("7a")

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

    lap("7b path F")

    # ---- 7c. the library surface and the CG example
    interface_and_cg(mtx, lap_scaled, rng, card)
    del lap_scaled
    lap("7c")

    # ---- 8. path G: imbalanced rows at full size
    tier_launches, tier_records = path_g({"FemTet3D,55": fem55}, card)
    del fem55
    torch.cuda.empty_cache()
    lap("8 path G")

    # ---- 9. the last TPU kernels: x access, cost split, unit stream, sweeps
    probe_launches, probe_records = phase9(mtx, headline_ms, card)
    lap("9")

    # ---- 10. row-sharded execution: R shards on the card, halo exchange
    dist_launches, dist_records = phase10(mtx, card)

    # ---- 11. the auxiliaries: ScaMaC/Stokes, bcoo, xla, flags, native
    phase11(mtx, card)

    # ---- 12. the sharded operator over processes: pack, transfer, unpack
    mh_launches, mh_records, launches_16a = phase12(mtx, card)
    lap("12")

    # ---- 15. one process over several card groups: pack, copy, unpack
    cards_launches, rehearsal_launches, _ = phase15(mtx, card)

    # ---- 16. processes of two cards each (four cards; 16a in phase 12)
    p16_launches, _ = phase16(mtx, card)
    process_card_launches = {e: launches_16a.get(e, 0)
                             + p16_launches.get(e, 0)
                             for e in set(launches_16a) | set(p16_launches)}

    # ---- 13. the bench by replayed CUDA graph, the solve bench's batches
    bench_13a = phase13(mtx, card)
    lap("13")

    # ---- 14. the headline program, bench_torch.py, in its own process
    phase14(mtx, bench_13a["headline"]["gflops"], card)
    lap("14")

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
    # the SpMMV forms of the SELL kernel (path D) and the packed kernel's
    # colwise form (path G), each with the launches of its own run
    spmmv = [(name, "uspmv_scs_spmv_f32_f32", stream_records[(name, "sp")],
              path_launches[name].get("uspmv_scs_spmv_f32_f32", 0),
              KERNEL_SOURCE, ":820", f"path {name}, sp stream")
             for name in SPMMV_PATHS]
    rec = tier_records[("sp-colwise-4", "uspmv_scs_packed_f32_f32")]
    spmmv.append(("G-colwise-4", "uspmv_scs_packed_f32_f32", rec,
                  rec["run_launches"], PACKED_SOURCE, ":1347",
                  "path G, RandomImbalanced-500k C=1024 sigma=1 sp, "
                  "colwise bs=4, by a replayed CUDA graph"))
    # the pieces kernel's block-vector forms (path G), one per run
    for run in PIECES_SPMMV_RUNS:
        rec = tier_records[(run, "uspmv_scs_pieces_f32_f32")]
        spmmv.append((f"G-{run[3:]}", "uspmv_scs_pieces_f32_f32", rec,
                      rec["run_launches"], PIECES_SOURCE, ":960",
                      f"path G, RandomImbalanced-500k C=1024 sigma=1 sp, "
                      f"{run[3:].replace('-', ' bs=')}, by a replayed CUDA "
                      "graph"))
    for form, entry, rec, n, source, replaces, timed_on in spmmv:
        require(n > 0, f"{entry} never launched in {form}")
        kernels.append({
            "name": f"{entry.replace('uspmv_', '')} {form[2:]}",
            "route": "cuda", "source": source,
            "replaces": PALLAS + replaces, "launches": n,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_error": rec["library_error"],
            "library_x_copied_ms": rec.get("library_x_copied_ms"),
            "timed_on": timed_on,
        })
        if source == PIECES_SOURCE:
            kernels[-1].update(
                also_replaces=[PALLAS + ":1201"],
                bit_equal_to_one_vector_launches=rec[
                    "bit_equal_to_one_vector_launches"])
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
            "launches": (dist_launches[entry] + cards_launches.get(entry, 0)
                         + process_card_launches.get(entry, 0)),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_call": "index_select + index_copy_",
            "library_error": rec["library_error"],
            "timed_on": rec["timed_on"], "pairs": rec["pairs"],
            "bound_bytes": rec["bound_bytes"], "floor_ms": rec["floor_ms"],
            "above_floor_ms": rec["above_floor_ms"],
        })
    kernels += transfer_kernels(
        {e: mh_launches.get(e, 0) + cards_launches.get(e, 0)
         + process_card_launches.get(e, 0)
         for e in set(mh_launches) | set(cards_launches)
         | set(process_card_launches)}, mh_records)
    for k in kernels:
        k["launches_counted"] = LAUNCHES_COUNTED
        # phase 15's: one process over card groups; 15b's are in
        # "launches", 15a's (two groups on card 0) only here
        entry = "uspmv_" + k["name"]
        if entry in cards_launches or entry in rehearsal_launches:
            k["card_group_launches"] = (cards_launches.get(entry, 0)
                                        + rehearsal_launches.get(entry, 0))
        # phase 16's and 16a's: processes of two card groups each (in
        # "launches" too)
        if entry in process_card_launches:
            k["process_card_launches"] = process_card_launches[entry]
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
