"""Command-line interface.

Port of ``uspmv_tpu/cli.py``, which mirrors the reference binary's CLI
(parse_cli_inputs, utilities.hpp:1047-1545):

    python -m uspmv_tpu_torch.cli <matrix.mtx | Generator,args> <crs|scs> [options]

The parser is the JAX package's, whole, so every reference spelling
parses; ``-backend`` takes cuda (default) or cpu. Bench mode (-mode b) and
solve mode (-mode s, validated against scipy) run every precision (-dp,
-sp, -hp, -ap[...], -dp_emu), block vectors (-block_vec_size, -layout),
-equilibrate, -jacobi_scale, -dropout, -split_rows_threshold and
-mixed_tiles, and row-sharded execution (-n_shards R > 1: R shards on the
one device, -seg_method, -comm_mode, -comm_halos, -no_pack, -overlap,
-print_comm_vol); solve mode runs the operator's ``solve`` (one CUDA graph
of the -rev launches on a GPU, the fused solve kernel when
``USPMV_FUSED_SOLVE`` is set and an unsharded operator is eligible, a loop
on the CPU) and prints which one ran. -impl bcoo runs the vendor
comparison (ops/spmv_bcoo.py: cuSPARSE CSR on the card), -impl xla the
plain PyTorch path on the chosen device; -matrix_stats prints the matrix
statistics and exits, -output_sparsity dumps each precision's matrix as
.mtx into -mtx_out and exits, -debug 1 writes the sanity checker's solve
dumps there, and -log_prof DIR writes a torch.profiler Chrome trace of the
bench loop into DIR. The multi-host flags raise NotImplementedError. With
-backend cuda on a host without a GPU the CLI prints one line and exits
with rc 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from .config import Config
from .formats.stats import get_matrix_stats
from .io.generators import generate_matrix
from .io.mmio import read_mtx


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="uspmv_tpu_torch",
        description="Ultimate-SpMV on PyTorch + CUDA: SELL-C-sigma SpMV "
        "benchmarking and validation",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("matrix", help=".mtx file or generator spec 'Name,args'")
    p.add_argument("kernel_format", choices=["crs", "scs"])
    p.add_argument("-c", type=int, default=1, dest="chunk_size")
    p.add_argument("-s", type=int, default=1, dest="sigma")
    p.add_argument("-mode", choices=["b", "s"], default="b")
    p.add_argument("-rev", type=int, default=1, dest="n_repetitions")
    p.add_argument("-bench_time", type=float, default=5.0)
    prec = p.add_mutually_exclusive_group()
    prec.add_argument("-dp", action="store_true")
    prec.add_argument("-sp", action="store_true")
    prec.add_argument("-hp", action="store_true")
    prec.add_argument(
        "-ap_value_type",
        choices=["ap[dp_sp]", "ap[dp_hp]", "ap[sp_hp]", "ap[dp_sp_hp]"],
        default=None,
    )
    p.add_argument("-ap_threshold_1", type=float, default=0.0)
    p.add_argument("-ap_threshold_2", type=float, default=0.0)
    p.add_argument("-dropout", type=int, choices=[0, 1], default=0)
    p.add_argument("-dropout_threshold", type=float, default=0.0)
    p.add_argument("-block_vec_size", type=int, default=1)
    p.add_argument("-layout", choices=["rowwise", "colwise"], default="colwise")
    p.add_argument("-rand_x", choices=["0", "1", "m"], default="0")
    p.add_argument("-equilibrate", type=int, choices=[0, 1], default=0)
    p.add_argument("-jacobi_scale", type=int, choices=[0, 1], default=0)
    p.add_argument(
        "-seg_method",
        choices=["seg-rows", "seg-nnz", "seg-metis"],
        default="seg-rows",
    )
    p.add_argument("-n_shards", type=int, default=1)
    p.add_argument(
        "-comm_mode",
        choices=["bulkvec", "multivec", "singlevec", "graphtopo",
                 "allgather"],
        default="bulkvec",
    )
    p.add_argument("-comm_halos", type=int, choices=[0, 1], default=1)
    p.add_argument("-ba_synch", type=int, choices=[0, 1], default=1)
    p.add_argument("-par_pack", type=int, choices=[0, 1], default=1)
    p.add_argument("-no_pack", type=int, choices=[0, 1], default=0)
    p.add_argument("-print_comm_vol", type=int, choices=[0, 1], default=0)
    p.add_argument("-overlap", type=int, choices=[0, 1], default=1,
                   help="overlap halo exchange with interior SpMV")
    p.add_argument("-split_rows_threshold", type=int, default=0,
                   help="heavy-row split threshold: N = cut rows longer "
                        "than N into pieces of N, 0 = auto (min(max(4 * "
                        "mean row length, 32), 1024)), -1 = disabled")
    p.add_argument("-validate", type=int, choices=[0, 1], default=1)
    p.add_argument("-verbose", type=int, choices=[0, 1], default=0)
    p.add_argument("-matrix_stats", action="store_true")
    p.add_argument("-output_sparsity", action="store_true")
    p.add_argument("-backend", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("-dp_emu", type=int, choices=[0, 1], default=0)
    p.add_argument("-impl", choices=["auto", "xla", "bcoo"], default="auto")
    p.add_argument("-mixed_tiles", choices=["auto", "0", "1"], default="auto",
                   help="the padding-free packed-row tier: 1 forces it, 0 "
                        "forbids it, auto takes it when the SELL-C-sigma "
                        "fill beta is under 0.5")
    p.add_argument(
        "-no_retile", action="store_true",
        help="accepted for parity; this port always runs the literal "
        "(C, sigma) layout",
    )
    p.add_argument("-debug", type=int, choices=[0, 1], default=0)
    p.add_argument("-log_prof", default=None, metavar="LOGDIR")
    p.add_argument("-coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("-n_processes", type=int, default=None)
    p.add_argument("-process_id", type=int, default=None)
    p.add_argument("-local_devices", type=int, default=None)
    p.add_argument("-mtx_out", default=".", dest="output_dir")
    p.add_argument("-seed", type=int, default=42)
    p.add_argument("-json", action="store_true", help="print result as JSON")
    return p


def config_from_args(args) -> Config:
    if args.ap_value_type:
        value_type = args.ap_value_type
    elif args.sp:
        value_type = "sp"
    elif args.hp:
        value_type = "hp"
    else:
        value_type = "dp"
    return Config(
        chunk_size=args.chunk_size if args.kernel_format == "scs" else 1,
        sigma=args.sigma if args.kernel_format == "scs" else 1,
        kernel_format=args.kernel_format,
        value_type=value_type,
        block_vec_size=args.block_vec_size,
        vector_layout=args.layout,
        random_init_x=(args.rand_x == "1"),
        mean_init_x=(args.rand_x == "m"),
        mode=args.mode,
        n_repetitions=args.n_repetitions,
        bench_time=args.bench_time,
        validate_result=bool(args.validate),
        verbose=bool(args.verbose),
        ap_threshold_1=args.ap_threshold_1,
        ap_threshold_2=args.ap_threshold_2,
        dropout=bool(args.dropout),
        dropout_threshold=args.dropout_threshold,
        equilibrate=bool(args.equilibrate),
        jacobi_scale=bool(args.jacobi_scale),
        seg_method=args.seg_method,
        comm_mode=args.comm_mode,
        comm_halos=bool(args.comm_halos),
        ba_synch=bool(args.ba_synch),
        par_pack=bool(args.par_pack),
        no_pack=bool(args.no_pack),
        print_comm_vol=bool(args.print_comm_vol),
        overlap_comm=bool(args.overlap),
        split_rows_threshold=args.split_rows_threshold,
        n_shards=args.n_shards,
        backend=args.backend,
        dp_emulation=bool(args.dp_emu),
        use_pallas=(args.impl == "auto"),
        impl=args.impl,
        retile=not args.no_retile,
        mixed_tiles=(None if args.mixed_tiles == "auto"
                     else args.mixed_tiles == "1"),
        output_dir=args.output_dir,
        matrix_file_name=args.matrix,
        seed=args.seed,
        debug_mode=bool(args.debug),
        log_prof=args.log_prof is not None,
    )


def load_matrix(spec: str):
    if spec.endswith(".mtx"):
        return read_mtx(spec)
    return generate_matrix(spec)


_REFERENCE_ALIASES = {
    # the reference's exact spellings (utilities.hpp:1325-1360)
    "-apt1": ["-ap_threshold_1"],
    "-apt2": ["-ap_threshold_2"],
    "-do": ["-dropout"],
    "-dt": ["-dropout_threshold"],
    "-seg_rows": ["-seg_method", "seg-rows"],
    "-seg-rows": ["-seg_method", "seg-rows"],
    "-seg_nnz": ["-seg_method", "seg-nnz"],
    "-seg-nnz": ["-seg_method", "seg-nnz"],
    "-seg_metis": ["-seg_method", "seg-metis"],
    "-seg-metis": ["-seg_method", "seg-metis"],
}


def translate_reference_flags(argv):
    """Accept the reference binary's exact flag spellings
    (-ap[dp_sp], -apt1, -seg_rows, ...) alongside our own."""
    out = []
    for a in argv:
        if a.startswith("-ap[") and a.endswith("]"):
            out += ["-ap_value_type", a[1:]]
        elif a in _REFERENCE_ALIASES:
            out += _REFERENCE_ALIASES[a]
        else:
            out.append(a)
    return out


def _check_cli_slice(args) -> None:
    """The CLI flags of a later slice: multi-host execution."""
    if (args.coordinator is not None or args.n_processes is not None
            or args.process_id is not None or args.local_devices is not None):
        raise NotImplementedError(
            "uspmv_tpu_torch does not port multi-host execution "
            "(-coordinator, -n_processes, -process_id, -local_devices; "
            "slice 11) yet"
        )


def main(argv=None) -> int:
    from .runtime.operator import DeviceUnavailableError

    try:
        return _main(argv)
    except DeviceUnavailableError as e:
        # one clean line; rc=3 is the "device unavailable" exit of the
        # JAX package's CLI
        print(f"ERROR: {e}", file=sys.stderr)
        return 3


def _main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    argv = translate_reference_flags(list(argv))
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    cfg.validate()
    _check_cli_slice(args)

    mtx = load_matrix(args.matrix)
    if args.matrix_stats:
        print(get_matrix_stats(mtx).summary())
        return 0

    from .runtime.bench import bench_spmv
    from .runtime.operator import SpmvOperator
    from .runtime.report import (
        format_bench_block,
        format_result_block,
        write_bench_to_file,
        write_result_to_file,
    )
    from .runtime.validate import validate_solve

    if cfg.impl == "bcoo":
        from .ops.spmv_bcoo import BcooSpmvOperator

        op = BcooSpmvOperator.from_mtx(cfg, mtx)
    elif cfg.n_shards > 1:
        from .parallel.distributed import DistributedSpmvOperator

        op = DistributedSpmvOperator.from_mtx(cfg, mtx)
    else:
        op = SpmvOperator.from_mtx(cfg, mtx)

    if args.output_sparsity:
        # reference OUTPUT_SPARSITY: dump per-precision SCS and exit
        for path in op.dump_sparsity(cfg.output_dir):
            print(f"wrote {path}")
        return 0

    if cfg.mode == "b":
        from .runtime import profiling

        on = args.log_prof is not None
        with profiling.trace(args.log_prof, enabled=on):
            with profiling.marker(profiling.kernel_marker_name(cfg),
                                  enabled=on):
                res = bench_spmv(op)
        if on:
            print(f"[log_prof] trace -> {profiling.last_trace_path()}")
        write_bench_to_file(cfg, res)
        if args.json:
            print(json.dumps(res.to_dict()))
        else:
            print(format_bench_block(cfg, res))
        return 0

    # solve mode
    from .ops.vectors import init_x_host

    checker = None
    if cfg.debug_mode:
        from .runtime.sanity import SanityChecker

        checker = SanityChecker(cfg.output_dir)
        for s in getattr(op, "scs", {}).values():
            # distributed operators hold per-shard lists
            for si in (s if isinstance(s, list) else [s]):
                checker.check_scs_padding(si)

    x0 = init_x_host(cfg, op.n_rows, op.matrix_stats, dtype=np.float64)
    solve_impl = (f"solve-{op.solve_impl_name(cfg.n_repetitions)}"
                  f"[{op.impl_name()}]")
    xd = op.make_x(x0)
    if checker:
        checker.dump_stage("before_solve", x=op.to_host(xd))
    _, y = op.solve(xd, cfg.n_repetitions)
    y_host = op.to_host(y)
    if checker:
        checker.dump_stage("after_solve", y=y_host)
        checker.check_finite("solve result", y_host)
        print(f"[debug] sanity dumps -> {checker.path}")
    if cfg.validate_result:
        # the oracle sees the same preprocessed operator: the reference
        # equilibrates total_mtx before the MKL compare (main.cpp:1753-1754)
        mtx_oracle = mtx
        if cfg.equilibrate or cfg.jacobi_scale:
            from .formats.coo import equilibrate_matrix, jacobi_scale_matrix

            mtx_oracle = mtx.copy()
            if cfg.jacobi_scale:
                jacobi_scale_matrix(mtx_oracle)
            if cfg.equilibrate:
                equilibrate_matrix(mtx_oracle)
        rep = validate_solve(
            mtx_oracle, x0, np.asarray(y_host, dtype=np.float64),
            cfg.n_repetitions, value_type=cfg.value_type,
            hp_nnz_fraction=op.hp_nnz_fraction(),
        )
        write_result_to_file(cfg, rep, cfg.n_repetitions, impl=solve_impl)
        if args.json:
            print(json.dumps({"validation": dataclasses.asdict(rep),
                              "impl": solve_impl}))
        else:
            print(format_result_block(cfg, rep, cfg.n_repetitions,
                                      solve_impl))
        return 0 if rep.ok else 1
    print(f"solve completed (validation disabled), impl: {solve_impl}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
