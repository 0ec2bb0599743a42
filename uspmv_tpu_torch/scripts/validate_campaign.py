"""Validation campaign: the reference's validate.sh sweep as one script.

Port of the JAX package's scripts/validate_campaign.py (the reference's
SLURM scripts validate{,_master,_no_mpi,_one_proc,_multi_proc}.sh). Sweeps
C x sigma x precision x rand_x in solve mode, with ``--shards`` row shards,
each run through the port's CLI (``uspmv_tpu_torch.cli ... -mode s
-validate 1``), which validates against scipy.sparse (the MKL stand-in) at
the reference tolerances and exits nonzero on ERROR, as the reference
campaign greps its compare files for "ERROR" (validate.sh:24-46). Then the
comparison baseline (-impl bcoo), heavy-row splitting, -dp_emu and the
packed tier at bs 1 and 2, as the JAX script's extra runs.

The reference's bundled matrices are not in this repository, so the
default matrices are generated: Laplace2D-16 (the 2-D FDM stencil of
FDM-2d-16.mtx), a random banded matrix and a small ScaMaC Hubbard chain;
``--matrices`` takes .mtx paths or generator specs. ``--multihost`` adds
the JAX script's sweep on real runs of two processes (the reference's
validate_multi_proc.sh): three configurations on the first matrix, each two
subprocesses of the CLI over torch.distributed (-n_shards 4, 2 shards per
process; on the card NCCL where the host has a card per process, gloo
through host buffers where they share one; gloo with --backend cpu),
validated on process 0.

    python -m uspmv_tpu_torch.scripts.validate_campaign [--quick]
        [--matrices M ...] [--shards N] [--multihost]
        [--backend cuda|cpu] [--out PATH]

One row per run ({"matrix", "argv", "rc", "impl", "seconds", "platform"};
impl as the CLI printed it) is appended to --out, by default
build/uspmv_tpu_torch/validate_campaign.jsonl; the CLI's own files go to
$USPMV_CAMPAIGN_DIR (default build/uspmv_tpu_torch/campaign). Exits 1
when any run failed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import os
import re
import socket
import subprocess
import sys
import time
from typing import List, Optional

from .. import cli
from ..ops._build import BUILD_DIR
from . import _common

NAME = "validate_campaign"
DEFAULT_MATRICES = ("Laplace2D,16", "RandomBanded,1000,40,9",
                    "Hubbard,n_sites=6,n_fermions=3,U=1.3")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"uspmv_tpu_torch.scripts.{NAME}",
                                description=__doc__.split("\n")[0])
    p.add_argument("--quick", action="store_true", help="reduced sweep")
    p.add_argument("--matrices", nargs="*", default=None)
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--multihost", action="store_true",
                   help="also run three configurations on two processes "
                        "each (the reference's validate_multi_proc.sh)")
    _common.add_common_args(p, NAME)
    return p


def sweep(args) -> list:
    """(matrix, argv) of every run, in the JAX script's order."""
    out_dir = os.environ.get("USPMV_CAMPAIGN_DIR",
                             str(BUILD_DIR / "campaign"))
    os.makedirs(out_dir, exist_ok=True)
    matrices = args.matrices or list(DEFAULT_MATRICES)
    common = ["-mtx_out", out_dir, "-backend", args.backend]
    # reference sweep: C, sigma in {1,2,3,4,8,10,16,32,64}^2 (validate.sh)
    cs = [1, 2, 4, 16] if args.quick else [1, 2, 3, 4, 8, 10, 16, 32, 64]
    sigmas = [1, 4, 64] if args.quick else [1, 2, 3, 4, 8, 10, 16, 32, 64]
    precs = ["-dp", "-sp"] if args.quick else ["-dp", "-sp", "-hp", "-ap"]
    runs = []
    for m, C, sigma, prec, rx in itertools.product(
            matrices, cs, sigmas, precs, ["0", "1"]):
        fmt = "crs" if (C == 1 and sigma == 1) else "scs"
        argv = [m, fmt, "-c", str(C), "-s", str(sigma), "-mode", "s",
                "-rev", "3", "-validate", "1", "-rand_x", rx,
                "-n_shards", str(args.shards), *common]
        if prec == "-ap":
            argv += ["-ap_value_type", "ap[dp_sp]", "-ap_threshold_1", "0.5"]
        else:
            argv.append(prec)
        runs.append((m, argv))
    # the comparison baseline, heavy-row splitting and -dp_emu through the
    # same solve + validate harness
    for extra in (["-impl", "bcoo", "-sp"],
                  ["-c", "1024", "-s", "1", "-sp", "-split_rows_threshold",
                   "6"],
                  ["-c", "1024", "-s", "1", "-dp", "-dp_emu", "1"]):
        fmt = "scs" if "-c" in extra else "crs"
        runs.append((matrices[0], [matrices[0], fmt, "-mode", "s", "-rev",
                                   "2", "-validate", "1", *common, *extra]))
    # the packed tier forced on zero-locality rows, one vector and bs 2
    for spec, extra in (
            ("RandomImbalanced,20000,8", []),
            ("PowerLawCols,20000,8", []),
            ("RandomImbalanced,20000,8",
             ["-block_vec_size", "2", "-layout", "rowwise"])):
        runs.append((spec, [spec, "scs", "-c", "1024", "-s", "1", "-sp",
                            "-mixed_tiles", "1", "-mode", "s", "-rev", "2",
                            "-validate", "1", "-n_shards", str(args.shards),
                            *common, *extra]))
    return runs


MULTIHOST_CONFIGS = (
    ["scs", "-c", "4", "-s", "8", "-sp"],
    ["crs", "-dp", "-rand_x", "1"],
    ["scs", "-c", "1024", "-s", "1", "-sp", "-seg_method", "seg-nnz"],
)


def free_port() -> int:
    """A TCP port of this host that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(argv: List[str], n: int) -> tuple:
    """``python -m uspmv_tpu_torch.cli *argv`` as a run of n processes on
    this host (a free port of 127.0.0.1 as coordinator, one thread each).
    Every process is killed when one outlives 600 s. Returns (return
    codes, outputs)."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "uspmv_tpu_torch.cli", *argv,
         "-coordinator", f"127.0.0.1:{port}", "-n_processes", str(n),
         "-process_id", str(pid)],
        cwd=repo, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def multihost_sweep(args) -> list:
    """(matrix, argv) of the two-process runs, in the JAX script's order."""
    out_dir = os.environ.get("USPMV_CAMPAIGN_DIR",
                             str(BUILD_DIR / "campaign"))
    m = (args.matrices or list(DEFAULT_MATRICES))[0]
    return [(m, [m, *extra, "-mode", "s", "-rev", "2", "-validate", "1",
                 "-n_shards", "4", "-local_devices", "2", "-mtx_out",
                 out_dir, "-backend", args.backend])
            for extra in MULTIHOST_CONFIGS]


def run(args) -> List[dict]:
    # raises early without the device
    platform = _common.platform_of(_common.device_for(args.backend))
    rows = []
    for m, argv in sweep(args):
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
        except Exception as e:  # noqa: BLE001 - the campaign keeps going
            rc = 3
            buf.write(f"EXCEPTION {type(e).__name__}: {e}\n")
        seconds = time.perf_counter() - t0
        text = buf.getvalue()
        if rc != 0:
            print(f"ERROR rc={rc} {' '.join(argv)}\n{text[-600:]}")
        impl = re.search(r"impl: (\S+)", text)
        rows.append({"matrix": m, "argv": argv, "rc": rc,
                     "impl": impl.group(1) if impl else None,
                     "seconds": seconds, "platform": platform})
    if args.multihost:
        for m, argv in multihost_sweep(args):
            t0 = time.perf_counter()
            rcs, outs = run_processes(argv, 2)
            rc = next((c for c in rcs if c), 0)
            if rc != 0:
                print(f"ERROR multihost rc={rcs} {' '.join(argv)}\n"
                      f"{outs[0][-600:]}")
            impl = re.search(r"impl: (\S+)", outs[0])
            rows.append({"matrix": m, "argv": argv, "rc": rc,
                         "impl": impl.group(1) if impl else None,
                         "seconds": time.perf_counter() - t0,
                         "platform": platform, "n_processes": 2})
    n_fail = sum(r["rc"] != 0 for r in rows)
    path = _common.write_rows(args.out or _common.default_out(NAME), rows)
    print(f"campaign: {len(rows)} runs, {n_fail} failures "
          f"(rows appended to {path})")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    rows = run(build_parser().parse_args(argv))
    return 1 if any(r["rc"] != 0 for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
