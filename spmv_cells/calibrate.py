"""The readings that a cell's limits of ``correct`` are set from.

    python3 spmv_cells/calibrate.py --workload <cell> --seeds S1 S2 ... \
        --control-seeds C1 C2 C3 [--seconds 1] [--out FILE]

On one build of the program per side, at the cell's own size and load:

  program   ``max_err`` of the timed path's result on each seed of
            ``--seeds`` (a short window of the cell's own traffic, then the
            comparison a benchmark run makes);
  control   the same with the program's next lower precision switched on
            (the cell's ``control_value_type``: sp for dp, hp for sp), on
            each of ``--control-seeds``.

Prints one JSON object and writes it to ``--out``. The benchmark's runs do
not run this; the limits in cells/<cell>.json come from its readings.
"""

import argparse
import json
import os
import sys
import time

T_START = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, os.path.dirname(HERE))

from spmv_cells.lib import drive, spec  # noqa: E402


def readings(cell: dict, seeds, seconds: float, backend: str,
             value_type=None) -> list:
    runs = [dict(seed=s, seconds=seconds, trace=False) for s in seeds]
    rec = drive.run_record(cell, runs, backend, T_START, value_type)
    return [[r["seed"], r["checks"]["max_err"]] for r in rec["runs"]]


def calibrate(cell: dict, seeds, control_seeds, seconds: float,
              backend: str = "cuda") -> dict:
    out = {"workload": cell["name"], "limits": cell["limits"],
           "program": readings(cell, seeds, seconds, backend),
           "control_value_type": cell["control_value_type"],
           "control": readings(cell, control_seeds, seconds, backend,
                               cell["control_value_type"])}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    out = calibrate(spec.cell(args.workload), args.seeds, args.control_seeds,
                    args.seconds)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
