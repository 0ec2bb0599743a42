"""The benchmark of uspmv_tpu_torch: one run of one cell.

    python3 spmv_cells/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (``uspmv_tpu_torch``)
and BENCHMARK.json. It generates the cell's matrix and x from the seed,
builds the program's operator, warms up, measures for ``--seconds``
seconds (``--trace 1``: profiles a window of at most lib/drive.TRACE_S
seconds instead), compares the window's last result with the plain float64
reference, and prints as its last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics, as BENCHMARK.json
names them), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit, which also end its
standard error. The parts of the set-up go on earlier lines.

Without as many CUDA cards as the cell asks for, or with JAX or the JAX
package loaded once the window has closed, it prints no result and exits
with a code other than 0. It holds no code of any one cell: a cell, its
configuration, its input generator and each metric are files found by
name (lib/spec.py).
"""

import time

T_START = time.time()  # the run's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# the checkout on the path, and not spmv_cells/ (a script's own directory)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, os.path.dirname(HERE))

from spmv_cells.lib import drive, result, spec  # noqa: E402

EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def report(out: dict) -> None:
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    w = spec.workload(bench, args.workload)
    if w is None:
        print(f"BENCHMARK.json has no workload {args.workload!r}",
              file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    chips = int(w["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch "
              f"{torch.__version__} sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return EXIT_NO_CARD
    rec = drive.run_record(
        cell, [dict(seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace))], "cuda", T_START)
    found = drive.forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark may not load: {found}; "
              "no result", file=sys.stderr)
        return EXIT_FORBIDDEN
    parts = ", ".join(f"{k} {v:.3f}" for k, v in rec["setup"].items())
    print(f"setup: {parts}; setup_s {rec['setup_s']:.3f}")
    print(f"reference: {rec['runs'][0]['reference_s']:.3f} s")
    out = result.assemble(cell, spec.metrics_for(bench, args.workload),
                          rec, bool(args.trace))
    if not all(math.isfinite(m["value"]) for m in out["metrics"].values()):
        print(f"a metric is not finite: {out['metrics']}", file=sys.stderr)
    report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
