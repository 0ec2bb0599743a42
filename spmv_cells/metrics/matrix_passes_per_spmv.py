"""matrix_passes_per_spmv: the passes over their matrix streams that the
program's SpMV kernel launches booked in the run (its counter
"matrix_passes", lib/program.py: one per pass of up to 8 block vectors of
a SELL-C-sigma or pieces launch, one per packed launch) over the SpMVs the
benchmark called in it: the warm-up's, the rate's, the host bursts' and
the window's (traced or not). None where the program keeps no such
counter, off the card (no kernel is launched there), or for a record of
several runs on one build (the counter is the process's)."""

from spmv_cells.lib import drive, program


def read(ctx):
    passes = program.counter("matrix_passes")
    if not passes or len(ctx.record["runs"]) != 1:
        return None
    calls = drive.WARM_CALLS + drive.RATE_CALLS + sum(
        ctx.run[k]["calls"] for k in ("host_burst", "traced", "window")
        if k in ctx.run)
    return passes / calls
