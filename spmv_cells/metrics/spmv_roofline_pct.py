"""spmv_roofline_pct: (the benchmark's bytes of one SpMV / the card's
data-sheet HBM rate) / (every device operation of the traced window,
summed, per SpMV), in percent. The bytes come from the matrix and the
cell alone (lib/work.py). None on a card the rate table does not know,
or where the trace holds no device time. hbm_copy_gbs, read in the same
run, says how much of the data sheet's rate a plain copy reaches."""


def read(ctx):
    peak = ctx.peak_bytes_per_s()
    s = ctx.summary()
    if peak is None or s is None:
        return None
    busy = s.device_s() / ctx.run["traced"]["calls"]
    if busy <= 0:
        return None
    return ctx.bytes_per_spmv() / peak / busy * 100.0
