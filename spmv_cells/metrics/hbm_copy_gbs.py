"""hbm_copy_gbs: the card's sustained bandwidth in the run, beside the
data-sheet rate that spmv_roofline_pct divides by: the bytes that the
traced device-to-device copies read and wrote / their device seconds in
the trace (lib/drive.copy_probe). None off the card."""


def read(ctx):
    s = ctx.summary("copy")
    if s is None or s.device_s() <= 0:
        return None
    return ctx.run["copy"]["bytes"] / s.device_s() / 1e9
