"""The share of the traced window in which nothing ran on the card: 100 -
the union of its kernels' and copies' intervals / the window, in percent."""


def read(ctx):
    s = ctx.summary()
    if s is None:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
