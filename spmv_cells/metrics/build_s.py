"""build_s: seconds of the program's ``from_mtx`` (host clock around it,
the card drained after)."""


def read(ctx):
    return ctx.record["build_s"]
