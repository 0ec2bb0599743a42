"""setup_s: seconds from the start of the run (the command's process) to
the first timed call (host clock): imports, input generation, the
program's build, kernel load and warm-up."""


def read(ctx):
    return ctx.record["setup_s"]
