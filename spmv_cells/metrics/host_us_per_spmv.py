"""host_us_per_spmv: host microseconds inside the program's ``spmv``
calls, per call, in the benchmark's own span around bursts of calls short
enough that the launch queue never fills."""


def read(ctx):
    burst = ctx.run.get("host_burst")
    if not burst:
        return None
    return burst["seconds"] / burst["calls"] * 1e6
