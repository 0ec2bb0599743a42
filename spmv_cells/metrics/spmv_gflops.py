"""spmv_gflops: 2 nnz bs x the SpMVs of the window / its seconds (host
clock, from the first call to the synchronize that drains the last)."""


def read(ctx):
    win = ctx.run.get("window")
    if not win:
        return None
    return ctx.flops_per_spmv() * win["calls"] / win["seconds"] / 1e9
