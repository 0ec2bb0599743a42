"""slots_per_nnz: the slots the kernels read per nonzero, from the
program's own counters: sum over precisions of nnz_p / device_beta_p,
over the nonzeros."""


def read(ctx):
    c = ctx.record["counters"]
    nnz = c["nnz_per_precision"]
    beta = c["device_beta"]
    total = sum(nnz.values())
    if not total or any(beta[p] <= 0 for p in nnz):
        return None
    return sum(n / beta[p] for p, n in nnz.items()) / total
