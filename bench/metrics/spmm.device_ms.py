"""Device time of the CSR SpMM's kernels per epoch (the aggregations, their
backward over the transposed CSRs, the boundary-gradient scatter), from the
profiler's trace of the window."""


def read(run):
    ops = run.kernels_of("spmm")
    if not ops:
        return None
    return sum(e - s for _, s, e in ops) / run.n_epochs * 1e3
