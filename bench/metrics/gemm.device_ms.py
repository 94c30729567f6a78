"""Device time of the dense layers' cuBLAS kernels per epoch, from the
profiler's trace of the window."""


def read(run):
    ops = run.kernels_of("gemm")
    if not ops:
        return None
    return sum(e - s for _, s, e in ops) / run.n_epochs * 1e3
