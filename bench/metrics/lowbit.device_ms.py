"""Device time of the Low-bit Module's kernels (quantize and pack, unpack
and dequantize) per epoch, from the profiler's trace of the window."""


def read(run):
    ops = run.kernels_of("lowbit")
    if not ops:
        return None
    return sum(e - s for _, s, e in ops) / run.n_epochs * 1e3
