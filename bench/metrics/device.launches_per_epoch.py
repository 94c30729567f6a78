"""Kernels launched on the card per epoch (copies and fills left out), from
the profiler's trace of the window."""


def read(run):
    ops = run.launches()
    if not ops:
        return None
    return len(ops) / run.n_epochs
