"""The share of the window in which no operation ran on the card: 100 times
one less the union of the device operations' intervals over the window."""


def read(run):
    if not run.ops:
        return None
    from bench.lib.trace import union_seconds
    busy = union_seconds([(s, e) for _, s, e in run.ops], run.t0, run.t1)
    return 100.0 * (1.0 - busy / run.window_s)
