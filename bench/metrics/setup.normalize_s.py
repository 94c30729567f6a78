"""Seconds of the run's set-up in ``formats.gcn_normalize`` (the
self-loops and the GCN weights, host numpy): the program's always-on gauge
``setup.normalize_s``."""


def read(run):
    from repro_torch import obs
    return obs.snapshot()["gauges"].get("setup.normalize_s")
