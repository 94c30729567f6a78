"""Seconds of the run's set-up in ``partition.partition_graph`` (the
partition and the halo plan, host numpy): the program's always-on gauge
``setup.partition_s``."""


def read(run):
    from repro_torch import obs
    return obs.snapshot()["gauges"].get("setup.partition_s")
