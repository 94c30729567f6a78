"""Seconds of the run's set-up in the ``GNNTrainer`` constructor (the
block and its CSRs built on the host and copied to the card, the data, the
training state): the program's always-on gauge ``setup.trainer_s``."""


def read(run):
    from repro_torch import obs
    return obs.snapshot()["gauges"].get("setup.trainer_s")
