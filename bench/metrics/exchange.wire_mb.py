"""Bytes the halo exchange ships in an epoch, payload and scale/zero, as
the trainer counts them for each epoch's decision
(``GNNTrainer.wire_bytes_per_epoch``), averaged over the window."""


def read(run):
    if not run.wire_bytes:
        return None
    return sum(run.wire_bytes) / len(run.wire_bytes) / 1e6
