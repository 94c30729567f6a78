"""The whole epoch's share of the card's float32 peak: the epoch's useful
FLOPs (``bench/lib/flops.py``, fixed by the cell) over the window's epoch
time at the published float32 rate (the port runs its products in float32
with TF32 off)."""


def read(run):
    if run.peaks is None or not run.n_epochs:
        return None
    done = run.flops_per_epoch * run.n_epochs
    return 100.0 * done / (run.window_s * run.peaks["fp32_flops_per_s"])
