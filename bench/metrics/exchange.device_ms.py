"""Device time of the halo exchange per epoch: the device intervals of the
program's ``halo`` spans (every exchange site and direction, timed on the
card: gather, quantize, exchange, dequantize, the masks and noise, the
boundary-gradient scatter), of nested ones the outermost only (by host
time), summed over the window and divided by its epochs."""


def read(run):
    halos = sorted((ev for ev in run.spans if ev["name"] == "halo"),
                   key=lambda ev: (ev["ts"], -ev["dur"]))
    if not any("ddur" in ev for ev in halos):
        return None
    total, end = 0.0, float("-inf")
    for ev in halos:
        if ev["ts"] + ev["dur"] <= end:
            continue                    # inside the last outermost span
        end = ev["ts"] + ev["dur"]
        total += ev.get("ddur", 0.0)
    return total / run.n_epochs * 1e3
