"""Bytes the halo exchange handed to the backend per epoch, payload and
scale/zero: the ``bytes`` of the program's ``halo`` spans (what each
exchange that ran was given), summed over the window's epochs, in MB."""


def read(run):
    halos = [ev for ev in run.spans if ev["name"] == "halo"]
    if not halos:
        return None
    moved = sum((ev.get("args") or {}).get("bytes", 0) for ev in halos)
    return moved / run.n_epochs / 1e6
