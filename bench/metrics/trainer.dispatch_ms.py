"""Host time of a step outside its loss's sync: the program's ``step`` span
minus its child ``wait`` span (the host enqueueing the step's work, and
waiting where it must), averaged over the window's steps."""


def read(run):
    steps = [ev for ev in run.spans if ev["name"] == "step"]
    waits = [ev for ev in run.spans if ev["name"] == "wait"]
    own = []
    for st in steps:
        lo, hi = st["ts"], st["ts"] + st["dur"]
        inner = [w["dur"] for w in waits if lo <= w["ts"] < hi]
        if inner:
            own.append(st["dur"] - sum(inner))
    if not own:
        return None
    return sum(own) / len(own) * 1e3
