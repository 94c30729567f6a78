"""Host time of an epoch outside its step: the program's ``epoch`` span
minus its child ``step`` span (the policy's decision, the step cache, the
telemetry and the byte accounting), averaged over the window's epochs."""


def read(run):
    epochs = [ev for ev in run.spans if ev["name"] == "epoch"]
    steps = [ev for ev in run.spans if ev["name"] == "step"]
    if not epochs:
        return None
    own = []
    for ep in epochs:
        lo, hi = ep["ts"], ep["ts"] + ep["dur"]
        inner = sum(s["dur"] for s in steps if lo <= s["ts"] < hi)
        own.append(ep["dur"] - inner)
    return sum(own) / len(own) * 1e3
