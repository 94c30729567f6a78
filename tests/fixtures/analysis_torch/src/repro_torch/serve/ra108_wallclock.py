"""Planted RA108: a raw wall-clock read inside an obs-instrumented module.

serve/ reads every timestamp through ``repro_torch.obs.clock()`` (or an
injected clock), so FakeClock tests and span traces share one time source;
a direct ``time.perf_counter()`` forks the timeline. Exactly one offending
call: ``time.sleep`` below stays legal (it waits, it does not measure).
"""
import time


def measure_step(server):
    time.sleep(0.0)
    t0 = time.perf_counter()          # RA108: bypasses the injected clock
    server.step()
    return t0
