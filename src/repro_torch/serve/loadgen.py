"""Seeded load generators for the serving request path (a copy of
``repro.serve.loadgen``: the same seed offers the same load).

Two offered-load models, both byte-identical across runs with the same seed:

**Closed-loop** (:func:`closed_loop`): ``clients`` logical clients each keep
exactly one request in flight — a client issues, waits for its response, then
immediately issues the next (the standard closed-system model, so offered
load adapts to service rate instead of overrunning it).

**Open-loop** (:func:`open_loop`): Poisson arrivals at a *fixed* QPS,
independent of completions — the SLO-measurement regime. Latency is charged
from the scheduled arrival, rejected submits are lost requests, and an
optional mutation feed exercises the refresh path concurrently.

The report holds completed requests, QPS, p50/p99 latency (measured queue-to-completion through the server's
microbatcher), admission rejections, and the id-distribution parameters that
produced it. Optionally interleaves a feature-refresh every
``refresh_every`` completed requests to measure the mixed read/refresh
regime.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from .. import obs
from .server import EmbeddingServer, Rejection

# retry/backoff shape on admission rejection: exponential with full jitter,
# seeded (the backoff draws come from the workload RNG, so runs stay
# reproducible). The base/cap are tiny because the in-process server frees
# capacity per step() call, not per network round-trip.
BACKOFF_BASE_S = 1e-4
BACKOFF_CAP_S = 0.05


def _clock_and_sleep(server, clock):
    """Resolve the loop's time source: an explicit ``clock``, else the
    server's (both default to ``repro_torch.obs.clock``). A clock that knows how to
    sleep (``FakeClock.sleep`` advances fake time) also replaces the real
    ``time.sleep`` — so SLO loops under a fake clock idle without wall waits."""
    if clock is None:
        clock = getattr(server, "clock", None) or obs.clock
    return clock, getattr(clock, "sleep", time.sleep)


def percentiles_ms(latencies_s) -> dict:
    lat = np.asarray(sorted(latencies_s), dtype=np.float64) * 1e3
    if lat.size == 0:
        return dict(p50_ms=0.0, p99_ms=0.0, mean_ms=0.0)
    return dict(p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)),
                mean_ms=float(lat.mean()))


def closed_loop(server: EmbeddingServer, n_nodes: int, *, clients: int = 8,
                batch: int = 16, requests: int = 200, seed: int = 0,
                refresh_every: Optional[int] = None, refresh_nodes: int = 0,
                clock: Optional[Callable[[], float]] = None) -> dict:
    """Drive ``server`` with ``clients`` closed-loop clients until
    ``requests`` responses complete; return the load report dict.

    ``refresh_every``/``refresh_nodes`` interleave an engine delta refresh
    (random nodes, re-seeded feature rows) every N completions — the mixed
    serving + incremental-update regime. Refresh wire bytes are totaled in
    the report, refresh time is *included* in the wall clock (it stalls the
    request path, exactly as it would in-process)."""
    rng = np.random.default_rng(seed)
    latencies: list[float] = []
    refresh_bytes = 0
    refreshes = refresh_failures = 0
    issued = completed = 0
    outstanding = 0
    attempts = 0            # consecutive rejected submits (backoff exponent)
    backoff_s = 0.0
    reject_reasons: dict[str, int] = {}
    d_feat = server.engine.pg.x.shape[-1]
    next_refresh = refresh_every if refresh_every else None
    clock, sleep = _clock_and_sleep(server, clock)
    t0 = clock()
    while completed < requests:
        while outstanding < clients and issued < requests:
            ids = rng.integers(0, n_nodes, size=batch)
            r = server.submit(ids)
            if isinstance(r, Rejection):
                reject_reasons[r.reason] = reject_reasons.get(r.reason, 0) + 1
                if r.reason == "draining":
                    break   # not transient — nothing a retry can fix
                # exponential backoff with full jitter, floored by the
                # server's own capacity estimate
                delay = min(BACKOFF_CAP_S, BACKOFF_BASE_S * (2 ** attempts))
                delay = max(delay * rng.random(),
                            min(r.retry_after_hint, BACKOFF_CAP_S))
                attempts += 1
                backoff_s += delay
                sleep(delay)
                break       # let step() drain before re-offering load
            attempts = 0
            issued += 1
            outstanding += 1
        served = server.step()
        for resp in served:
            latencies.append(resp.latency_s)
            completed += 1
            outstanding -= 1
        # deadline expiry (none by default) silently retires in-flight work;
        # the queue *is* the outstanding set in this closed loop
        outstanding = server.depth
        if not served and not server.depth and \
                (issued >= requests or server.health == "draining"):
            break           # drained, or the server stopped admitting
        if next_refresh is not None and completed >= next_refresh:
            ids = rng.choice(n_nodes, size=max(1, refresh_nodes),
                             replace=False)
            rows = rng.normal(0, 1, size=(ids.size, d_feat)).astype(np.float32)
            rep = server.refresh(ids, rows)
            if rep is None:
                refresh_failures += 1
            else:
                refresh_bytes += rep.wire_bytes
                refreshes += 1
            # advance past *completed*, not one notch: a microbatch can
            # retire many requests at once, and one fixed step would leave
            # next_refresh behind `completed` forever after — every loop
            # iteration would refresh, drowning the configured cadence
            while next_refresh <= completed:
                next_refresh += refresh_every
    seconds = clock() - t0
    report = dict(requests=int(completed), clients=int(clients),
                  batch=int(batch), seed=int(seed), seconds=float(seconds),
                  qps=float(completed / max(seconds, 1e-9)),
                  rejected=int(server.rejected),
                  rejection_reasons=dict(reject_reasons),
                  backoff_s=float(backoff_s),
                  expired=int(server.expired),
                  refreshes=int(refreshes),
                  refresh_failures=int(refresh_failures),
                  refresh_wire_bytes=int(refresh_bytes),
                  **percentiles_ms(latencies))
    return report


def open_loop(server: EmbeddingServer, n_nodes: int, *, qps: float,
              requests: int = 500, batch: int = 16, seed: int = 0,
              skew: float = 0.0, slo_ms: Optional[float] = None,
              deadline_s: Optional[float] = None,
              feed: Optional[list] = None,
              clock: Optional[Callable[[], float]] = None) -> dict:
    """Sustained open-loop load: seeded Poisson arrivals at a *fixed* offered
    rate, independent of service completions — the SLO-measurement regime
    (a closed loop can never overrun the server, an open loop can and should).

    Arrival times are drawn up front (``Exponential(1/qps)`` inter-arrivals,
    cumsum'd), so the offered schedule is byte-identical across runs with the
    same seed. Latency is measured **from the scheduled arrival**, not from
    the (possibly late) submit — generator lag counts against the server,
    exactly as queueing delay does in an open system. A rejected submit is a
    *lost* request (open-loop clients don't retry); losses fail the SLO
    accounting by never completing.

    ``skew > 0`` draws node ids from a :func:`repro_torch.store.stream.zipf_popularity`
    distribution instead of uniformly — the hot-node workload the store's
    cache tier is gated on.

    ``feed`` is an optional list of ``(t_due, ids, rows)`` mutation batches
    (see :meth:`repro_torch.store.stream.MutationStream.batches`, timestamps
    relative to the run start): each batch is applied through
    ``server.refresh`` as soon as the wall clock passes ``t_due``, and the
    report tracks refresh lag (apply time minus due time) plus how many
    deltas the staleness bound escalated to full sweeps.

    ``slo_ms`` arms the pass/fail gate: ``slo_pass`` is True iff p99 latency
    is within the SLO *and* nothing was lost to rejection or deadline expiry.
    """
    if qps <= 0:
        raise ValueError("qps must be > 0")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / qps, size=requests))
    if skew > 0.0:
        from ..store.stream import zipf_popularity
        popularity = zipf_popularity(n_nodes, skew, seed)
        all_ids = rng.choice(n_nodes, size=(requests, batch), p=popularity)
    else:
        all_ids = rng.integers(0, n_nodes, size=(requests, batch))
    feed = sorted(feed, key=lambda b: b[0]) if feed else []
    latencies: list[float] = []
    arrival_of: dict[int, float] = {}
    lost = completed = 0
    reject_reasons: dict[str, int] = {}
    refreshes = refresh_failures = escalations = 0
    refresh_bytes = 0
    refresh_lags: list[float] = []
    i = j = 0               # next arrival / next feed batch
    clock, sleep = _clock_and_sleep(server, clock)
    t0 = clock()
    while True:
        now = clock() - t0
        # mutation feed: apply at most ONE due batch per iteration — a
        # refresh stalls the request path, so consecutive due batches are
        # interleaved with serving steps instead of stacking into one long
        # pause (the lag accounting below records how far behind we run)
        if j < len(feed) and feed[j][0] <= now:
            t_due, ids, rows = feed[j]
            j += 1
            rep = server.refresh(ids, rows)
            if rep is None:
                refresh_failures += 1
                continue
            refreshes += 1
            refresh_bytes += rep.wire_bytes
            refresh_lags.append((clock() - t0) - t_due)
            if rep.kind == "full" and rep.forced:
                escalations += 1
        # offered load: submit every arrival the clock has passed
        while i < requests and arrivals[i] <= now:
            r = server.submit(all_ids[i], deadline_s=deadline_s)
            if isinstance(r, Rejection):
                reject_reasons[r.reason] = reject_reasons.get(r.reason, 0) + 1
                lost += 1
            else:
                arrival_of[r] = float(arrivals[i])
            i += 1
        served = server.step()
        t_done = clock() - t0
        for resp in served:
            latencies.append(t_done - arrival_of.pop(resp.req_id))
            completed += 1
        if i >= requests and j >= len(feed) and server.depth == 0:
            break
        if not served and server.depth == 0:
            # idle: sleep to the next scheduled event instead of spinning
            upcoming = [arrivals[i]] if i < requests else []
            if j < len(feed):
                upcoming.append(feed[j][0])
            if upcoming:
                wait = min(upcoming) - (clock() - t0)
                if wait > 0:
                    sleep(wait)
    seconds = clock() - t0
    expired = len(arrival_of)       # submitted but never answered (deadline)
    stats = percentiles_ms(latencies)
    slo_pass = None
    if slo_ms is not None:
        slo_pass = bool(stats["p99_ms"] <= slo_ms and lost == 0
                        and expired == 0)
    return dict(mode="open", offered=int(requests),
                completed=int(completed), lost=int(lost),
                expired=int(expired), batch=int(batch), seed=int(seed),
                skew=float(skew), qps_offered=float(qps),
                qps_achieved=float(completed / max(seconds, 1e-9)),
                seconds=float(seconds),
                rejection_reasons=dict(reject_reasons),
                refreshes=int(refreshes),
                refresh_failures=int(refresh_failures),
                refresh_escalations=int(escalations),
                refresh_wire_bytes=int(refresh_bytes),
                refresh_lag_max_s=float(max(refresh_lags, default=0.0)),
                refresh_lag_mean_s=float(np.mean(refresh_lags))
                if refresh_lags else 0.0,
                slo_ms=None if slo_ms is None else float(slo_ms),
                slo_pass=slo_pass, **stats)
