"""In-process request path: admission queue + microbatched cache lookups
(a copy of ``repro.serve.server``).

``EmbeddingServer`` fronts an
:class:`~repro_torch.serve.engine.InferenceEngine`
with the mechanisms a real serving tier needs even when the per-query work
is a cache lookup:

* **admission queue** — ``submit`` enqueues a request or *rejects* it with a
  typed :class:`Rejection` (reason, queue depth, retry hint) when
  ``max_queue`` requests are already waiting or the server is draining;
  back-pressure instead of unbounded latency;
* **microbatching** — ``step`` drains whole requests until the next one would
  overflow ``microbatch`` node ids, answers them with a single engine lookup,
  and stamps each response with its queue-to-completion latency;
* **deadlines** — a request submitted with ``deadline_s`` is *expired* (never
  served) once the clock passes it; late answers are worthless answers;
* **health state machine** — ``healthy → degraded → draining``. Degraded
  (a failed delta refresh, or a partition marked down) keeps answering every
  in-deadline request from the stale embedding cache, with per-node staleness
  stamps on the responses; draining stops admitting but serves out the queue.

The server is deliberately synchronous and single-threaded: the load
generator (``loadgen.py``) drives ``submit``/``step``, and determinism
(seeded ids, no thread scheduling, injectable ``clock``) keeps the latency
distribution reproducible. A lookup reads host memory only (the engine's
logits copy or the store); the card works only in ``refresh``. Under a
sharded runtime the server lives on rank 0, inside the engine's ``lead``
(the other ranks follow its refreshes).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional, Union

import numpy as np

from .. import obs
from .engine import LockstepError

# health states
HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"


@dataclasses.dataclass(frozen=True)
class Rejection:
    """A typed admission rejection (the back-off contract).

    ``reason`` is ``"queue_full"`` or ``"draining"``; ``depth`` the queue
    occupancy at rejection; ``retry_after_hint`` a server-side estimate (s)
    of when capacity frees up (an EMA of recent ``step`` times — 0.0 before
    any batch has been served). Deliberately *no* ``__bool__``: request id 0
    is falsy too, so clients must discriminate with ``isinstance``."""

    reason: str
    depth: int
    retry_after_hint: float


@dataclasses.dataclass
class Request:
    req_id: int
    node_ids: np.ndarray
    t_submit: float
    # absolute clock time after which the answer is worthless (None = never)
    deadline: Optional[float] = None


@dataclasses.dataclass
class Response:
    req_id: int
    node_ids: np.ndarray
    logits: np.ndarray
    latency_s: float
    # per-node staleness stamps (sweeps since the node's partition was last
    # recomputed; see engine.QueryResult.staleness) — None from engines that
    # predate the stamp.
    staleness: Optional[np.ndarray] = None

    @property
    def predictions(self) -> np.ndarray:
        return np.argmax(self.logits, axis=-1)


class EmbeddingServer:
    """Microbatched, admission-controlled front end over an engine.

    Example::

        srv = EmbeddingServer(engine, microbatch=128, max_queue=256)
        rid = srv.submit([1, 2, 3])
        [resp] = srv.step()
        assert resp.req_id == rid and resp.logits.shape == (3, n_classes)
    """

    # EMA factor for the per-step service-time estimate behind
    # Rejection.retry_after_hint.
    STEP_EMA = 0.7

    def __init__(self, engine, microbatch: int = 128, max_queue: int = 1024,
                 clock: Optional[Callable[[], float]] = None,
                 id_start: int = 0, id_stride: int = 1):
        if microbatch < 1 or max_queue < 1:
            raise ValueError("microbatch and max_queue must be >= 1")
        if id_stride < 1:
            raise ValueError("id_stride must be >= 1")
        self.engine = engine
        self.microbatch = microbatch
        self.max_queue = max_queue
        # default to the obs clock: perf_counter normally, the injected
        # deterministic clock when a FakeClock-armed tracer is active
        self.clock = clock if clock is not None else obs.clock
        self._queue: deque[Request] = deque()
        # replicas in a ReplicaSet interleave id spaces (start=i, stride=N)
        # so request ids stay globally unique across the set
        self._next_id = id_start
        self._id_stride = id_stride
        self.accepted = 0
        self.rejected = 0
        self.served = 0
        self.expired = 0
        self.refresh_failures = 0
        self.health = HEALTHY
        self._ema_step_s = 0.0

    @property
    def depth(self) -> int:
        """Requests currently waiting."""
        return len(self._queue)

    def _reject(self, reason: str) -> Rejection:
        self.rejected += 1
        obs.count(f"serve.rejected.{reason}")
        return Rejection(reason=reason, depth=len(self._queue),
                         retry_after_hint=self._ema_step_s)

    def submit(self, node_ids,
               deadline_s: Optional[float] = None) -> Union[int, Rejection]:
        """Enqueue a query batch. Returns the request id, or a typed
        :class:`Rejection` when the admission queue is full or the server is
        draining (the caller should back off and retry — discriminate with
        ``isinstance(r, Rejection)``, request id 0 is falsy too). A single
        request larger than the microbatch can never be scheduled and is a
        caller error. ``deadline_s`` is a *relative* latency budget: the
        request expires (is never served) once the clock passes
        ``now + deadline_s``."""
        ids = np.asarray(node_ids, dtype=np.int64).reshape(-1)
        if ids.size == 0 or ids.size > self.microbatch:
            raise ValueError(
                f"request size must be in [1, microbatch={self.microbatch}], "
                f"got {ids.size}")
        with obs.span("admit", {"n": int(ids.size)}):
            if self.health == DRAINING:
                return self._reject("draining")
            if len(self._queue) >= self.max_queue:
                return self._reject("queue_full")
            rid = self._next_id
            self._next_id += self._id_stride
            now = self.clock()
            deadline = None if deadline_s is None else now + float(deadline_s)
            self._queue.append(Request(rid, ids, now, deadline))
            self.accepted += 1
            return rid

    def _expire(self, now: float) -> None:
        """Drop every queued request whose deadline has already passed —
        serving it would spend a microbatch slot on a worthless answer."""
        if not any(r.deadline is not None for r in self._queue):
            return
        live = deque(r for r in self._queue
                     if r.deadline is None or r.deadline >= now)
        self.expired += len(self._queue) - len(live)
        self._queue = live

    def step(self) -> list[Response]:
        """Serve one microbatch: expire past-deadline requests, drain whole
        requests up to ``microbatch`` ids, answer them with a single cache
        lookup, return the responses (possibly empty when the queue is)."""
        t_start = self.clock()
        self._expire(t_start)
        batch: list[Request] = []
        total = 0
        while self._queue and total + self._queue[0].node_ids.size \
                <= self.microbatch:
            req = self._queue.popleft()
            batch.append(req)
            total += req.node_ids.size
        if not batch:
            return []
        flat = np.concatenate([r.node_ids for r in batch])
        with obs.span("request", {"requests": len(batch),
                                  "nodes": int(total)}):
            with obs.span("lookup"):
                res = self.engine.query(flat)
        logits = res.logits
        stamps = getattr(res, "staleness", None)
        now = self.clock()
        self._ema_step_s = (now - t_start if self._ema_step_s == 0.0 else
                            self.STEP_EMA * self._ema_step_s
                            + (1.0 - self.STEP_EMA) * (now - t_start))
        out, start = [], 0
        for r in batch:
            stop = start + r.node_ids.size
            out.append(Response(
                r.req_id, r.node_ids, logits[start:stop], now - r.t_submit,
                staleness=None if stamps is None else stamps[start:stop]))
            start = stop
        self.served += len(out)
        return out

    def drain(self) -> list[Response]:
        """Serve until the queue is empty."""
        out = []
        while self._queue:
            got = self.step()
            if not got and self._queue:
                break       # everything left just expired
            out.extend(got)
        return out

    # ------------------------------------------------------------------
    # health state machine: healthy -> degraded -> draining
    # ------------------------------------------------------------------
    def _recompute_health(self) -> None:
        if self.health == DRAINING:
            return          # draining is terminal until start_draining ends
        down = getattr(self.engine, "down_partitions", lambda: ())()
        self.health = DEGRADED if len(down) else HEALTHY

    def refresh(self, changed_ids, rows, **kw):
        """Delta-refresh through the health machine: forwards to
        ``engine.refresh``; on failure counts it, degrades (stale caches keep
        serving, stamped), and returns ``None`` instead of raising — the
        request path must survive a bad update. A sharded engine's
        :class:`~repro_torch.serve.engine.LockstepError` is not a bad update
        and is raised: the engine's ranks are out of step."""
        try:
            rep = self.engine.refresh(changed_ids, rows, **kw)
        except LockstepError:
            raise
        except Exception:
            self.refresh_failures += 1
            if self.health != DRAINING:
                self.health = DEGRADED
            return None
        self._recompute_health()
        return rep

    def mark_partition_down(self, part: int) -> None:
        """A partition stopped answering: its cached rows keep serving with
        staleness stamps; the server is degraded until it returns."""
        self.engine.set_down([part])
        self._recompute_health()

    def mark_partition_up(self, part: int) -> None:
        self.engine.set_up([part])
        self._recompute_health()

    def start_draining(self) -> None:
        """Stop admitting (submit returns Rejection("draining", ...)); the
        queue still serves out via ``step``/``drain``."""
        self.health = DRAINING


class ReplicaSet:
    """N admission-queued server replicas over one engine/store, behind the
    single-server interface (``submit``/``step``/``drain``/``refresh``) so
    the load generators drive either transparently.

    Each replica is an :class:`EmbeddingServer` over ``engine.reader()`` — a
    query-only :class:`~repro_torch.serve.engine.StoreReader` when the engine has a
    store attached (N replicas, one store), the engine itself otherwise.
    Admission is **load-balanced**: a submit goes to the least-loaded replica
    whose health admits it (draining replicas are skipped — the per-replica
    health state machine is the single-server one), so one slow or draining
    replica sheds load to its peers instead of rejecting it. Request ids are
    globally unique across the set (interleaved id spaces). Refreshes go to
    the one writer — the engine — through the same degrade-on-failure wrapper
    a single server uses, then every replica recomputes its health.

    Example::

        rs = ReplicaSet(engine, n_replicas=3, microbatch=64)
        rid = rs.submit([1, 2, 3])
        rs.replicas[1].start_draining()       # peers absorb its load
        responses = rs.drain()
    """

    def __init__(self, engine, n_replicas: int = 2, *, microbatch: int = 128,
                 max_queue: int = 1024,
                 clock: Optional[Callable[[], float]] = None):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.engine = engine
        # the set's clock is the replicas' clock (loadgen reads server.clock)
        self.clock = clock if clock is not None else obs.clock
        reader = getattr(engine, "reader", None)
        self.replicas = [
            EmbeddingServer(reader() if reader is not None else engine,
                            microbatch=microbatch, max_queue=max_queue,
                            clock=clock, id_start=i, id_stride=n_replicas)
            for i in range(n_replicas)]
        self.refresh_failures = 0
        self._rr = 0            # step() rotation so no replica starves

    # -- aggregate state ----------------------------------------------------
    @property
    def depth(self) -> int:
        return sum(s.depth for s in self.replicas)

    @property
    def health(self) -> str:
        """Worst-of: draining only when *every* replica drains (the set still
        admits while any replica does); degraded when any replica is."""
        states = [s.health for s in self.replicas]
        if all(h == DRAINING for h in states):
            return DRAINING
        if any(h == DEGRADED for h in states):
            return DEGRADED
        return HEALTHY

    @property
    def accepted(self) -> int:
        return sum(s.accepted for s in self.replicas)

    @property
    def rejected(self) -> int:
        return sum(s.rejected for s in self.replicas)

    @property
    def served(self) -> int:
        return sum(s.served for s in self.replicas)

    @property
    def expired(self) -> int:
        return sum(s.expired for s in self.replicas)

    # -- request path -------------------------------------------------------
    def submit(self, node_ids,
               deadline_s: Optional[float] = None) -> Union[int, Rejection]:
        """Route to the admitting replica with the shallowest queue (ties to
        the lowest index — deterministic). Rejected only when every replica
        is draining or the chosen queue is full."""
        live = [s for s in self.replicas if s.health != DRAINING]
        if not live:
            # count the turn-away on the first replica so aggregate stats
            # still see it
            return self.replicas[0]._reject("draining")
        target = min(live, key=lambda s: s.depth)
        return target.submit(node_ids, deadline_s=deadline_s)

    def step(self) -> list[Response]:
        """One microbatch from each replica, starting after the last replica
        served first (rotating order keeps service fair under load)."""
        out: list[Response] = []
        n = len(self.replicas)
        for k in range(n):
            out.extend(self.replicas[(self._rr + k) % n].step())
        self._rr = (self._rr + 1) % n
        return out

    def drain(self) -> list[Response]:
        out: list[Response] = []
        while self.depth:
            got = self.step()
            if not got and self.depth:
                break           # everything left just expired
            out.extend(got)
        return out

    # -- the one writer -----------------------------------------------------
    def refresh(self, changed_ids, rows, **kw):
        """Refresh through the engine (the single writer); on failure count
        it and degrade every replica — stale rows keep serving, stamped
        (a :class:`~repro_torch.serve.engine.LockstepError` is raised, as in
        :meth:`EmbeddingServer.refresh`)."""
        try:
            rep = self.engine.refresh(changed_ids, rows, **kw)
        except LockstepError:
            raise
        except Exception:
            self.refresh_failures += 1
            for s in self.replicas:
                s.refresh_failures += 1
                if s.health != DRAINING:
                    s.health = DEGRADED
            return None
        for s in self.replicas:
            s._recompute_health()
        return rep

    def mark_partition_down(self, part: int) -> None:
        self.engine.set_down([part])
        for s in self.replicas:
            s._recompute_health()

    def mark_partition_up(self, part: int) -> None:
        self.engine.set_up([part])
        for s in self.replicas:
            s._recompute_health()

    def per_replica(self) -> list[dict]:
        """Per-replica accounting for reports (the load-balance evidence)."""
        return [dict(replica=i, health=s.health, accepted=s.accepted,
                     served=s.served, rejected=s.rejected, expired=s.expired,
                     depth=s.depth)
                for i, s in enumerate(self.replicas)]
