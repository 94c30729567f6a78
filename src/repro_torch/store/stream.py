"""Streaming graph mutations: a seeded, timestamped feed of node-feature and
edge events, consumed in batches that drive the engine's k-hop delta
refreshes (a copy of ``repro.store.stream``: the same seed gives the same
events).

The feed models a continuously-updating graph (the ``gdelt_like`` regime —
an event stream touching a heavy-tailed set of actors):

* arrivals are **Poisson** at ``rate`` events per (virtual) second, so batch
  sizes are bursty the way real update streams are;
* the touched node is drawn from a **Zipf-skewed** popularity (exponent
  ``skew`` over a seeded permutation) — the same hot nodes mutate again and
  again, which is exactly what the store's pinned hot tier banks on;
* an event is a **feature mutation** with probability ``feat_frac``
  (replacement feature row, seeded Gaussian) and an **edge event**
  otherwise (a new interaction between two drawn nodes).

Consumption contract (``batches``): events are grouped into fixed
``window_s`` consumption windows. Within a window, feature mutations
last-write-win per node; edge events *touch* both endpoints — under the
static partition plan a topology change cannot be incorporated without
repartitioning, so the conservative correct action is to re-ship the
endpoints' k-hop neighborhoods (their current feature rows re-enter the
changed set, invalidating every embedding the new edge could have reached).
Each batch is ``(t_due, changed_ids, rows)`` ready for
``engine.refresh``/``server.refresh`` — the engine's ``max_staleness`` bound
then decides delta vs forced full sweep exactly as for any other refresh.

Everything is a pure function of the constructor arguments: two streams with
the same ``(n_nodes, d_feat, kwargs, seed)`` are event-for-event identical.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Mutation:
    """One timestamped graph event.

    ``kind`` is ``"feat"`` (``row`` replaces node ``node``'s features) or
    ``"edge"`` (a new ``node -> dst`` interaction; ``row`` is None)."""

    t: float
    kind: str
    node: int
    dst: int = -1
    row: Optional[np.ndarray] = None


def zipf_popularity(n_nodes: int, skew: float, seed: int) -> np.ndarray:
    """Normalized Zipf-like popularity over a seeded node permutation
    (``skew=0`` is uniform). Shared by the stream and the skewed query
    workloads in ``serve/loadgen.py`` so both hammer the same hot
    set."""
    pop = 1.0 / (np.arange(1, n_nodes + 1, dtype=np.float64) ** float(skew))
    pop = pop[np.random.default_rng(seed).permutation(n_nodes)]
    return pop / pop.sum()


class MutationStream:
    """Seeded, timestamped node-feature/edge mutation feed.

    Example::

        g, stream = MutationStream.from_workload("gdelt_like@smoke")
        for t_due, ids, rows in stream.batches(200, window_s=0.25,
                                               rows_of=eng.feature_rows):
            server.refresh(ids, rows)
    """

    def __init__(self, n_nodes: int, d_feat: int, *, rate: float = 100.0,
                 feat_frac: float = 0.8, skew: float = 0.9, seed: int = 0):
        if not 0.0 <= feat_frac <= 1.0:
            raise ValueError("feat_frac must be in [0, 1]")
        if rate <= 0:
            raise ValueError("rate must be > 0 events/s")
        self.n_nodes = int(n_nodes)
        self.d_feat = int(d_feat)
        self.rate = float(rate)
        self.feat_frac = float(feat_frac)
        self.skew = float(skew)
        self.seed = int(seed)
        self._pop = zipf_popularity(self.n_nodes, self.skew, self.seed)

    @staticmethod
    def from_workload(ref: str, seed: int = 0):
        """Build the graph *and* its calibrated stream from a registry
        workload that declares per-tier ``stream`` kwargs (``gdelt_like``).
        Returns ``(graph, stream)``; raises KeyError for workloads without a
        stream calibration at that tier."""
        from ..datasets import registry
        name, tier = registry.parse(ref)
        spec = registry.get(name)
        if not spec.stream or tier not in spec.stream:
            raise KeyError(
                f"workload {name!r} declares no mutation stream at tier "
                f"{tier!r} (streaming tiers: "
                f"{sorted(spec.stream) if spec.stream else []})")
        g = spec.load(tier, seed=seed)
        return g, MutationStream(g.n_nodes, g.x.shape[1], seed=seed + 1,
                                 **spec.stream[tier])

    def events(self, n_events: int) -> list[Mutation]:
        """The first ``n_events`` events of the feed (deterministic — calling
        twice returns identical events, timestamps included)."""
        rng = np.random.default_rng(self.seed)
        ts = np.cumsum(rng.exponential(1.0 / self.rate, size=n_events))
        nodes = rng.choice(self.n_nodes, size=n_events, p=self._pop)
        is_feat = rng.random(n_events) < self.feat_frac
        dsts = rng.choice(self.n_nodes, size=n_events, p=self._pop)
        out = []
        for i in range(n_events):
            if is_feat[i]:
                row = rng.normal(0, 1, self.d_feat).astype(np.float32)
                out.append(Mutation(float(ts[i]), "feat", int(nodes[i]),
                                    row=row))
            else:
                out.append(Mutation(float(ts[i]), "edge", int(nodes[i]),
                                    dst=int(dsts[i])))
        return out

    def batches(self, n_events: int, window_s: float, *,
                rows_of: Callable[[np.ndarray], np.ndarray]
                ) -> list[tuple[float, np.ndarray, np.ndarray]]:
        """Group the first ``n_events`` events into ``window_s`` consumption
        windows. Per window: feature rows last-write-win per node; edge
        events touch their endpoints at current features (``rows_of`` maps
        node ids to their current rows — typically
        ``engine.feature_rows``). Returns ``(t_due, ids, rows)`` batches
        (``t_due`` = window close), empty windows skipped."""
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        out = []
        feats: dict[int, np.ndarray] = {}
        touched: set[int] = set()
        due = float(window_s)

        def flush(due_t: float):
            if not feats and not touched:
                return
            ids = np.array(sorted(set(feats) | touched), dtype=np.int64)
            rows = rows_of(ids).astype(np.float32).copy()
            for j, i in enumerate(ids.tolist()):
                if i in feats:
                    rows[j] = feats[i]
            out.append((due_t, ids, rows))
            feats.clear()
            touched.clear()

        for ev in self.events(n_events):
            while ev.t > due:
                flush(due)
                due += window_s
            if ev.kind == "feat":
                feats[ev.node] = ev.row
            else:
                touched.add(ev.node)
                touched.add(ev.dst)
        flush(due)
        return out
