"""Partitioned full-graph inference engine with per-layer embedding caches.

``InferenceEngine`` takes a model and its parameters (or restores them from a
checkpoint) and serves node queries off materialized caches:

* **one sweep function** runs the model forward through the quantized-halo
  machinery (``ServeComm``): per-site bit-widths come from an
  :class:`~repro_torch.policy.base.EpochDecision`. A full sweep and an
  incremental **delta refresh** are the same function: it takes per-site
  "affected" send masks as data and blends freshly exchanged halo rows with
  the cached ones (``where(affected, fresh, cached)``). A full sweep is the
  all-rows mask; a delta refresh ships only the k-hop frontier of the changed
  nodes (``serve/delta.py``). With deterministic rounding and kernels that
  give the same bits on every run, delta == full exactly;
* after a sweep the engine holds, per exchange site, the embedding entering
  that site (``(P, n_local, d_i)``) and its dequantized halo buffer, plus the
  final logits — node queries are a lookup: global id -> (partition, slot)
  -> cached row, no graph compute on the request path.

The device is the runtime's (``Runtime.simulated(P)``: the CUDA card unless
the caller asks for the CPU); on it the Low-bit Module and the aggregation
run as the CUDA kernels of ``repro_torch.kernels``.

``ServeConfig.max_staleness`` caps consecutive delta refreshes; the next
``refresh()`` past the bound escalates to a full sweep.

Around the sweep, as in ``repro.serve.engine``: degraded mode (partitions
marked down stop publishing fresh halo rows and serve frozen, stamped
logits), an optional sharded embedding store (``repro_torch.store``) that
every sweep publishes into and queries read through, query-only
:class:`StoreReader` replicas, and the ``refresh > plan > sweep`` spans of
``repro_torch.obs``. The ``sweep`` span covers the sweep's launches; the
copy of the logits to the host comes after it and waits for the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..core import quantization as qlib
from ..core.exchange import (exchange_halo, exchange_quantized_halo,
                             gather_boundary)
from ..core.staleness import HaloState
from ..core.sylvie import SylvieComm, SylvieConfig
from ..dist import overlap as olap
from ..dist.runtime import Runtime
from ..graph.partition import PartitionedGraph, global_to_slot, khop_frontier
from ..models.convert import params_from_numpy, params_to_numpy
from ..models.gnn import blocks as B
from ..policy.base import EpochDecision, validate_decision
from ..train import checkpoint as ckpt
from . import delta as deltalib


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-time communication + refresh policy.

    ``bits`` quantizes every halo exchange of the serving forward pass
    (32 = full precision; per-site widths via an explicit ``decision``).
    ``stochastic=False`` (the default) rounds to nearest, half to even — what
    the delta-refresh exactness guarantee needs. ``max_staleness`` is the
    number of consecutive delta refreshes served before the next refresh is
    forced to a full sweep. ``schedule`` is ``"blocking"`` or ``"overlap"``
    (bit-identical: on the card the overlap schedule issues each site's
    exchange on the backend's side stream and lands it through the fence of
    ``dist/overlap.py``)."""

    bits: int = 1
    stochastic: bool = False
    max_staleness: int = 8
    scale_dtype: torch.dtype = torch.bfloat16
    schedule: str = "blocking"


class ServeComm(SylvieComm):
    """Forward-only quantized halo with delta blending.

    At site ``i``: quantize the (full) send buffer, exchange, dequantize, then
    keep only the rows the refresh plan marked affected — every other row
    comes from ``cached_halos[i]``. The affected mask travels through the same
    exchange (as uint8) so each partition learns which received rows are
    fresh. Records the site-input embedding (the per-layer cache) and the
    blended halo (the next refresh's cache) as it goes."""

    def __init__(self, cfg, plan, generator, backend, decision, cached_halos,
                 send_affected):
        super().__init__(cfg, plan, generator, backend=backend,
                         decision=decision)
        self.cached_halos = cached_halos
        self.send_affected = send_affected
        self.layer_inputs: list = []

    def halo(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        i = self._site
        self._site += 1
        sd = self._site_decision(i)
        self.layer_inputs.append(h)
        aff_send = self.send_affected[i][..., None]
        if self.schedule == "overlap":
            # gather, quantize and exchange on the side stream; the mask's
            # exchange runs meanwhile; the fence lands the payload
            inflight = olap._issue(h, lambda t: gather_boundary(t, self.plan),
                                   sd.fwd_bits, sd.stochastic,
                                   cfg.scale_dtype, self.backend, self.plan,
                                   self.generator)
            aff = exchange_halo(aff_send, self.plan, self.backend)
            fresh = olap._land(inflight, self.backend)
        else:
            buf = gather_boundary(h, self.plan)
            qt = qlib.quantize(buf, sd.fwd_bits, self.generator,
                               sd.stochastic, cfg.scale_dtype)
            qr = exchange_quantized_halo(qt, self.plan, self.backend)
            aff = exchange_halo(aff_send, self.plan, self.backend)
            fresh = qlib.dequantize(qr)
        fresh = torch.where(self.plan.recv_mask[..., None], fresh, 0.0)
        halo = torch.where(aff > 0, fresh, self.cached_halos[i])
        self.new_feat_caches.append(halo)
        return halo


@dataclasses.dataclass
class QueryResult:
    """One answered query batch.

    ``staleness[j]`` counts the sweeps served from cache for node ``j``'s
    partition since its rows were last recomputed — 0 everywhere while the
    engine is healthy, >0 for nodes on a partition marked down (degraded
    mode: answers come from the frozen cache, stamped, never refused)."""

    node_ids: np.ndarray
    logits: np.ndarray
    staleness: Optional[np.ndarray] = None

    @property
    def predictions(self) -> np.ndarray:
        return np.argmax(self.logits, axis=-1)


class InferenceEngine:
    """Quantized full-graph inference over a partitioned graph.

    Example::

        pg, _ = datasets.load_partitioned("reddit_like@paper", n_parts=4)
        model = GCN(602, 256, 41, generator=torch.Generator().manual_seed(0))
        eng = InferenceEngine(model, pg, config=ServeConfig(bits=1),
                              runtime=Runtime.simulated(4))
        eng.full_sweep()                        # materialize all caches
        out = eng.query([3, 17, 4242])          # lookup
        rep = eng.refresh(changed_ids, new_rows)   # k-hop delta refresh

    ``params`` (nested dicts of arrays, the JAX parameter-tree layout) are
    copied into ``model`` when given; otherwise the model's own parameters
    serve. ``store`` (a :class:`repro_torch.store.StoreBackend`) is attached
    with :meth:`attach_store`."""

    # store table names: cached logits + the deepest cached embedding layer
    # (what ``embeddings(site=-1)`` serves).
    STORE_TABLES = ("logits", "emb")

    def __init__(self, model, pg: PartitionedGraph, params=None,
                 config: Optional[ServeConfig] = None,
                 decision: Optional[EpochDecision] = None,
                 runtime: Optional[Runtime] = None, seed: int = 0,
                 store=None):
        self.model = model
        self.pg = pg
        self.config = cfg = config if config is not None else ServeConfig()
        p = pg.plan.n_parts
        if runtime is None:
            runtime = Runtime.simulated(p)
        if runtime.n_parts not in (None, p):
            raise ValueError(
                f"runtime is committed to {runtime.n_parts} partitions but "
                f"the graph was partitioned into {p}")
        self.runtime = runtime
        self.device = dev = runtime.device
        self.site_dims = tuple(int(d) for d in model.comm_dims())
        self.n_sites = len(self.site_dims)
        if decision is None:
            decision = EpochDecision.uniform(self.n_sites, bits=cfg.bits,
                                             stochastic=cfg.stochastic,
                                             schedule=cfg.schedule)
        self.decision = validate_decision(decision.snapped(), self.n_sites)
        self._scfg = SylvieConfig(mode="sync", bits=cfg.bits,
                                  stochastic=cfg.stochastic,
                                  scale_dtype=cfg.scale_dtype,
                                  schedule=self.decision.schedule)
        if params is not None:
            params_from_numpy(model, params)
        model.to(dev).eval()
        self.block = B.build_block(pg, dev)
        self.seed = seed

        # global id -> (partition, local slot): the lookup request path
        self._part_of, self._slot_of = global_to_slot(pg)

        self._sweep = self._build_sweep()
        # refresh planning amortizes the O(E) edge/ownership reconstruction
        self._frontier = deltalib.FrontierIndex.build(pg)
        self._x_host = np.asarray(pg.x, dtype=np.float32).copy()
        self.x = torch.tensor(self._x_host, device=dev)
        self._halos = HaloState.zeros(self.block.plan, self.site_dims,
                                      stacked_parts=p, device=dev).feats
        self._layers: Optional[tuple] = None
        self._logits_host: Optional[np.ndarray] = None
        self._since_full = 0
        self._refresh_count = 0
        # degraded mode: partitions marked down contribute no fresh halo
        # rows (their send-affected masks are zeroed on the card — data, the
        # sweep's launches are unchanged) and their cached logits are
        # frozen; per-partition staleness counts sweeps served from the
        # frozen cache.
        self._down = np.zeros(p, dtype=bool)
        self._part_staleness = np.zeros(p, dtype=np.int64)
        # optional sharded embedding store: node lookups read through it,
        # sweeps publish into it (see attach_store)
        self.store = None
        if store is not None:
            self.attach_store(store)

    # ------------------------------------------------------------------
    # the sweep (shared by full sweeps and delta refreshes)
    # ------------------------------------------------------------------
    def _build_sweep(self):
        model, scfg, decision = self.model, self._scfg, self.decision
        backend = self.runtime.backend

        def sweep_fn(block, x, halos, masks, generator):
            comm = ServeComm(scfg, block.plan, generator, backend, decision,
                             cached_halos=halos, send_affected=masks)
            with torch.inference_mode():
                logits = model(block, x, comm)
            return logits, tuple(comm.layer_inputs), \
                tuple(comm.new_feat_caches)

        return self.runtime.shard_serve_fn(sweep_fn)

    def _generator(self) -> torch.Generator:
        """The stochastic-rounding noise stream of the next sweep: a pure
        function of (seed, sweep count)."""
        state = np.random.SeedSequence([self.seed, self._refresh_count])
        self._refresh_count += 1
        g = torch.Generator(device=self.device)
        g.manual_seed(int(state.generate_state(1)[0]))
        return g

    def _run(self, refresh: deltalib.RefreshPlan, *, kind: str, forced: bool,
             changed_ids: Optional[np.ndarray] = None
             ) -> deltalib.RefreshReport:
        t0 = obs.clock()
        generator = self._generator()
        masks = refresh.device_masks(self.device)
        if self._down.any():
            # down partitions publish nothing fresh: zero their send-affected
            # rows so every receiver keeps its cached rows from them
            up = torch.as_tensor(~self._down, dtype=torch.uint8,
                                 device=self.device)[:, None]
            masks = tuple(m * up for m in masks)
        with obs.span("sweep", {"kind": kind}):
            logits, layers, halos = self._sweep(self.block, self.x,
                                                self._halos, masks, generator)
        self._layers = layers
        self._halos = halos
        fresh_logits = logits.cpu().numpy()
        if self._logits_host is not None and self._down.any():
            # a down partition computes nothing: its served rows stay frozen
            # at the last sweep before it went down (patched into a copy:
            # on the CPU the array shares the sweep's tensor)
            fresh_logits = fresh_logits.copy()
            fresh_logits[self._down] = self._logits_host[self._down]
        self._logits_host = fresh_logits
        self._part_staleness = np.where(self._down,
                                        self._part_staleness + 1, 0)
        if self.store is not None:
            # full sweeps republish every row; deltas only the rows the
            # sweep could have changed (the logits-depth frontier)
            self._publish(None if kind == "full" else changed_ids)
        pb, eb, mb = deltalib.refresh_wire_bytes(
            self.block.plan.real_rows, self.site_dims, self.decision, refresh,
            self.config.scale_dtype)
        return deltalib.RefreshReport(
            kind=kind, forced=forced, changed=refresh.changed,
            affected_rows=refresh.affected_rows, payload_bytes=pb,
            ec_bytes=eb, meta_bytes=mb, seconds=obs.clock() - t0)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    @staticmethod
    def from_checkpoint(ckpt_dir, model, pg: PartitionedGraph,
                        config: Optional[ServeConfig] = None,
                        decision: Optional[EpochDecision] = None,
                        runtime: Optional[Runtime] = None,
                        step: Optional[int] = None, seed: int = 0,
                        store=None) -> tuple["InferenceEngine", dict]:
        """Restore only the model parameters (``restore_for_inference``; a
        checkpoint of either package) and build an engine. Returns
        ``(engine, checkpoint_meta)``."""
        params, meta = ckpt.restore_for_inference(
            ckpt_dir, params_to_numpy(model), step=step)
        return InferenceEngine(model, pg, params, config=config,
                               decision=decision, runtime=runtime,
                               seed=seed, store=store), meta

    def full_sweep(self) -> deltalib.RefreshReport:
        """Recompute every cache from the current features (all boundary rows
        ship). Resets the staleness clock."""
        rep = self._run(deltalib.plan_full(self.pg, self.n_sites),
                        kind="full", forced=False)
        self._since_full = 0
        return rep

    def refresh(self, changed_global_ids, new_rows, *,
                full: bool = False) -> deltalib.RefreshReport:
        """Apply a feature update and refresh the caches incrementally.

        ``new_rows`` replace the features of ``changed_global_ids`` (same
        order). Ships only the k-hop-affected boundary rows per layer;
        escalates to a full sweep when ``full=True``, when the staleness bound
        is reached, or when no sweep has run yet."""
        ids = self._check_ids(changed_global_ids)
        rows = np.asarray(new_rows, dtype=np.float32)
        if rows.shape != (ids.size, self._x_host.shape[-1]):
            raise ValueError(
                f"new_rows must be ({ids.size}, {self._x_host.shape[-1]}), "
                f"got {rows.shape}")
        parts, slots = self._part_of[ids], self._slot_of[ids]
        # O(changed) update of the device features and the host copy
        self._x_host[parts, slots] = rows
        self.x[torch.as_tensor(parts, device=self.device),
               torch.as_tensor(slots, device=self.device)] = \
            torch.as_tensor(rows, device=self.device)
        never_swept = self._logits_host is None
        with obs.span("refresh", {"changed": int(ids.size)}):
            if full or never_swept or \
                    self._since_full >= self.config.max_staleness:
                rep = self._run(deltalib.plan_full(self.pg, self.n_sites),
                                kind="full", forced=not full)
                rep = dataclasses.replace(rep, changed=int(ids.size))
                self._since_full = 0
                return rep
            with obs.span("plan"):
                plan = self._frontier.plan_refresh(ids, self.n_sites)
            rep = self._run(plan, kind="delta", forced=False, changed_ids=ids)
            self._since_full += 1
            return rep

    # ------------------------------------------------------------------
    # degraded mode (partition down/up)
    # ------------------------------------------------------------------
    def set_down(self, parts) -> None:
        """Mark partitions down. Their cached rows keep serving (stamped with
        growing staleness); sweeps stop consuming their halo contributions."""
        self._down[np.asarray(parts, dtype=np.int64).reshape(-1)] = True

    def set_up(self, parts) -> None:
        """Bring partitions back. Staleness resets on their next sweep (the
        caller should run ``full_sweep``/``refresh`` to recompute their rows)."""
        self._down[np.asarray(parts, dtype=np.int64).reshape(-1)] = False

    def down_partitions(self) -> np.ndarray:
        return np.nonzero(self._down)[0]

    @property
    def part_staleness(self) -> np.ndarray:
        """(P,) sweeps served from frozen cache per partition (0 = fresh)."""
        return self._part_staleness.copy()

    # ------------------------------------------------------------------
    # sharded embedding store (repro_torch.store)
    # ------------------------------------------------------------------
    def attach_store(self, store) -> None:
        """Serve node lookups through a :class:`repro_torch.store.StoreBackend`.

        The engine stays the single writer: every sweep publishes the rows
        it could have changed into the store's per-partition shards (tables
        ``"logits"`` and ``"emb"``); ``query``/``embeddings(site=-1)`` then
        read through the store's hot-node cache instead of the materialized
        tables, bit for bit the same (``verify_store`` asserts it). Attach
        before the first sweep, or re-publish with ``full_sweep()``."""
        self.store = store
        if self._logits_host is not None:
            self._publish(None)

    def _emb_host(self) -> np.ndarray:
        """The deepest cached layer, (P, n_local, d), copied to the host."""
        return self._layers[-1].cpu().numpy()

    def _publish(self, changed_ids: Optional[np.ndarray]) -> None:
        """Write the rows the last sweep could have changed into the store.

        ``changed_ids=None`` republishes every real row (full sweep). For a
        delta, the superset of rows whose cached values may differ is the
        ``n_sites``-hop frontier of the changed set — one hop per layer plus
        the logits readout (unaffected rows are bit-stable under
        deterministic rounding, the delta == full guarantee). Both tables
        are copied from the card whole, as in the reference."""
        st = self.store
        p_count = self.pg.plan.n_parts
        tables = {"logits": self._logits_host, "emb": self._emb_host()}
        for name, arr in tables.items():
            if not st.has_table(name):
                st.create_table(name, part_rows=(arr.shape[1],) * p_count,
                                d=arr.shape[2], dtype=arr.dtype)
        if changed_ids is None:
            for p in range(p_count):
                slots = np.nonzero(self.pg.node_mask[p])[0]
                for name, arr in tables.items():
                    st.put_rows(name, p, slots, arr[p, slots])
            return
        fr = khop_frontier(self.pg, changed_ids, self.n_sites,
                           edges=self._frontier.edges)[-1]
        ids = np.nonzero(fr)[0]
        parts, slots = self._part_of[ids], self._slot_of[ids]
        for p in np.unique(parts):
            sl = slots[parts == p]
            for name, arr in tables.items():
                st.put_rows(name, int(p), sl, arr[int(p), sl])

    def _store_lookup(self, table: str, ids: np.ndarray) -> np.ndarray:
        """Batched store read in request order (one ``get_rows`` per
        partition the batch touches)."""
        parts, slots = self._part_of[ids], self._slot_of[ids]
        out: Optional[np.ndarray] = None
        for p in np.unique(parts):
            sel = parts == p
            rows = self.store.get_rows(table, int(p), slots[sel])
            if out is None:
                out = np.empty((ids.size,) + rows.shape[1:], rows.dtype)
            out[sel] = rows
        return out

    def pin_hot(self, node_ids, tables: Optional[tuple] = None) -> None:
        """Pin the hot nodes' rows into the store's pinned tier (they stay
        materialized and are write-through refreshed by every publish)."""
        if self.store is None:
            raise RuntimeError("no store attached")
        self._require_swept()
        ids = self._check_ids(node_ids)
        parts, slots = self._part_of[ids], self._slot_of[ids]
        for p in np.unique(parts):
            for table in tables or self.STORE_TABLES:
                self.store.pin(table, int(p), slots[parts == p])

    def verify_store(self) -> int:
        """Assert the store-backed read path equals the materialized tables
        bit for bit: every shard row equals the engine's row, and every
        cached row equals its shard row. Returns the number of rows
        verified."""
        if self.store is None:
            raise RuntimeError("no store attached")
        self._require_swept()
        st = self.store
        peek = getattr(st, "peek_rows", st.get_rows)
        tables = {"logits": self._logits_host, "emb": self._emb_host()}
        checked = 0
        for p in range(self.pg.plan.n_parts):
            slots = np.nonzero(self.pg.node_mask[p])[0]
            for name, arr in tables.items():
                if not np.array_equal(peek(name, p, slots), arr[p, slots]):
                    raise AssertionError(
                        f"store table {name!r} shard {p} diverged from the "
                        f"materialized path")
                checked += slots.size
        coherent = getattr(st, "check_coherence", None)
        if coherent is not None:
            checked += coherent()
        return checked

    def reader(self) -> "InferenceEngine | StoreReader":
        """A query-only replica view: a :class:`StoreReader` over the
        attached store, or the engine itself when none is attached (the
        materialized tables are then the only copy)."""
        return StoreReader(self) if self.store is not None else self

    def feature_rows(self, node_ids) -> np.ndarray:
        """Current feature rows for a batch of global node ids (what a
        mutation-stream edge touch re-submits — see ``store/stream.py``)."""
        ids = self._check_ids(node_ids)
        return self._x_host[self._part_of[ids], self._slot_of[ids]].copy()

    def _require_swept(self):
        if self._logits_host is None:
            raise RuntimeError("no caches yet — call full_sweep() first")

    def _check_ids(self, node_ids) -> np.ndarray:
        """Normalize + bounds-check global node ids before any state is
        touched."""
        ids = np.asarray(node_ids, dtype=np.int64).reshape(-1)
        n = self._slot_of.shape[0]
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(f"node ids must be in [0, {n})")
        return ids

    def query(self, node_ids) -> QueryResult:
        """Logits for a batch of global node ids — a cache lookup, no graph
        compute. With a store attached the rows come through its hot-node
        cache (miss -> shard fetch); otherwise from the materialized table.
        Both paths give the same bits (``verify_store``)."""
        self._require_swept()
        ids = self._check_ids(node_ids)
        if self.store is not None and ids.size:
            out = self._store_lookup("logits", ids)
        else:
            out = self._logits_host[self._part_of[ids], self._slot_of[ids]]
        return QueryResult(node_ids=ids, logits=out,
                           staleness=self._part_staleness[
                               self._part_of[ids]].copy())

    def embeddings(self, node_ids, site: int = -1) -> np.ndarray:
        """Cached embeddings entering exchange site ``site`` for a batch of
        global node ids (``-1`` = the deepest cached layer). The deepest
        layer is store-served when a store is attached (the ``"emb"``
        table); other sites gather the requested rows on the card, so only
        O(batch * d) crosses to the host, never the layer's table."""
        self._require_swept()
        ids = self._check_ids(node_ids)
        if self.store is not None and ids.size and \
                site in (-1, self.n_sites - 1):
            return self._store_lookup("emb", ids)
        parts = torch.as_tensor(self._part_of[ids], device=self.device)
        slots = torch.as_tensor(self._slot_of[ids], device=self.device)
        return self._layers[site][parts, slots].cpu().numpy()

    @property
    def logits(self) -> np.ndarray:
        """The full cached logits table, reassembled into global node order."""
        self._require_swept()
        return self.pg.unpartition(self._logits_host)

    def full_sweep_wire_bytes(self) -> int:
        """What one full sweep ships (payload + ec), for comparison against a
        delta's :attr:`RefreshReport.wire_bytes`."""
        pb, eb, mb = deltalib.refresh_wire_bytes(
            self.block.plan.real_rows, self.site_dims, self.decision,
            deltalib.plan_full(self.pg, self.n_sites),
            self.config.scale_dtype)
        return pb + eb + mb


class StoreReader:
    """Query-only replica view over an engine's published store tables.

    A serving replica needs exactly three things: the ``(part, slot)`` index,
    the store's read path, and the writer's health/staleness stamps. A
    ``StoreReader`` carries nothing else — it cannot sweep, refresh, or mark
    partitions down, so any number of them can front one store while the
    engine remains the single writer (``ReplicaSet`` in ``server.py`` builds
    one per replica via ``engine.reader()``). It reads host memory only."""

    def __init__(self, engine: InferenceEngine):
        if engine.store is None:
            raise ValueError("engine has no store attached")
        self._engine = engine
        self.store = engine.store
        self.pg = engine.pg

    def query(self, node_ids) -> QueryResult:
        """Store-backed logits lookup — same contract as ``engine.query``."""
        eng = self._engine
        eng._require_swept()
        ids = eng._check_ids(node_ids)
        out = eng._store_lookup("logits", ids) if ids.size else \
            np.empty((0, eng._logits_host.shape[-1]), np.float32)
        return QueryResult(node_ids=ids, logits=out,
                           staleness=eng._part_staleness[
                               eng._part_of[ids]].copy())

    def embeddings(self, node_ids, site: int = -1) -> np.ndarray:
        return self._engine.embeddings(node_ids, site=site)

    def down_partitions(self) -> np.ndarray:
        """Health rides the writer's state machine (servers fronting a
        reader recompute DEGRADED/HEALTHY from the same source)."""
        return self._engine.down_partitions()

    @property
    def part_staleness(self) -> np.ndarray:
        return self._engine.part_staleness
