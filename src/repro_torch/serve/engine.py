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
Inside it each exchange site is a ``halo`` span (kind ``quantized``) on
either schedule, and each aggregation an ``agg`` span.

**Under a sharded runtime** (``Runtime.sharded(P)``, one partition per
process, the counterpart of the reference's ``shard_serve_fn`` under
``shard_map``) every rank holds its partition's slice ``[r:r+1]``: the
block, the features, the halo and layer caches; the host state (the
features' host copy, the gathered logits, the staleness clock, the
degraded-mode flags) is the same on every rank. The design is
leader/follower:

* **rank 0 is the front**: it alone serves queries (lookups on its host
  copy of the logits, no collective), owns the store (the single writer)
  and hosts the server, the replicas and the load generators;
* **lockstep**: every operation that sweeps or reads another rank's state
  (``full_sweep``, ``refresh``, ``set_down`` / ``set_up``, ``embeddings``
  at a site the store does not serve, and a late ``attach_store``'s
  publish) is sent by rank 0 as a small command (op, ids, rows, flags;
  ``dist.api.broadcast_command``) before rank 0 runs it. Every rank calls
  :meth:`lead`: rank 0 runs the front, every other rank :meth:`follow`s,
  receiving the commands and running the same ops, until rank 0's front
  ends and it sends the stop;
* the sweep's logits (and, with a store, the deepest cached layer) are
  gathered to the whole stack on every rank (``Runtime.gather_stacked``,
  the ``gather`` span), so ``query``, ``logits``, frozen-row patching and
  the store's publish read the whole table as on the stack;
* noise: rank ``r`` draws its stochastic-rounding ``u`` from ``(seed,
  sweep, r)``, the partition folded in as the reference's ``_part_key``
  folds it into the key; deterministic rounding makes the sharded engine
  equal the simulated one bit for bit.

Inputs are checked on rank 0 before the command goes out, so a bad update
fails there alone (the server counts it). A failure after the command was
sent raises :class:`LockstepError`, which the server does not swallow: the
followers may be waiting in a collective, and the run must end.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import obs
from ..core import quantization as qlib
from ..core.exchange import (exchange_halo, exchange_quantized_halo,
                             gather_boundary, halo_span)
from ..core.staleness import HaloState
from ..core.sylvie import SylvieComm, SylvieConfig
from ..dist import api as dist_api
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
        i = self._site
        self._site += 1
        with halo_span(i, "fwd", "quantized", h.device):
            return self._halo(h, i)

    def _halo(self, h: torch.Tensor, i: int) -> torch.Tensor:
        """Site ``i``'s forward, on either schedule."""
        cfg = self.cfg
        sd = self._site_decision(i)
        self.layer_inputs.append(h)
        aff_send = self.send_affected[i][..., None]
        if self.schedule == "overlap":
            # gather, quantize and exchange on the side stream; the mask's
            # exchange runs meanwhile; the fence lands the payload
            inflight = olap._issue(h, lambda t: gather_boundary(t, self.plan),
                                   sd.fwd_bits, sd.stochastic,
                                   cfg.scale_dtype, self.backend, self.plan,
                                   self.generator, site=i)
            aff = exchange_halo(aff_send, self.plan, self.backend)
            fresh = olap._land(inflight, self.backend, i)
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


class LockstepError(RuntimeError):
    """A lockstep operation of a sharded engine failed after rank 0 sent its
    command: the other ranks may wait in a collective that will not
    complete, so the run cannot go on (``EmbeddingServer.refresh`` re-raises
    it instead of counting a failed refresh)."""


# the operations rank 0 sends to the followers (``InferenceEngine._op_*``)
LOCKSTEP_OPS = ("full", "refresh", "down", "embeddings", "publish")


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

    Under ``Runtime.sharded(4)`` every rank builds the engine and calls
    ``eng.lead(front)``: ``front(eng)`` makes the calls above on rank 0
    while the other ranks follow (see the module docstring).

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
        self.rank = rank = runtime.rank
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
        self.block = B.build_block(pg, dev, part=rank)
        self.seed = seed

        # global id -> (partition, local slot): the lookup request path
        self._part_of, self._slot_of = global_to_slot(pg)

        self._sweep = self._build_sweep()
        # refresh planning amortizes the O(E) edge/ownership reconstruction
        self._frontier = deltalib.FrontierIndex.build(pg)
        # the host copy of the features is whole on every rank (the
        # mutation stream reads it); the device's holds this runtime's
        # partitions
        self._x_host = np.asarray(pg.x, dtype=np.float32).copy()
        self.x = dist_api.serve_data(pg, rank, dev)
        self._halos = HaloState.zeros(self.block.plan, self.site_dims,
                                      stacked_parts=runtime.stacked_parts(p),
                                      device=dev).feats
        self._layers: Optional[tuple] = None
        self._logits_host: Optional[np.ndarray] = None
        # the whole stack's deepest cached layer on the host, kept while a
        # store is attached (what the store publishes and is verified
        # against)
        self._emb_table: Optional[np.ndarray] = None
        self._since_full = 0
        self._refresh_count = 0
        # degraded mode: partitions marked down contribute no fresh halo
        # rows (their send-affected masks are zeroed on the card — data, the
        # sweep's launches are unchanged) and their cached logits are
        # frozen; per-partition staleness counts sweeps served from the
        # frozen cache.
        self._down = np.zeros(p, dtype=bool)
        self._part_staleness = np.zeros(p, dtype=np.int64)
        # lockstep (sharded runtime): the followers listen from the start of
        # lead() until _stop(); broken after a failure past a sent command
        self._following = False
        self._broken = False
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
        function of (seed, sweep count), and of the rank under a sharded
        runtime (each rank draws its own partition's noise)."""
        key = [self.seed, self._refresh_count]
        if self.rank is not None:
            key.append(self.rank)
        state = np.random.SeedSequence(key)
        self._refresh_count += 1
        g = torch.Generator(device=self.device)
        g.manual_seed(int(state.generate_state(1)[0]))
        return g

    def _local(self, parts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``(held, row)``: which of the partitions ``parts`` this process
        holds, and their row in its stack."""
        row = parts - (self.rank or 0)
        return (row >= 0) & (row < self.x.shape[0]), row

    def _run(self, refresh: deltalib.RefreshPlan, *, kind: str, forced: bool,
             emb: bool, changed_ids: Optional[np.ndarray] = None
             ) -> deltalib.RefreshReport:
        t0 = obs.clock()
        generator = self._generator()
        masks = refresh.device_masks(self.device, part=self.rank)
        if self._down.any():
            # down partitions publish nothing fresh: zero their send-affected
            # rows so every receiver keeps its cached rows from them (a down
            # rank still joins every exchange)
            up = torch.as_tensor(dist_api.local_slice(~self._down, self.rank),
                                 dtype=torch.uint8, device=self.device)
            masks = tuple(m * up[:, None] for m in masks)
        with obs.span("sweep", {"kind": kind}):
            logits, layers, halos = self._sweep(self.block, self.x,
                                                self._halos, masks, generator)
        self._layers = layers
        self._halos = halos
        # the whole stack's logits and, for the store, deepest layer
        stacked = self.runtime.gather_stacked(
            logits, *((layers[-1],) if emb else ()))
        fresh_logits = stacked[0].cpu().numpy()
        if emb:
            self._emb_table = stacked[1].cpu().numpy()
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
    # lockstep: rank 0 leads, the other ranks follow
    # ------------------------------------------------------------------
    def _lead(self, op: str, **args):
        """Run the lockstep operation ``_op_<op>(**args)``. Under a sharded
        runtime rank 0 first sends ``(op, args)`` to the followers, which
        run the same operation (:meth:`follow`)."""
        if self.rank is None:
            return getattr(self, f"_op_{op}")(**args)
        if self.rank != 0:
            raise RuntimeError(
                f"rank {self.rank} follows rank 0: a sharded engine sweeps, "
                "refreshes and changes its degraded mode from rank 0 (every "
                "rank calls lead())")
        if not self._following or self._broken:
            raise RuntimeError(
                "no follower is listening: run the front inside lead(), "
                "which every rank calls"
                + (" (a lockstep operation failed)" if self._broken else ""))
        dist_api.broadcast_command((op, args), self.runtime.backend.group)
        return self._locked(op, args)

    def _locked(self, op: str, args: dict):
        """Run a lockstep operation whose command went out: a failure now
        leaves the ranks out of step, so it raises :class:`LockstepError`."""
        try:
            return getattr(self, f"_op_{op}")(**args)
        except Exception as err:
            self._broken = True
            raise LockstepError(
                f"lockstep operation {op!r} failed on rank {self.rank} after "
                "its command was sent; the ranks cannot go on") from err

    def follow(self) -> None:
        """On a rank other than 0 of a sharded runtime: receive rank 0's
        commands and run each operation, until rank 0 sends the stop (at
        the end of its :meth:`lead`)."""
        if self.rank in (None, 0):
            raise RuntimeError("follow() runs on the ranks other than 0 of "
                               "a sharded runtime; rank 0 leads")
        group = self.runtime.backend.group
        while True:
            op, args = dist_api.broadcast_command(None, group)
            if op == "stop":
                return
            if op not in LOCKSTEP_OPS:
                raise ValueError(f"unknown lockstep operation {op!r}")
            self._locked(op, args)

    def _stop(self) -> None:
        """On rank 0 of a sharded runtime: release the followers (their
        :meth:`follow` returns). Queries still answer; the next sweep waits
        for the next :meth:`lead`. Nothing to do on the stack."""
        if self.rank is None or not self._following:
            return
        self._following = False
        dist_api.broadcast_command(("stop", {}), self.runtime.backend.group)

    def lead(self, front: Callable, *args):
        """Run the serving front ``front(self, *args)``; under a sharded
        runtime a collective, which every rank calls. On rank 0, or on the
        stack, ``front`` runs and its result is returned; every other rank
        follows rank 0's operations meanwhile and returns ``None``. When
        ``front`` returns or raises, rank 0 stops the followers, unless a
        lockstep operation failed (they may then wait inside a collective:
        the error ends the run)."""
        if self.rank not in (None, 0):
            self.follow()
            return None
        self._following = True
        try:
            return front(self, *args)
        finally:
            if not self._broken:
                self._stop()

    # the lockstep operations: every rank runs them (rank 0 sends first)
    def _op_full(self, emb: bool) -> deltalib.RefreshReport:
        rep = self._run(deltalib.plan_full(self.pg, self.n_sites),
                        kind="full", forced=False, emb=emb)
        self._since_full = 0
        return rep

    def _op_refresh(self, ids: np.ndarray, rows: np.ndarray, full: bool,
                    emb: bool) -> deltalib.RefreshReport:
        parts, slots = self._part_of[ids], self._slot_of[ids]
        # O(changed) update of the host copy (whole) and of the device
        # features (the rows this process holds)
        self._x_host[parts, slots] = rows
        held, row = self._local(parts)
        self.x[torch.as_tensor(row[held], device=self.device),
               torch.as_tensor(slots[held], device=self.device)] = \
            torch.as_tensor(rows[held], device=self.device)
        never_swept = self._logits_host is None
        with obs.span("refresh", {"changed": int(ids.size)}):
            if full or never_swept or \
                    self._since_full >= self.config.max_staleness:
                rep = self._run(deltalib.plan_full(self.pg, self.n_sites),
                                kind="full", forced=not full, emb=emb)
                rep = dataclasses.replace(rep, changed=int(ids.size))
                self._since_full = 0
                return rep
            with obs.span("plan"):
                plan = self._frontier.plan_refresh(ids, self.n_sites)
            rep = self._run(plan, kind="delta", forced=False, emb=emb,
                            changed_ids=ids)
            self._since_full += 1
            return rep

    def _op_down(self, parts: np.ndarray, down: bool) -> None:
        self._down[parts] = down

    def _op_embeddings(self, ids: np.ndarray, site: int) -> np.ndarray:
        # each process picks the rows it holds (zeros elsewhere); the gather
        # stacks the picks in rank order and each id takes its owner's row
        # (on the stack, the one process picked every row)
        layer = self._layers[site]
        parts, slots = self._part_of[ids], self._slot_of[ids]
        held, row = self._local(parts)
        dev = self.device
        pick = layer.new_zeros((ids.size, layer.shape[-1]))
        pick[torch.as_tensor(np.nonzero(held)[0], device=dev)] = layer[
            torch.as_tensor(row[held], device=dev),
            torch.as_tensor(slots[held], device=dev)]
        (every,) = self.runtime.gather_stacked(pick[None])
        owner = parts if every.shape[0] > 1 else np.zeros_like(parts)
        return every[torch.as_tensor(owner, device=dev),
                     torch.arange(ids.size, device=dev)].cpu().numpy()

    def _op_publish(self) -> None:
        (emb,) = self.runtime.gather_stacked(self._layers[-1])
        self._emb_table = emb.cpu().numpy()
        if self.store is not None:
            self._publish(None)

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
        return self._lead("full", emb=self.store is not None)

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
        return self._lead("refresh", ids=ids, rows=rows, full=bool(full),
                          emb=self.store is not None)

    # ------------------------------------------------------------------
    # degraded mode (partition down/up)
    # ------------------------------------------------------------------
    def set_down(self, parts) -> None:
        """Mark partitions down. Their cached rows keep serving (stamped with
        growing staleness); sweeps stop consuming their halo contributions."""
        self._lead("down", parts=self._check_parts(parts), down=True)

    def set_up(self, parts) -> None:
        """Bring partitions back. Staleness resets on their next sweep (the
        caller should run ``full_sweep``/``refresh`` to recompute their rows)."""
        self._lead("down", parts=self._check_parts(parts), down=False)

    def _check_parts(self, parts) -> np.ndarray:
        parts = np.asarray(parts, dtype=np.int64).reshape(-1)
        p = self._down.size
        if parts.size and (parts.min() < 0 or parts.max() >= p):
            raise ValueError(f"partitions must be in [0, {p})")
        return parts

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

        The engine stays the single writer (rank 0 under a sharded
        runtime): every sweep publishes the rows
        it could have changed into the store's per-partition shards (tables
        ``"logits"`` and ``"emb"``); ``query``/``embeddings(site=-1)`` then
        read through the store's hot-node cache instead of the materialized
        tables, bit for bit the same (``verify_store`` asserts it). Attach
        before the first sweep, or re-publish with ``full_sweep()``."""
        if self.rank not in (None, 0):
            raise RuntimeError("the store has one writer: rank 0")
        self.store = store
        if self._logits_host is not None:
            self._lead("publish")

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
        tables = {"logits": self._logits_host, "emb": self._emb_table}
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
        tables = {"logits": self._logits_host, "emb": self._emb_table}
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
        O(batch * d) crosses to the host, never the layer's table (under a
        sharded runtime a lockstep operation: each rank picks the rows it
        holds, and a gather brings them to rank 0)."""
        self._require_swept()
        ids = self._check_ids(node_ids)
        if self.store is not None and ids.size and \
                site in (-1, self.n_sites - 1):
            return self._store_lookup("emb", ids)
        if not -self.n_sites <= site < self.n_sites:
            raise IndexError(f"site must be in [-{self.n_sites}, "
                             f"{self.n_sites})")
        return self._lead("embeddings", ids=ids, site=int(site))

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
