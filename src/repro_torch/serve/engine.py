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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core import quantization as qlib
from ..core.exchange import (exchange_halo, exchange_quantized_halo,
                             gather_boundary)
from ..core.staleness import HaloState
from ..core.sylvie import SylvieComm, SylvieConfig
from ..dist.runtime import Runtime
from ..graph.partition import PartitionedGraph, global_to_slot
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
    (bit-identical here: the simulated backend's fence is the identity)."""

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
        buf = gather_boundary(h, self.plan)
        qt = qlib.quantize(buf, sd.fwd_bits, self.generator, sd.stochastic,
                           cfg.scale_dtype)
        inflight = exchange_quantized_halo(qt, self.plan, self.backend)
        aff = exchange_halo(self.send_affected[i][..., None], self.plan,
                            self.backend)
        if self.schedule == "overlap":
            inflight, aff = self.backend.fence((inflight, aff))
        fresh = qlib.dequantize(inflight)
        fresh = torch.where(self.plan.recv_mask[..., None], fresh, 0.0)
        halo = torch.where(aff > 0, fresh, self.cached_halos[i])
        self.new_feat_caches.append(halo)
        return halo


@dataclasses.dataclass
class QueryResult:
    """One answered query batch."""

    node_ids: np.ndarray
    logits: np.ndarray

    @property
    def predictions(self) -> np.ndarray:
        return np.argmax(self.logits, axis=-1)


class InferenceEngine:
    """Quantized full-graph inference over a partitioned graph.

    Example::

        pg = datasets.load_partitioned("reddit_like@paper", n_parts=4)
        model = GCN(602, 256, 41, generator=torch.Generator().manual_seed(0))
        eng = InferenceEngine(model, pg, config=ServeConfig(bits=1),
                              runtime=Runtime.simulated(4))
        eng.full_sweep()                        # materialize all caches
        out = eng.query([3, 17, 4242])          # lookup
        rep = eng.refresh(changed_ids, new_rows)   # k-hop delta refresh

    ``params`` (nested dicts of arrays, the JAX parameter-tree layout) are
    copied into ``model`` when given; otherwise the model's own parameters
    serve."""

    def __init__(self, model, pg: PartitionedGraph, params=None,
                 config: Optional[ServeConfig] = None,
                 decision: Optional[EpochDecision] = None,
                 runtime: Optional[Runtime] = None, seed: int = 0):
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

    def _run(self, refresh: deltalib.RefreshPlan, *, kind: str,
             forced: bool) -> deltalib.RefreshReport:
        t0 = time.perf_counter()
        logits, layers, halos = self._sweep(
            self.block, self.x, self._halos, refresh.device_masks(self.device),
            self._generator())
        self._layers = layers
        self._halos = halos
        self._logits_host = logits.cpu().numpy()
        pb, eb, mb = deltalib.refresh_wire_bytes(
            self.block.plan.real_rows, self.site_dims, self.decision, refresh,
            self.config.scale_dtype)
        return deltalib.RefreshReport(
            kind=kind, forced=forced, changed=refresh.changed,
            affected_rows=refresh.affected_rows, payload_bytes=pb,
            ec_bytes=eb, meta_bytes=mb, seconds=time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    @staticmethod
    def from_checkpoint(ckpt_dir, model, pg: PartitionedGraph,
                        config: Optional[ServeConfig] = None,
                        decision: Optional[EpochDecision] = None,
                        runtime: Optional[Runtime] = None,
                        step: Optional[int] = None, seed: int = 0
                        ) -> tuple["InferenceEngine", dict]:
        """Restore only the model parameters (``restore_for_inference``) and
        build an engine. Returns ``(engine, checkpoint_meta)``."""
        params, meta = ckpt.restore_for_inference(
            ckpt_dir, params_to_numpy(model), step=step)
        return InferenceEngine(model, pg, params, config=config,
                               decision=decision, runtime=runtime,
                               seed=seed), meta

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
        if full or never_swept or self._since_full >= self.config.max_staleness:
            rep = self._run(deltalib.plan_full(self.pg, self.n_sites),
                            kind="full", forced=not full)
            self._since_full = 0
            return dataclasses.replace(rep, changed=int(ids.size))
        plan = self._frontier.plan_refresh(ids, self.n_sites)
        rep = self._run(plan, kind="delta", forced=False)
        self._since_full += 1
        return rep

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
        compute."""
        self._require_swept()
        ids = self._check_ids(node_ids)
        out = self._logits_host[self._part_of[ids], self._slot_of[ids]]
        return QueryResult(node_ids=ids, logits=out)

    def embeddings(self, node_ids, site: int = -1) -> np.ndarray:
        """Cached embeddings entering exchange site ``site`` for a batch of
        global node ids (``-1`` = the deepest cached layer). Only the
        requested rows cross to the host."""
        self._require_swept()
        ids = self._check_ids(node_ids)
        parts = torch.as_tensor(self._part_of[ids], device=self.device)
        slots = torch.as_tensor(self._slot_of[ids], device=self.device)
        return self._layers[site][parts, slots].cpu().numpy()

    @property
    def logits(self) -> np.ndarray:
        """The full cached logits table, reassembled into global node order."""
        self._require_swept()
        return self.pg.unpartition(self._logits_host)
