"""GNN trainer: the epoch loop, the CommPolicy loop, eval, checkpoint/restart,
EF21 gradient compression, metrics — as ``repro.train.trainer.GNNTrainer``.

The runtime fixes the device and the placement: ``Runtime.simulated(P)`` is
the whole partition stack on the CUDA card (``device="cpu"`` runs the
kernels' plain versions on the CPU); under ``Runtime.sharded(P)`` each of P
processes runs this trainer on its own partition (the block, the CSRs and
the plan built from its partition, x / y / masks and halo caches its slice
``[r:r+1]``, parameters and optimizer state whole and kept equal by the
all-reduced gradients). What the host does below reads only replicated
values and the host plan, so it is the same in every process, and the
bytes per epoch are the whole graph's, as on the stack. Once per epoch, on
the host:

1. telemetry is assembled (epoch, the EMA-smoothed per-site range stats the
   previous step emitted, the validation trajectory, the resume/elastic
   ``needs_sync`` flag);
2. ``policy.decide(telemetry)`` returns an
   :class:`~repro_torch.policy.base.EpochDecision`, snapped to the lattice,
   with the mode invariants enforced by :meth:`GNNTrainer._decide`;
3. the steps built for that decision (cached on ``decision.step_key()``) run
   the synchronous or the pipelined step.

``SylvieConfig(bits=...)`` without a policy is the ``Uniform`` policy; the
paper's Bounded Staleness Adaptor (§3.3) is ``policy=BoundedStaleness(eps_s)``
(the deprecated ``eps_s=`` keyword builds it and warns).
Each epoch is traced as ``epoch > decide > step > wait`` spans
(``repro_torch.obs``; free when tracing is off; ``wait`` is the loss's
sync, so a step less its ``wait`` is the host's dispatch, and after it the
idle card anchors the device clock) and timed on ``obs.clock``; inside ``step`` the exchange sites and aggregations trace
``halo`` and ``agg``. The constructor times itself into the gauge
``setup.trainer_s``.

**Chaos.** ``fault_plan=`` (or a runtime whose backend is a
:class:`~repro_torch.faults.FaultyBackend`) arms every epoch: the plan's
seeded events are drawn on the host, expanded to wire masks and moved to the
runtime's device in one copy (``state.faults``); the staleness-as-recovery
bookkeeping (per-site consecutive-fault counters, the escalation latch that
forces one clean full-precision synchronous epoch) is
:meth:`GNNTrainer._arm_faults`. :meth:`GNNTrainer.modeled_comm_split` is the
DESIGN §8/§14 exposed/overlapped comm-time model under the trainer's
schedule.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..core.exchange import exchange_bytes, wire_bytes
from ..core.sylvie import SylvieConfig
from ..dist import api as dist_api
from ..dist import overlap as olap
from ..dist.runtime import Runtime
from ..faults.backend import FaultyBackend
from ..faults.plan import FaultCtl, FaultPlan, RowGeometry
from ..models.convert import params_from_numpy
from ..models.gnn import blocks as B
from ..policy.base import (CommPolicy, EpochDecision, SiteStats, Telemetry,
                           validate_decision)
from ..policy.builtin import BoundedStaleness, Uniform
from . import checkpoint as ckpt
from . import optimizer as optlib
from .compression import ef_wire_bytes
from .gnn_step import GNNTrainState, make_gnn_steps

# EMA smoothing factor for the per-site range stats fed back to policies.
STATS_EMA = 0.5


@dataclasses.dataclass
class EpochMetrics:
    epoch: int
    loss: float
    seconds: float              # the step, on the host clock, ending in a sync
    mode: str
    comm_payload_mb: float
    comm_ec_mb: float
    val_acc: Optional[float] = None
    schedule: str = "blocking"
    bits_per_site: tuple = ()
    policy: str = ""
    ef_bits: Optional[int] = None
    # chaos accounting (unit = one scheduled drop/corrupt message). Invariant:
    # faults_injected == halos_reused + forced_syncs, exactly — a faulty
    # epoch recovers every unit from the stale cache, a recovery epoch
    # suppresses its whole schedule and retries synchronously. ``stall_s`` is
    # the modeled straggler critical-path extension (not wall clock).
    faults_injected: int = 0
    halos_reused: int = 0
    forced_syncs: int = 0
    stall_s: float = 0.0
    # the whole epoch on the obs clock (decide + step + telemetry and byte
    # accounting), against ``seconds`` = the step call alone
    wall_s: float = 0.0


class GNNTrainer:
    """Full-graph trainer over a partitioned graph.

    Example::

        pg, _ = datasets.load_partitioned("yelp_like@small", n_parts=4)
        tr = GNNTrainer(GCN(pg.x.shape[-1], 64, pg.n_classes), pg,
                        SylvieConfig(mode="async", bits=1),
                        policy=BoundedStaleness(eps_s=4))
        tr.fit(40); tr.evaluate("test")

    ``params`` (nested dicts of arrays, the JAX parameter-tree layout) are
    copied into ``model`` first when given; training starts from the model's
    parameters. ``device`` picks the runtime's device when no ``runtime`` is
    given (``None``: the CUDA card). ``bns_masks``, a function of the epoch,
    gives that epoch's per-site BNS keep-masks in place of the step's own
    draws (the tests hand in the JAX reference's). ``fault_plan`` arms the
    seeded chaos schedule (see the module docstring).

    .. deprecated:: ``eps_s=k`` — the pre-policy staleness knob. It builds
       ``policy=BoundedStaleness(eps_s=k, bits=cfg.effective_bits,
       stochastic=cfg.stochastic, boundary_sample_p=cfg.boundary_sample_p)``
       and warns; pass that policy instead."""

    @obs.timed("setup.trainer_s")
    def __init__(self, model, pg, cfg: Optional[SylvieConfig] = None,
                 opt: Optional[optlib.Optimizer] = None,
                 policy: Optional[CommPolicy] = None,
                 eps_s: Optional[int] = None,
                 runtime: Optional[Runtime] = None, device=None,
                 seed: int = 0, ckpt_dir: Optional[str] = None,
                 keep: int = 3, ckpt_every: Optional[int] = None,
                 params=None, bns_masks=None,
                 fault_plan: Optional[FaultPlan] = None):
        self.model = model
        self.pg = pg
        self.cfg = cfg = cfg if cfg is not None else SylvieConfig()
        if eps_s is not None:
            warnings.warn(
                "GNNTrainer(eps_s=...) is deprecated; pass "
                "policy=repro_torch.policy.BoundedStaleness(eps_s) instead",
                DeprecationWarning, stacklevel=3)   # past obs.timed's frame
            if policy is not None:
                raise ValueError("pass policy or eps_s, not both")
            policy = BoundedStaleness(
                eps_s=eps_s, bits=cfg.effective_bits,
                stochastic=cfg.stochastic,
                boundary_sample_p=cfg.boundary_sample_p)
        self.policy: CommPolicy = policy if policy is not None \
            else Uniform.from_config(cfg)
        p = pg.plan.n_parts
        if runtime is None:
            runtime = Runtime.simulated(p, device=device)
        elif device is not None and torch.device(device) != runtime.device:
            raise ValueError(f"device {device} differs from the runtime's "
                             f"{runtime.device}")
        if runtime.n_parts not in (None, p):
            raise ValueError(
                f"runtime is committed to {runtime.n_parts} partitions but the "
                f"graph was partitioned into {p}")
        # a chaos run is fault_plan=..., or a runtime whose backend is already
        # a FaultyBackend (the plan is then found on it)
        if isinstance(runtime.backend, FaultyBackend):
            if fault_plan is not None and fault_plan != runtime.backend.plan:
                raise ValueError("runtime backend already carries a FaultPlan "
                                 "that differs from fault_plan")
            fault_plan = runtime.backend.plan
        elif fault_plan is not None:
            runtime = Runtime(FaultyBackend(runtime.backend, fault_plan),
                              runtime.device)
        self.fault_plan = fault_plan
        self.runtime = runtime
        self.device = dev = runtime.device
        self.ckpt_every = ckpt_every
        self.opt = opt or optlib.adam(1e-2)
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.seed = seed
        self.bns_masks = bns_masks

        if params is not None:
            params_from_numpy(model, params)
        self.rank = rank = runtime.rank
        self.block = B.build_block(pg, dev, part=rank)
        (self.x, self.y, self.train_mask, self.val_mask,
         self.test_mask) = dist_api.gnn_data(pg, rank, dev)
        self.site_dims = tuple(int(d) for d in model.comm_dims())
        self.n_sites = len(self.site_dims)
        self.state = GNNTrainState.create(model.param_tree(), self.opt,
                                          self.block.plan, self.site_dims,
                                          stacked_parts=runtime.stacked_parts(
                                              p), device=dev)
        # built train steps per distinct (snapped) decision; eval is
        # decision-independent (always full precision) and built once.
        self._step_cache: dict = {}
        _, _, self._ev = make_gnn_steps(self.model, cfg, self.opt,
                                        backend=runtime.backend)
        self.epoch = 0
        self.history: list[EpochMetrics] = []
        self._needs_sync = False
        self._site_stats: Optional[tuple[SiteStats, ...]] = None
        self._last_decision: Optional[EpochDecision] = None
        # chaos state: per-site consecutive-faulty-epoch counters (the
        # escalation rule watches their max) and the force-recovery latch set
        # when a site crosses ``fault_plan.escalate_after``
        self._fault_geom = (RowGeometry.from_plan(self.block.plan)
                            if fault_plan is not None else None)
        self._site_staleness = np.zeros(self.n_sites, np.int64)
        self._force_recovery = False

    # ------------------------------------------------------------------
    # the policy loop
    # ------------------------------------------------------------------
    def _telemetry(self) -> Telemetry:
        return Telemetry(
            epoch=self.epoch, n_parts=self.pg.plan.n_parts,
            n_sites=self.n_sites, site_dims=self.site_dims,
            site_stats=self._site_stats,
            val_history=tuple(m.val_acc for m in self.history
                              if m.val_acc is not None),
            needs_sync=self._needs_sync, prev=self._last_decision,
            site_staleness=(tuple(int(x) for x in self._site_staleness)
                            if self.fault_plan is not None else ()))

    def _decide(self) -> EpochDecision:
        """Telemetry -> snapped EpochDecision, with the mode invariants
        enforced here: vanilla pins 32 bits, only async mode may skip the
        synchronous step, epoch 0 always runs it (the zero caches must be
        warmed), and a pending cache refresh (``needs_sync``) always wins."""
        d = self.policy.decide(self._telemetry()).snapped()
        d = validate_decision(d, self.n_sites)
        if self.cfg.mode == "vanilla":
            d = d.with_bits(32)
        sync = (bool(d.sync) or self.cfg.mode != "async" or self._needs_sync
                or self.epoch == 0)
        return dataclasses.replace(d, sync=sync, schedule=self.cfg.schedule)

    def _steps_for(self, decision: EpochDecision):
        """(train_sync, train_async) built for this decision, cached on
        ``decision.step_key()`` (``sync`` excluded: it picks which runs)."""
        key = decision.step_key()
        if key not in self._step_cache:
            ts, ta, _ = make_gnn_steps(self.model, self.cfg, self.opt,
                                       backend=self.runtime.backend,
                                       decision=decision)
            self._step_cache[key] = (ts, ta)
        return self._step_cache[key]

    def _absorb_site_stats(self):
        """Fold the step's (n_sites, 2) [sum range^2, live rows] into the
        EMA-smoothed SiteStats telemetry."""
        raw = self.state.site_stats.cpu().numpy()
        rows = self.block.plan.real_rows
        cur = []
        for i, d in enumerate(self.site_dims):
            mean_sq = float(raw[i, 0]) / max(float(raw[i, 1]), 1.0)
            if self._site_stats is not None:
                prev = self._site_stats[i].mean_range_sq
                mean_sq = STATS_EMA * prev + (1.0 - STATS_EMA) * mean_sq
            cur.append(SiteStats(dim=d, rows=rows, mean_range_sq=mean_sq))
        self._site_stats = tuple(cur)

    # ------------------------------------------------------------------
    # heterogeneous-bits comm accounting
    # ------------------------------------------------------------------
    def _bytes_per_epoch(self, bytes_fn,
                         decision: Optional[EpochDecision] = None):
        if decision is None:
            decision = self._last_decision or self._decide()
        payload = ec = 0
        for d, sd in zip(self.site_dims, decision.sites):
            for bits in (sd.fwd_bits, sd.bwd_bits):
                pb, eb = bytes_fn(self.block.plan, d, bits,
                                  self.cfg.scale_dtype)
                payload += pb
                ec += eb
        if decision.ef_bits is not None:
            pb, eb = ef_wire_bytes(self.state.params, decision.ef_bits)
            payload += pb
            ec += eb
        return payload, ec

    def comm_bytes_per_epoch(self, decision: Optional[EpochDecision] = None
                             ) -> tuple[float, float]:
        """(payload, error-compensation) *true wire* bytes moved per epoch,
        totaled across partitions, both directions of every site (Table 3).
        Defaults to the last epoch's decision."""
        return self._bytes_per_epoch(exchange_bytes, decision)

    def wire_bytes_per_epoch(self, decision: Optional[EpochDecision] = None
                             ) -> tuple[float, float]:
        """Like :meth:`comm_bytes_per_epoch`, counting the rows the plan's
        layout ships (alignment tails or pairwise padding included)."""
        return self._bytes_per_epoch(wire_bytes, decision)

    def modeled_comm_split(self, flops_per_part: float, peak_flops: float,
                           link_bw: float,
                           decision: Optional[EpochDecision] = None
                           ) -> tuple[float, float]:
        """DESIGN §8/§14: modeled ``(exposed_s, overlapped_s)`` comm split
        per epoch under this trainer's schedule. ``flops_per_part`` is the
        model's analytic per-partition FLOPs (``launch.cells
        ._gnn_model_flops`` / n_parts); each site's overlappable compute
        window is its uniform share of it. Blocking exposes everything; the
        two always sum to the ``modeled_comm_s`` total."""
        if decision is None:
            decision = self._last_decision or self._decide()
        comm = olap.site_comm_seconds(self.block.plan, self.site_dims,
                                      decision, link_bw, self.cfg.scale_dtype)
        per_site = flops_per_part / peak_flops / max(self.n_sites, 1)
        return olap.split_comm_time(comm, (per_site,) * self.n_sites,
                                    decision.schedule)

    def _epoch_key(self) -> tuple:
        return (self.seed, self.epoch)

    # ------------------------------------------------------------------
    # chaos: arm the epoch's seeded fault schedule
    # ------------------------------------------------------------------
    def _arm_faults(self, decision: EpochDecision):
        """Draw this epoch's seeded fault set, expand it to wire masks on the
        runtime's device in ``state.faults``, and do the staleness-as-
        recovery bookkeeping.

        Returns ``(decision, injected, reused, forced, stall_s, escalate)``.
        A recovery epoch (the latch set by a previous escalation) suppresses
        the whole schedule — all-false masks, same structure — and retries
        as a full-precision synchronous exchange; its scheduled units are
        accounted as ``forced_syncs``. Otherwise every scheduled unit is
        recovered from the stale cache (``halos_reused``), keeping
        ``faults_injected == halos_reused + forced_syncs`` exact."""
        plan = self.fault_plan
        ev = plan.events(self.epoch, self.n_sites, self.pg.plan.n_parts)
        injected = ev.n_injected
        escalate = False
        if self._force_recovery:
            decision = dataclasses.replace(decision.with_bits(32), sync=True)
            ctl = FaultCtl.clean(self._fault_geom, self.n_sites, self.device,
                                 part=self.rank)
            reused, forced, stall = 0, injected, 0.0
            self._site_staleness[:] = 0
            self._force_recovery = False
        else:
            ctl = FaultCtl.expand(ev, self._fault_geom, self.n_sites,
                                  self.device, part=self.rank)
            reused, forced = injected, 0
            stall = ev.stall_s(plan.delay_s)
            self._site_staleness = np.where(ev.faulty_sites(),
                                            self._site_staleness + 1, 0)
            if int(self._site_staleness.max(initial=0)) >= plan.escalate_after:
                escalate = True  # applied to the *next* epoch
        self.state = dataclasses.replace(self.state, faults=ctl)
        return decision, injected, reused, forced, stall, escalate

    def train_epoch(self) -> EpochMetrics:
        w0 = obs.clock()
        with obs.span("epoch", {"epoch": self.epoch}):
            with obs.span("decide"):
                decision = self._decide()
            injected = reused = forced = 0
            stall = 0.0
            escalate = False
            if self.fault_plan is not None:
                (decision, injected, reused, forced, stall,
                 escalate) = self._arm_faults(decision)
                obs.count("faults.injected", injected)
                obs.count("faults.halos_reused", reused)
                obs.count("faults.forced_syncs", forced)
            ts, ta = self._steps_for(decision)
            fn = ts if decision.sync else ta
            t0 = obs.clock()
            with obs.span("step",
                          {"mode": "sync" if decision.sync else "async"}):
                masks = self.bns_masks(self.epoch) if self.bns_masks \
                    else None
                self.state, loss = fn(self.state, self.block, self.x, self.y,
                                      self.train_mask, self._epoch_key(),
                                      masks)
                with obs.span("wait"):
                    loss = float(loss)       # a device sync
                obs.anchor(self.device)      # the card is idle here
            dt = obs.clock() - t0
            self._needs_sync = False
            if escalate:
                # some site has been faulted for >= escalate_after consecutive
                # epochs: the next epoch is a forced full-precision
                # synchronous retry (BoundedStaleness also sees the counters
                # through Telemetry.site_staleness)
                self._needs_sync = True
                self._force_recovery = True
            self._last_decision = decision
            self._absorb_site_stats()
            pb, eb = self.comm_bytes_per_epoch(decision)
            m = EpochMetrics(self.epoch, loss, dt,
                             "sync" if decision.sync else "async",
                             pb / 1e6, eb / 1e6, schedule=decision.schedule,
                             bits_per_site=decision.bits_per_site(),
                             policy=self.policy.name,
                             ef_bits=decision.ef_bits,
                             faults_injected=injected, halos_reused=reused,
                             forced_syncs=forced, stall_s=stall)
        m.wall_s = obs.clock() - w0
        self.history.append(m)
        self.epoch += 1
        return m

    def evaluate(self, split: str = "val") -> float:
        mask = {"train": self.train_mask, "val": self.val_mask,
                "test": self.test_mask}[split]
        c, n = self._ev(self.state.params, self.block, self.x, self.y, mask,
                        self._epoch_key())
        return float(c) / max(float(n), 1.0)

    def fit(self, epochs: int, eval_every: int = 0) -> list[EpochMetrics]:
        # auto-checkpoint cadence: ``ckpt_every`` epochs, or 5 checkpoints
        # over the run.
        every = self.ckpt_every if self.ckpt_every else max(1, epochs // 5)
        for _ in range(epochs):
            m = self.train_epoch()
            if eval_every and self.epoch % eval_every == 0:
                m.val_acc = self.evaluate("val")
            if self.ckpt_dir and self.epoch % every == 0:
                self.save()
        return self.history

    # ------------------------------------------------------------------
    def save(self):
        """Checkpoint the whole stack's state. Under a sharded runtime every
        process joins the gather of the stacked leaves and rank 0 writes:
        the same format and arrays as the simulated runtime's."""
        state = self.runtime.gather_state(self.state)
        if self.rank not in (None, 0):
            return
        meta = dict(n_parts=self.pg.plan.n_parts, epoch=self.epoch,
                    mode=self.cfg.mode, policy=self.policy.name)
        ckpt.save(self.ckpt_dir, self.epoch, state, meta, keep=self.keep)

    def resume(self) -> bool:
        """Restore the latest checkpoint if present (one written by either
        package, under either runtime). Returns True if resumed. An elastic
        repartition (another n_parts) zeroes the halo caches and forces one
        synchronous epoch. Under a sharded runtime every process restores
        the whole stack and keeps its partition's slice."""
        step = ckpt.latest_step(self.ckpt_dir) if self.ckpt_dir else None
        if step is None:
            return False
        tree, meta, needs_sync = ckpt.restore(
            self.ckpt_dir, self.runtime.gather_state(self.state))
        self.state = self.runtime.device_put_gnn(tree)
        self.epoch = int(meta.get("epoch", step))
        self._needs_sync = needs_sync or \
            meta.get("n_parts") != self.pg.plan.n_parts
        if self.fault_plan is not None:
            # the staleness counters are host state, not checkpointed: the
            # resumed run starts them clean
            self._site_staleness[:] = 0
            self._force_recovery = False
        return True
