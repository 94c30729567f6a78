"""Step functions for distributed full-graph GNN training (the paper's Trainer).

Three step flavors over one :class:`GNNTrainState`, as
``repro.train.gnn_step`` builds them:

* ``train_step_sync`` — vanilla (bits=32) or Sylvie-S: fresh quantized
  exchange in both passes; also refreshes the Sylvie-A feature caches and
  *drains* the gradient caches to zeros;
* ``train_step_async`` — Sylvie-A: consumes the cached halo features and
  gradients and emits fresh caches for the next step. The new
  ``HaloState.grads`` are the gradients of the zero-valued ``gslots`` at
  the sites whose ``h`` requires a gradient. The cache of a site whose
  ``h`` needs none (site 0 of GCN and GraphSAGE, whose ``h`` is the input)
  is never read, and the step leaves it as it was: zero from ``create`` and
  from every synchronous step's drain;
* ``eval_step`` — full-precision synchronous exchange (accuracy).

What each exchange site does comes from an
:class:`~repro_torch.policy.base.EpochDecision` fixed when the steps are
built; so is the exchange schedule (``"overlap"``: the issue/land twins of
``dist/overlap.py``; an async step's fresh exchanges are issued a layer
later, the last before the backward, and land once the rest of the step is
enqueued). ``state.faults`` (a
:class:`~repro_torch.faults.plan.FaultCtl`, set by the trainer each chaos
epoch; ``None`` = fault-free) arms every site with that epoch's wire masks.
The steps emit ``site_stats``, a ``(n_sites, 2)`` tensor of [sum of
squared boundary-row ranges, live rows] per site, for the policy loop.
Weight gradients come from ``torch.autograd.grad`` and are all-reduced
once (Alg. 2 line 16) by ``backend.psum``: the identity on the simulated
stack; across processes an ``all_reduce`` whose transpose is the identity,
so the loss's own ``psum`` (``_masked_loss``) does not count them P times.
The loss, the site stats and the eval counts are reduced the same way, so
every process holds the same replicated values. With ``decision.ef_bits``
set the reduced gradient passes through the EF21 compressor.

The state's tree keeps the JAX package's keys (``params/layer0/w``,
``opt_state/m/layer0/w``, ``halo/feats/0``, ``ef/error/...``,
``site_stats``, ``step``), so one checkpoint serves both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.staleness import HaloState
from ..core.sylvie import SCHEDULES, SylvieComm, SylvieConfig
from ..dist.backend import as_backend
from ..models import nn
from ..policy.base import EpochDecision, validate_decision
from . import optimizer as optlib
from .compression import EFState, ef_allreduce


@dataclasses.dataclass
class GNNTrainState:
    params: dict
    opt_state: dict
    halo: HaloState
    step: torch.Tensor          # () int32
    ef: EFState
    site_stats: torch.Tensor    # (n_sites, 2) float32
    # the epoch's fault masks (repro_torch.faults.plan.FaultCtl); None =
    # fault-free, the clean primitives
    faults: Optional[object] = None

    @staticmethod
    def create(params: dict, opt: optlib.Optimizer, plan, dims,
               stacked_parts: Optional[int] = None, device=None
               ) -> "GNNTrainState":
        """A fresh state around ``params`` (nested dicts of tensors, moved to
        ``device``): zero halo caches at the site widths ``dims``."""
        params = optlib.tree_map(
            lambda p: p.detach().to(device=device, dtype=torch.float32)
            .clone(), params)
        return GNNTrainState(
            params=params, opt_state=opt.init(params),
            halo=HaloState.zeros(plan, dims, stacked_parts=stacked_parts,
                                 device=device),
            step=torch.zeros((), dtype=torch.int32, device=device),
            ef=EFState.zeros_like(params),
            site_stats=torch.zeros((len(dims), 2), dtype=torch.float32,
                                   device=device))


def _masked_loss(logits, y, mask, backend):
    s, c = nn.cross_entropy(logits, y, mask.to(torch.float32))
    return backend.psum(s) / torch.clamp(backend.psum(c), min=1.0)


def _leaves_requiring_grad(params):
    return optlib.tree_map(lambda p: p.detach().requires_grad_(), params)


def make_gnn_steps(model, cfg: SylvieConfig, opt: optlib.Optimizer,
                   backend=None, clip_norm: Optional[float] = None,
                   decision: Optional[EpochDecision] = None):
    """Builds ``(train_step_sync, train_step_async, eval_step)``; the caller
    decides which to run each epoch (``GNNTrainer`` owns that loop).

    Each train step is ``step(state, block, x, y, mask, key, bns_masks=None)
    -> (new state, loss)`` with ``key`` a tuple of integers (the noise
    streams, see ``core/sylvie.py``) and ``bns_masks`` the per-site BNS
    keep-masks that replace the sync step's draws (the async step samples
    no boundary); ``eval_step(params, block, x, y, mask, key) -> (correct,
    count)``."""
    backend = as_backend(backend)
    n_sites = len(model.comm_dims())
    if decision is None:
        decision = EpochDecision.from_config(cfg, n_sites)
    decision = validate_decision(decision, n_sites)
    for sched in (cfg.schedule, decision.schedule):
        if sched not in SCHEDULES:
            raise ValueError(f"unknown schedule {sched!r}; known: {SCHEDULES}")
    sync_cfg = cfg if cfg.mode != "async" else cfg.replace(mode="sync")
    async_cfg = cfg.replace(mode="async")

    def _finish(state, grads, loss, comm, halo_grads=None):
        """The all-reduce, EF21, clipping and the optimizer; then the halo
        caches land (an in-flight exchange has run under all of this). A
        synchronous step (``halo_grads`` None) drains the grad caches."""
        stats = backend.psum(torch.stack(comm.site_stats))
        with torch.no_grad():
            grads = optlib.tree_map(backend.psum, grads)
            if decision.ef_bits is not None:
                grads, new_ef = ef_allreduce(grads, state.ef,
                                             bits=decision.ef_bits)
            else:
                new_ef = state.ef
            if clip_norm is not None:
                grads, _ = optlib.clip_by_global_norm(grads, clip_norm)
            updates, new_opt = opt.update(grads, state.opt_state,
                                          state.params)
            new_params = optlib.apply_updates(state.params, updates)
        feats = comm.land()
        if halo_grads is None:
            halo_grads = tuple(torch.zeros_like(f) for f in feats)
        return GNNTrainState(new_params, new_opt,
                             HaloState(feats=feats, grads=tuple(halo_grads)),
                             state.step + 1, new_ef, stats,
                             state.faults), loss.detach()

    def _grads(loss, params, extra=()):
        leaves = optlib.tree_leaves(params)
        got = torch.autograd.grad(loss, leaves + list(extra))
        it = iter(got[:len(leaves)])
        return optlib.tree_map(lambda _: next(it), params), got[len(leaves):]

    def train_step_sync(state: GNNTrainState, block, x, y, mask, key,
                        bns_masks=None):
        params = _leaves_requiring_grad(state.params)
        armed = state.faults is not None
        comm = SylvieComm(sync_cfg, block.plan, backend=backend,
                          decision=decision, key=key, collect_stats=True,
                          bns_masks=bns_masks,
                          feat_caches=state.halo.feats if armed else None,
                          fault_sites=state.faults.sites if armed else None)
        loss = _masked_loss(model.apply(params, block, x, comm), y, mask,
                            backend)
        grads, _ = _grads(loss, params)
        return _finish(state, grads, loss, comm)

    def train_step_async(state: GNNTrainState, block, x, y, mask, key,
                         bns_masks=None):
        params = _leaves_requiring_grad(state.params)
        comm = SylvieComm(async_cfg, block.plan, backend=backend,
                          decision=decision, key=key, collect_stats=True,
                          feat_caches=state.halo.feats,
                          grad_ins=state.halo.grads,
                          fault_sites=(state.faults.sites
                                       if state.faults is not None else None))
        loss = _masked_loss(model.apply(params, block, x, comm), y, mask,
                            backend)
        comm.issue_pending()    # the overlap schedule: beside the backward
        grads, ggrads = _grads(loss, params,
                               [s for s in comm.gslots if s is not None])
        it = iter(ggrads)
        halo_grads = [old if s is None else next(it)
                      for s, old in zip(comm.gslots, state.halo.grads)]
        return _finish(state, grads, loss, comm, halo_grads)

    def eval_step(params, block, x, y, mask, key):
        comm = SylvieComm(sync_cfg.replace(mode="vanilla", stochastic=False),
                          block.plan, backend=backend, key=key)
        with torch.no_grad():
            logits = model.apply(params, block, x, comm)
            correct, count = nn.accuracy_counts(logits, y,
                                                mask.to(torch.float32))
        return backend.psum(correct), backend.psum(count)

    return train_step_sync, train_step_async, eval_step
