"""Sylvie's communication config and the per-pass orchestrator handed to models.

Three communication modes (paper §3):

* ``vanilla`` — full-precision synchronous exchange; the same path as
  Sylvie-S at 32 bits (quantize is then the identity);
* ``sync`` — **Sylvie-S**: quantize -> exchange -> dequantize at each layer,
  in both passes. The backward pass communicates *quantized feature
  gradients* over the reversed rings (Alg. 2 lines 10-12):
  :class:`QuantizedHalo`;
* ``async`` — **Sylvie-A**: the layer consumes the *previous step's* halo
  (``feat_cache``) and emits a fresh quantized exchange as the next step's
  cache (:func:`fresh_halo`). The backward mirrors it (:class:`StaleHalo`):
  the cotangent on the stale halo is exchanged and surfaces as the gradient
  of a zero-valued ``gslot`` input, the next step's ``grad_in``; this step's
  ``grad_in`` (one step stale) is scattered onto the boundary nodes.

These are the three ``jax.custom_vjp``s of ``repro.core.sylvie`` as
``torch.autograd.Function``s. What each site does in a given epoch —
forward/backward bit-widths, rounding, BNS boundary sampling — is a
:class:`~repro_torch.policy.base.SiteDecision`: the i-th ``halo`` call reads
``decision.sites[i]``.

**Noise.** Stochastic rounding draws ``u`` from ``torch.Generator``s. A
training step's ``key`` is a tuple of integers (the trainer's is ``(seed,
epoch)``); site ``i`` draws its forward noise from the generator seeded by
``SeedSequence(key + (2i,))``, its backward noise from ``SeedSequence(key +
(2i+1,))`` and its BNS keep-mask from ``SeedSequence(key + (999,))`` — the
layout of JAX's ``fold_in(key, 2i)`` / ``2i+1`` / ``999``, not its values
(the two PRNGs differ, so stochastic runs match JAX only through injected
noise: the Functions take ``u_fwd`` / ``u_bwd``, and ``SylvieComm`` takes
per-site BNS keep-masks, ``bns_masks``). Without a key, every site shares
the one ``generator`` (the serving sweep's stream).

``SylvieComm.halo`` dispatches as the reference does: fault-armed sites
(``fault_sites``, masks of ``repro_torch.faults``) run the blocking faulty
primitives of ``faults/comm.py`` whatever the schedule (the recovery blend
needs the landed exchange at once, DESIGN §14); otherwise the ``"overlap"``
schedule runs the issue/land twins of ``dist/overlap.py`` (a side CUDA
stream on the card), and ``"blocking"`` the Functions below.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..dist import overlap as olap
from ..dist.backend import Inflight, SimulatedBackend
from ..faults import comm as fcomm
from ..policy.base import SiteDecision
from . import quantization as qlib
from .exchange import (PlanArrays, exchange_quantized_halo, gather_boundary,
                       scatter_boundary_grad)

Mode = str  # "vanilla" | "sync" | "async"

# Exchange schedules: "blocking" consumes each halo exchange where it is
# produced; "overlap" issues it early and lands it through a backend fence.
SCHEDULES = ("blocking", "overlap")
BNS_STREAM = 999


@dataclasses.dataclass(frozen=True)
class SylvieConfig:
    mode: Mode = "sync"
    bits: int = 1
    stochastic: bool = True
    scale_dtype: torch.dtype = torch.bfloat16
    # BNS-GCN baseline: keep a (1-p) fraction of halo rows; p=0 disables.
    boundary_sample_p: float = 0.0
    schedule: str = "blocking"

    @property
    def effective_bits(self) -> int:
        return 32 if self.mode == "vanilla" else self.bits

    def replace(self, **kw) -> "SylvieConfig":
        return dataclasses.replace(self, **kw)


def stream_generator(key: tuple, stream: int, device) -> torch.Generator:
    """The generator of one noise stream of a step: seeded by
    ``SeedSequence(key + (stream,))``, on ``device``."""
    seed = np.random.SeedSequence([*key, stream]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def _q_roundtrip(buf, bits, stochastic, scale_dtype, backend, plan,
                 generator=None, u=None, reverse=False):
    """quantize -> exchange -> dequantize (one direction of the Low-bit
    Module). ``reverse`` runs the inverted rings (backward comm)."""
    qt = qlib.quantize(buf, bits, generator, stochastic, scale_dtype, u=u)
    return qlib.dequantize(exchange_quantized_halo(qt, plan, backend,
                                                   reverse=reverse))


def _live(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], x, 0.0)


# ---------------------------------------------------------------------------
# Sylvie-S: synchronous quantized exchange with quantized backward comm
# ---------------------------------------------------------------------------
class QuantizedHalo(torch.autograd.Function):
    """(P, n_local, d) -> (P, halo_rows, d) dequantized halo features.

    ``fwd_bits`` quantizes the forward feature exchange, ``bwd_bits`` the
    backward gradient exchange, which runs the reversed rings and whose
    result is scattered onto the owners. The backward exchanges nothing when
    ``h`` needs no gradient (site 0, whose ``h`` is the input)."""

    @staticmethod
    def forward(ctx, h, plan: PlanArrays, fwd_bits: int, bwd_bits: int,
                stochastic: bool, scale_dtype, backend, gen_fwd=None,
                gen_bwd=None, u_fwd=None, u_bwd=None):
        ctx.plan, ctx.bwd = plan, (bwd_bits, stochastic, scale_dtype, backend,
                                   gen_bwd, u_bwd)
        out = _q_roundtrip(gather_boundary(h, plan), fwd_bits, stochastic,
                           scale_dtype, backend, plan, gen_fwd, u_fwd)
        return _live(out, plan.recv_mask)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 11
        plan = ctx.plan
        bits, stochastic, scale_dtype, backend, gen, u = ctx.bwd
        back = _q_roundtrip(_live(g, plan.recv_mask), bits, stochastic,
                            scale_dtype, backend, plan, gen, u, reverse=True)
        return (scatter_boundary_grad(back, plan),) + (None,) * 10


def quantized_halo(h, plan, fwd_bits, bwd_bits, stochastic, scale_dtype,
                   backend, gen_fwd=None, gen_bwd=None, u_fwd=None,
                   u_bwd=None) -> torch.Tensor:
    return QuantizedHalo.apply(h, plan, fwd_bits, bwd_bits, stochastic,
                               scale_dtype, backend, gen_fwd, gen_bwd, u_fwd,
                               u_bwd)


# ---------------------------------------------------------------------------
# Sylvie-A: stale halo consumption + fresh exchange emission
# ---------------------------------------------------------------------------
def fresh_halo(h, plan: PlanArrays, fwd_bits, stochastic, scale_dtype,
               backend, generator=None, u=None) -> torch.Tensor:
    """The concurrent forward exchange: this step's boundary features,
    quantized and delivered as the *next* step's cache. Detached — no
    gradient flows (staleness is handled by the ``grad_in`` path)."""
    with torch.no_grad():
        out = _q_roundtrip(gather_boundary(h.detach(), plan), fwd_bits,
                           stochastic, scale_dtype, backend, plan, generator,
                           u)
        return _live(out, plan.recv_mask)


class StaleHalo(torch.autograd.Function):
    """Consume the stale halo; wire the staleness dataflow into autograd.

    * output = ``feat_cache`` (the previous step's dequantized halo);
    * grad wrt ``h`` = ``grad_in`` scattered onto the boundary nodes (the
      previous step's incoming boundary gradients — Alg. 2 line 13);
    * grad wrt ``gslot`` = this step's outgoing quantized gradient exchange
      at ``bwd_bits`` over the reversed rings, masked to the live send
      slots: the next step's ``grad_in``."""

    @staticmethod
    def forward(ctx, h, feat_cache, grad_in, gslot, plan: PlanArrays,
                bwd_bits: int, stochastic: bool, scale_dtype, backend,
                gen_bwd=None, u_bwd=None):
        ctx.plan, ctx.grad_in = plan, grad_in
        ctx.bwd = (bwd_bits, stochastic, scale_dtype, backend, gen_bwd, u_bwd)
        return feat_cache.clone()

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        grad_h = fresh = None
        if ctx.needs_input_grad[3]:
            bits, stochastic, scale_dtype, backend, gen, u = ctx.bwd
            fresh = _live(_q_roundtrip(_live(g, plan.recv_mask), bits,
                                       stochastic, scale_dtype, backend, plan,
                                       gen, u, reverse=True), plan.send_mask)
        if ctx.needs_input_grad[0]:
            grad_h = scatter_boundary_grad(ctx.grad_in, plan)
        return (grad_h, None, None, fresh) + (None,) * 7


def stale_halo(h, feat_cache, grad_in, gslot, plan, bwd_bits, stochastic,
               scale_dtype, backend, gen_bwd=None, u_bwd=None) -> torch.Tensor:
    return StaleHalo.apply(h, feat_cache, grad_in, gslot, plan, bwd_bits,
                           stochastic, scale_dtype, backend, gen_bwd, u_bwd)


# ---------------------------------------------------------------------------
# Per-pass orchestrator handed to the model
# ---------------------------------------------------------------------------
class SylvieComm:
    """Created for each pass; models call ``comm.halo(h)`` once per
    layer-exchange site, in ``model.comm_dims()`` order. All communication
    goes through ``backend`` (the simulated stack by default).

    ``decision`` is an :class:`~repro_torch.policy.base.EpochDecision` whose
    ``sites[i]`` drives the i-th ``halo`` call; ``None`` gives every site the
    one global ``SylvieConfig`` choice. ``key`` (a training step's tuple of
    integers) gives each site its own forward and backward noise streams;
    without it every site draws from ``generator``. Collects the halos it
    produced (``new_feat_caches``: the Sylvie-A caches of the next step) and,
    when ``collect_stats``, per-site boundary range statistics.
    ``bns_masks`` (one (P, halo_rows) 0/1 keep-mask per site) replaces the
    BNS draws of a synchronous pass where sampling is on. ``fault_sites``
    (one :class:`~repro_torch.faults.plan.SiteFaults` per site; ``None`` =
    fault-free) arms every site with its masks; a synchronous pass then also
    needs ``feat_caches``, the fallback of a condemned row. Under the overlap
    schedule an async pass's fresh exchange of a site is issued at the next
    site (the last one's by :meth:`issue_pending`, before the backward) and
    stays in flight until :meth:`land`."""

    def __init__(self, cfg: SylvieConfig, plan: PlanArrays,
                 generator: Optional[torch.Generator] = None, backend=None,
                 decision=None, *, key: Optional[tuple] = None,
                 collect_stats: bool = False, feat_caches=None,
                 grad_ins=None, gslots=None, fault_sites=None,
                 bns_masks=None):
        self.cfg = cfg
        self.plan = plan
        self.generator = generator
        self.backend = backend if backend is not None else SimulatedBackend()
        self.decision = decision
        self.key = key
        self.collect_stats = collect_stats
        self.feat_caches = feat_caches
        self.grad_ins = grad_ins
        self.gslots = gslots
        self.bns_masks = bns_masks
        self.fault_sites = fault_sites
        self.new_feat_caches: list = []
        self._pending: list = []      # (cache index, deferred fresh issue)
        self.site_stats: list = []
        self._site = 0

    def _site_decision(self, i) -> SiteDecision:
        if self.decision is not None:
            return self.decision.sites[i]
        return SiteDecision.from_config(self.cfg)

    @property
    def schedule(self) -> str:
        """Exchange schedule: the decision's choice when one is threaded in,
        else the config's (both default to ``"blocking"``)."""
        sched = (self.decision.schedule if self.decision is not None
                 else self.cfg.schedule)
        if sched not in SCHEDULES:
            raise ValueError(f"unknown schedule {sched!r}; known: {SCHEDULES}")
        return sched

    def _stream(self, stream: int, device) -> Optional[torch.Generator]:
        if self.key is None:
            return self.generator
        return stream_generator(self.key, stream, device)

    def _bns_mask(self, i: int, p: float, device) -> Optional[torch.Tensor]:
        """BNS-GCN-style boundary sampling: one Bernoulli keep-mask per halo
        row per step (site ``i``'s injected one when given), scaled by
        1/(1-p); it multiplies the halo, so the backward sees the same
        mask."""
        if p <= 0.0:
            return None
        if self.bns_masks is not None:
            keep = self.bns_masks[i].to(device=device, dtype=torch.float32)
        else:
            keep = torch.bernoulli(
                torch.full(tuple(self.plan.recv_mask.shape), 1.0 - p,
                           device=device),
                generator=self._stream(BNS_STREAM, device))
        return keep / (1.0 - p)

    def _record_stats(self, h: torch.Tensor) -> None:
        """Per-site telemetry for adaptive policies: the sum over live send
        rows of the squared per-row range, and the live-row count."""
        if not self.collect_stats:
            return
        with torch.no_grad():
            buf = gather_boundary(h.detach(), self.plan)
            rng = buf.amax(dim=-1) - buf.amin(dim=-1)
            live = self.plan.send_mask.to(torch.float32)
            self.site_stats.append(torch.stack([(rng ** 2 * live).sum(),
                                                live.sum()]))

    def halo(self, h: torch.Tensor) -> torch.Tensor:
        self.issue_pending()
        cfg = self.cfg
        i = self._site
        self._site += 1
        sd = self._site_decision(i)
        self._record_stats(h)
        gen_f, gen_b = self._stream(2 * i, h.device), \
            self._stream(2 * i + 1, h.device)
        sf = self.fault_sites[i] if self.fault_sites is not None else None
        # fault-armed sites always run the blocking faulty primitives: the
        # recovery blend needs the landed exchange immediately (DESIGN §14)
        overlap = self.schedule == "overlap" and sf is None
        args = (sd.stochastic, cfg.scale_dtype, self.backend)
        if cfg.mode in ("vanilla", "sync"):
            if sf is not None:
                halo = fcomm.faulty_quantized_halo(
                    h, self.feat_caches[i], sf, self.plan, sd.fwd_bits,
                    sd.bwd_bits, *args, gen_f, gen_b)
            elif overlap:
                halo = olap.overlap_quantized_halo(
                    h, self.plan, sd.fwd_bits, sd.bwd_bits, *args, gen_f,
                    gen_b)
            else:
                halo = quantized_halo(h, self.plan, sd.fwd_bits, sd.bwd_bits,
                                      *args, gen_f, gen_b)
            bns = self._bns_mask(i, sd.boundary_sample_p, h.device)
            if bns is not None:
                halo = halo * bns[..., None]
            # a synchronous step doubles as a cache refresh for Sylvie-A
            self.new_feat_caches.append(halo.detach())
            return halo
        # async: consume stale, emit fresh
        stale = (h, self.feat_caches[i], self.grad_ins[i], self.gslots[i])
        if sf is not None:
            halo = fcomm.faulty_stale_halo(*stale, sf, self.plan, sd.bwd_bits,
                                           *args, gen_b)
            fresh = fcomm.faulty_fresh_halo(h, self.feat_caches[i], sf,
                                            self.plan, sd.fwd_bits, *args,
                                            gen_f)
        elif overlap:
            halo = olap.overlap_stale_halo(*stale, self.plan, sd.bwd_bits,
                                           *args, gen_b)
            # issued once this layer's aggregation is enqueued, so that the
            # side stream runs beside it; h is ready here
            ready = olap.mark(h)
            self._pending.append((len(self.new_feat_caches), lambda: (
                olap.overlap_fresh_halo(h, self.plan, sd.fwd_bits, *args,
                                        gen_f, ready=ready))))
            fresh = None
        else:
            halo = stale_halo(*stale, self.plan, sd.bwd_bits, *args, gen_b)
            fresh = fresh_halo(h, self.plan, sd.fwd_bits, *args, gen_f)
        self.new_feat_caches.append(fresh)
        return halo

    def issue_pending(self) -> None:
        """Issue the deferred fresh exchanges (the overlap schedule's async
        pass); the step calls it after the forward, before the backward."""
        for idx, issue in self._pending:
            self.new_feat_caches[idx] = issue()
        self._pending.clear()

    def land(self) -> tuple:
        """The halos this pass produced (the next step's feature caches),
        landed: an in-flight fresh exchange of the overlap schedule is fenced
        and dequantized here, so the caller lands them once the rest of its
        step is enqueued."""
        self.issue_pending()
        return tuple(olap.land_fresh(c, self.plan, self.backend)
                     if isinstance(c, Inflight) else c
                     for c in self.new_feat_caches)

    @property
    def n_sites(self) -> int:
        return self._site
