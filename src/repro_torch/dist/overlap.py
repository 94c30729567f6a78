"""Overlapped halo-exchange schedule, as ``repro.dist.overlap``, with a side
CUDA stream where the reference has a scheduling barrier.

The blocking schedule (``core/sylvie.py``) runs each site's ``gather ->
quantize -> exchange -> dequantize -> aggregate`` as one chain on one stream:
every comm byte is *exposed*. This module splits each exchange into the
issue/land protocol behind the same backend primitives:

* **issue** (:func:`_issue`) — on CUDA the boundary gather, quantize and
  exchange are enqueued on the side stream that the runtime's backend owns
  (``backend.side_stream``), after that stream waits for its input: for
  the work enqueued on the consuming stream so far, or only up to the
  ``ready`` event (:func:`mark`) recorded where the input was made; an
  event is recorded behind them. Under a sharded backend the exchange is
  an ``async_op=True`` collective started there, whose ``Work`` handles
  ride in the :class:`Inflight` (on the CPU too). Each
  site issues exactly once per direction, with the blocking schedule's
  kernels (the same launches, the same noise: each site draws from its own
  generator, whose offset advances per call, not per stream).
* **land** (:func:`_land`) — ``backend.fence`` makes the consuming stream
  wait on that event and on the collectives' ``Work`` (with ``gloo`` the
  wait blocks the host until the host-staged copy has landed), records the
  received tensors on it and puts a compact exchange's rows in bucket
  order; then the payload is dequantized there. Until the land, the consuming stream runs on:
  work that does not need the halo overlaps the exchange. A stream changes
  when a kernel runs, never what it computes, so every value is bit-equal
  to the blocking schedule. On the CPU the exchange runs in place and the
  fence is the identity.

Where the overlap has room (the models' code is unchanged, so no sum is
reordered). One host thread enqueues both streams, and an epoch is
host-bound, so a side kernel runs beside main-stream work only if that
work was enqueued *before* it and is still running; the schedule therefore
enqueues the independent work first:

* sync/fresh (:class:`OverlapQuantizedHalo`) — the halo is consumed right
  away (``halo_table``), so the forward lands at once; nothing the layer
  computes is independent of it in program order.
* async micro-step (:class:`OverlapStaleHalo` + :func:`overlap_fresh_halo`)
  — the site consumes the previous step's landed buffer (``feat_cache``,
  the Bounded Staleness contract). This step's fresh exchange of site
  ``i`` is marked ready at the site and issued at the next site (or, for
  the last site, before the backward: ``SylvieComm.issue_pending``), once
  layer ``i``'s aggregation is enqueued, and lands at the end of the step
  (``SylvieComm.land``), when it becomes the next step's ``feat_cache``.
  The backward marks its cotangent ready, enqueues the ``grad_in`` scatter,
  then issues the outgoing gradient exchange and lands it. An autograd
  Function's backward runs on its forward's stream, so the backward
  switches to the side stream itself and its land waits.

Tracing: each issue and each land is a ``halo`` span of its site and
direction (``core.exchange.halo_span``); the issue is timed on the side
stream it enqueues on, the land on the consuming stream. The backward
Functions wrap their whole work (scatter, issue, land) in one more.

The module also owns the DESIGN §8/§14 comm-time model: under the overlap
schedule each site's modeled comm time splits into an *overlapped* share
(hidden under that site's compute window) and an *exposed* remainder;
blocking exposes everything (:func:`split_comm_time`,
:func:`site_comm_seconds`). The figures of the card come from
``launch/hardware.py``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import quantization as qlib
from ..core.exchange import (PlanArrays, exchange_bytes, gather_boundary,
                             halo_span, issue_quantized_halo,
                             scatter_boundary_grad)
from .backend import Inflight


def fence(backend, tree):
    """The landing fence: identity on data; on CUDA the consuming stream
    waits for the side stream's event (``backend.fence``)."""
    f = getattr(backend, "fence", None)
    return f(tree) if f is not None else tree


def _live(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], x, 0.0)


def mark(t: torch.Tensor) -> Optional[torch.cuda.Event]:
    """An event recorded on the current stream: ``t``, made by the work
    enqueued so far, is ready there. ``None`` on the CPU."""
    if t.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return event


def _issue(src: torch.Tensor, prep: Callable, bits, stochastic, scale_dtype,
           backend, plan: PlanArrays, generator=None, u=None,
           reverse: bool = False,
           ready: Optional[torch.cuda.Event] = None, site=None,
           kind: str = "quantized") -> Inflight:
    """Issue one direction's quantized exchange: ``prep(src)`` (the boundary
    gather, or the masked gradient), quantize, start the exchange — on the
    side stream on CUDA, on the host's thread on the CPU. The side stream
    waits for ``ready`` (a :func:`mark` of ``src``), or for everything
    enqueued on the current stream so far. ``site`` and ``kind`` label its
    ``halo`` span."""
    direction = "bwd" if reverse else "fwd"

    def run():
        qt = qlib.quantize(prep(src), bits, generator, stochastic,
                           scale_dtype, u=u)
        return issue_quantized_halo(qt, plan, backend, reverse=reverse)

    if src.device.type != "cuda":
        with halo_span(site, direction, kind, src.device):
            return run()
    main = torch.cuda.current_stream(src.device)
    side = backend.side_stream(src.device)
    if ready is None:
        side.wait_stream(main)
    else:
        side.wait_event(ready)
    with torch.cuda.stream(side), \
            halo_span(site, direction, kind, src.device):
        inflight = run()
        inflight.event = torch.cuda.Event()
        inflight.event.record(side)
    # made on the consuming stream, read on the side stream: the allocator
    # must not reuse them before the side stream is done
    for t in (src, u):
        if t is not None and t.is_cuda:
            t.record_stream(side)
    return inflight


def _land(inflight: Inflight, backend, site=None, direction: str = "fwd",
          kind: str = "quantized") -> torch.Tensor:
    """Land an issued exchange: fence, then dequantize on the consuming
    stream (a ``halo`` span labelled by ``site``, ``direction``, ``kind``)."""
    with halo_span(site, direction, kind, inflight.qt.data.device):
        return qlib.dequantize(fence(backend, inflight).qt)


# ---------------------------------------------------------------------------
# sync/fresh schedule: issue, land in order, bit-exact to blocking
# ---------------------------------------------------------------------------
class OverlapQuantizedHalo(torch.autograd.Function):
    """Overlapped twin of :class:`~repro_torch.core.sylvie.QuantizedHalo` —
    the same arguments, the same values, issue/land in both passes."""

    @staticmethod
    def forward(ctx, h, plan: PlanArrays, fwd_bits: int, bwd_bits: int,
                stochastic: bool, scale_dtype, backend, gen_fwd=None,
                gen_bwd=None, u_fwd=None, u_bwd=None, site=None):
        ctx.plan, ctx.site = plan, site
        ctx.bwd = (bwd_bits, stochastic, scale_dtype, backend, gen_bwd, u_bwd)
        inflight = _issue(h, lambda t: gather_boundary(t, plan), fwd_bits,
                          stochastic, scale_dtype, backend, plan, gen_fwd,
                          u_fwd, site=site)
        return _live(_land(inflight, backend, site), plan.recv_mask)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 12
        plan, site = ctx.plan, ctx.site
        bits, stochastic, scale_dtype, backend, gen, u = ctx.bwd
        with halo_span(site, "bwd", "quantized", g.device):
            inflight = _issue(g, lambda t: _live(t, plan.recv_mask), bits,
                              stochastic, scale_dtype, backend, plan, gen, u,
                              reverse=True, site=site)
            back = _land(inflight, backend, site, "bwd")
            grad_h = scatter_boundary_grad(back, plan)
        return (grad_h,) + (None,) * 11


def overlap_quantized_halo(h, plan, fwd_bits, bwd_bits, stochastic,
                           scale_dtype, backend, gen_fwd=None, gen_bwd=None,
                           u_fwd=None, u_bwd=None, site=None) -> torch.Tensor:
    return OverlapQuantizedHalo.apply(h, plan, fwd_bits, bwd_bits, stochastic,
                                      scale_dtype, backend, gen_fwd, gen_bwd,
                                      u_fwd, u_bwd, site)


# ---------------------------------------------------------------------------
# async micro-step: consume the previous step's landed buffer
# ---------------------------------------------------------------------------
def overlap_fresh_halo(h, plan: PlanArrays, fwd_bits, stochastic,
                       scale_dtype, backend, generator=None, u=None,
                       ready: Optional[torch.cuda.Event] = None, site=None
                       ) -> Inflight:
    """Issue this step's fresh exchange (detached, like ``fresh_halo``); the
    caller lands it with :func:`land_fresh` once the step's other work is
    enqueued — it is the *next* step's ``feat_cache``. ``ready``: a
    :func:`mark` of ``h``, when the issue comes later than ``h``."""
    with torch.no_grad():
        return _issue(h.detach(), lambda t: gather_boundary(t, plan),
                      fwd_bits, stochastic, scale_dtype, backend, plan,
                      generator, u, ready=ready, site=site, kind="fresh")


def land_fresh(inflight: Inflight, plan: PlanArrays, backend,
               site=None) -> torch.Tensor:
    """The landed fresh halo: ``fresh_halo``'s value, bit for bit."""
    with torch.no_grad():
        return _live(_land(inflight, backend, site, kind="fresh"),
                     plan.recv_mask)


class OverlapStaleHalo(torch.autograd.Function):
    """Overlapped twin of :class:`~repro_torch.core.sylvie.StaleHalo`: the
    output is the previous step's landed buffer; the backward enqueues the
    ``grad_in`` scatter, issues this step's gradient exchange beside it, and
    lands the exchange as the gradient of ``gslot`` (the next step's
    ``grad_in``)."""

    @staticmethod
    def forward(ctx, h, feat_cache, grad_in, gslot, plan: PlanArrays,
                bwd_bits: int, stochastic: bool, scale_dtype, backend,
                gen_bwd=None, u_bwd=None, site=None):
        ctx.plan, ctx.grad_in, ctx.site = plan, grad_in, site
        ctx.bwd = (bwd_bits, stochastic, scale_dtype, backend, gen_bwd, u_bwd)
        return feat_cache.clone()

    @staticmethod
    def backward(ctx, g):
        plan, site = ctx.plan, ctx.site
        bits, stochastic, scale_dtype, backend, gen, u = ctx.bwd
        grad_h = fresh = None
        with halo_span(site, "bwd", "stale", g.device):
            ready = mark(g)
            if ctx.needs_input_grad[0]:
                grad_h = scatter_boundary_grad(ctx.grad_in, plan)
            if ctx.needs_input_grad[3]:
                inflight = _issue(g, lambda t: _live(t, plan.recv_mask), bits,
                                  stochastic, scale_dtype, backend, plan, gen,
                                  u, reverse=True, ready=ready, site=site,
                                  kind="stale")
                fresh = _live(_land(inflight, backend, site, "bwd", "stale"),
                              plan.send_mask)
        return (grad_h, None, None, fresh) + (None,) * 8


def overlap_stale_halo(h, feat_cache, grad_in, gslot, plan, bwd_bits,
                       stochastic, scale_dtype, backend, gen_bwd=None,
                       u_bwd=None, site=None) -> torch.Tensor:
    return OverlapStaleHalo.apply(h, feat_cache, grad_in, gslot, plan,
                                  bwd_bits, stochastic, scale_dtype, backend,
                                  gen_bwd, u_bwd, site)


# ---------------------------------------------------------------------------
# DESIGN §8/§14 comm-time model: exposed vs overlapped split
# ---------------------------------------------------------------------------
def site_comm_seconds(plan: PlanArrays, site_dims, decision, link_bw: float,
                      scale_dtype=torch.bfloat16) -> tuple[float, ...]:
    """Per-site modeled comm seconds (payload + error compensation, forward
    + backward, per device): ``bytes_i / n_parts / link_bw`` — the per-site
    decomposition of the scenario reports' ``modeled_comm_s``."""
    out = []
    for d, sd in zip(site_dims, decision.sites):
        total = 0.0
        for bits in (sd.fwd_bits, sd.bwd_bits):
            pb, eb = exchange_bytes(plan, d, bits, scale_dtype)
            total += pb + eb
        out.append(total / plan.n_parts / link_bw)
    return tuple(out)


def split_comm_time(site_comm_s, site_compute_s, schedule: str
                    ) -> tuple[float, float]:
    """(exposed_s, overlapped_s) per step under ``schedule``.

    Blocking exposes every comm second. Overlap hides, per site, up to that
    site's compute window: ``overlapped_i = min(comm_i, compute_i)``; the
    remainder stays exposed. Modeled step time is ``sum(compute) + exposed``
    (== compute + comm for blocking)."""
    from ..core.sylvie import SCHEDULES
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; known: {SCHEDULES}")
    total = float(sum(site_comm_s))
    if schedule != "overlap":
        return total, 0.0
    overlapped = float(sum(min(c, w) for c, w
                           in zip(site_comm_s, site_compute_s)))
    return total - overlapped, overlapped


def modeled_step_seconds(site_comm_s, site_compute_s, schedule: str) -> float:
    """Modeled per-step seconds: local compute plus the exposed comm share."""
    exposed, _ = split_comm_time(site_comm_s, site_compute_s, schedule)
    return float(sum(site_compute_s)) + exposed
