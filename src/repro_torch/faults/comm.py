"""Fault-tolerant halo communication: staleness as recovery, as
``repro.faults.comm``.

The three primitives of ``core/sylvie.py`` — :class:`QuantizedHalo`,
``fresh_halo`` and :class:`StaleHalo` — with two changes and no others:

* every quantized exchange goes through ``wire.checked_exchange`` (per-row
  checksum; injected corruption and drops from a
  :class:`~repro_torch.faults.plan.SiteFaults` mask block that rides as
  data);
* a condemned row (dropped or checksum-failed) falls back to the staleness
  contract instead of dequantizing garbage:

  - forward features: keep the previous step's cached halo row
    (``feat_cache``) — an unintended Sylvie-A step for that row;
  - backward gradients, sync step: a dropped returned-gradient row
    contributes zero — what the synchronous step's drained grad cache holds
    for every row;
  - backward gradients, async step: a dropped row keeps the previous
    in-flight ``grad_in`` row — one epoch staler, still bounded-stale.

With all-false masks every blend reduces to the clean expression (the cache
and ``grad_in`` are zero outside the live rows: they start zero and are only
written by these masked blends), so a clean
:class:`~repro_torch.faults.plan.FaultCtl` gives the clean primitives' values
bit for bit. Noise comes as in the clean Functions: generators, or injected
``u_fwd`` / ``u_bwd``.
"""
from __future__ import annotations

import torch

from ..core import quantization as qlib
from ..core.exchange import (PlanArrays, gather_boundary,
                             scatter_boundary_grad)
from .wire import checked_exchange


def _blend(ok, mask, x, fallback):
    return torch.where((ok & mask)[..., None], x, fallback)


# ---------------------------------------------------------------------------
# Sylvie-S under faults: blend with the cache wherever the wire failed
# ---------------------------------------------------------------------------
class FaultyQuantizedHalo(torch.autograd.Function):
    """:class:`~repro_torch.core.sylvie.QuantizedHalo` with checksummed
    exchanges and the stale fallback. ``feat_cache`` (the previous step's
    halo of this site) and ``sf`` (the site's masks) are data: no
    gradients."""

    @staticmethod
    def forward(ctx, h, feat_cache, sf, plan: PlanArrays, fwd_bits: int,
                bwd_bits: int, stochastic: bool, scale_dtype, backend,
                gen_fwd=None, gen_bwd=None, u_fwd=None, u_bwd=None):
        ctx.plan, ctx.sf = plan, sf
        ctx.bwd = (bwd_bits, stochastic, scale_dtype, backend, gen_bwd, u_bwd)
        qt = qlib.quantize(gather_boundary(h, plan), fwd_bits, gen_fwd,
                           stochastic, scale_dtype, u=u_fwd)
        qr, ok = checked_exchange(qt, plan, backend, sf.corrupt_fwd,
                                  sf.drop_fwd)
        # one blend: outside recv_mask the cache is zero by construction
        return _blend(ok, plan.recv_mask, qlib.dequantize(qr), feat_cache)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 13
        plan, sf = ctx.plan, ctx.sf
        bits, stochastic, scale_dtype, backend, gen, u = ctx.bwd
        qt = qlib.quantize(torch.where(plan.recv_mask[..., None], g, 0.0),
                           bits, gen, stochastic, scale_dtype, u=u)
        qr, ok = checked_exchange(qt, plan, backend, sf.corrupt_bwd,
                                  sf.drop_bwd, reverse=True)
        # a lost returned-gradient row contributes zero — the synchronous
        # step's grad caches are drained, so zero *is* its stale value
        back = _blend(ok, plan.send_mask, qlib.dequantize(qr), 0.0)
        return (scatter_boundary_grad(back, plan),) + (None,) * 12


def faulty_quantized_halo(h, feat_cache, sf, plan, fwd_bits, bwd_bits,
                          stochastic, scale_dtype, backend, gen_fwd=None,
                          gen_bwd=None, u_fwd=None, u_bwd=None
                          ) -> torch.Tensor:
    return FaultyQuantizedHalo.apply(h, feat_cache, sf, plan, fwd_bits,
                                     bwd_bits, stochastic, scale_dtype,
                                     backend, gen_fwd, gen_bwd, u_fwd, u_bwd)


# ---------------------------------------------------------------------------
# Sylvie-A under faults
# ---------------------------------------------------------------------------
def faulty_fresh_halo(h, old_cache, sf, plan: PlanArrays, fwd_bits,
                      stochastic, scale_dtype, backend, generator=None,
                      u=None) -> torch.Tensor:
    """``fresh_halo`` with a checksummed exchange: a condemned row leaves
    the *old* cache row in place (one step staler) instead of refreshing
    it. Detached like the original."""
    with torch.no_grad():
        qt = qlib.quantize(gather_boundary(h.detach(), plan), fwd_bits,
                           generator, stochastic, scale_dtype, u=u)
        qr, ok = checked_exchange(qt, plan, backend, sf.corrupt_fwd,
                                  sf.drop_fwd)
        return _blend(ok, plan.recv_mask, qlib.dequantize(qr),
                      old_cache.detach())


class FaultyStaleHalo(torch.autograd.Function):
    """:class:`~repro_torch.core.sylvie.StaleHalo` with a checksummed
    backward gradient exchange: the output is the cached halo; a condemned
    row of the outgoing gradients keeps the previous ``grad_in`` row as the
    next step's in-flight gradient (one epoch staler)."""

    @staticmethod
    def forward(ctx, h, feat_cache, grad_in, gslot, sf, plan: PlanArrays,
                bwd_bits: int, stochastic: bool, scale_dtype, backend,
                gen_bwd=None, u_bwd=None):
        ctx.plan, ctx.grad_in, ctx.sf = plan, grad_in, sf
        ctx.bwd = (bwd_bits, stochastic, scale_dtype, backend, gen_bwd, u_bwd)
        return feat_cache.clone()

    @staticmethod
    def backward(ctx, g):
        plan, sf = ctx.plan, ctx.sf
        grad_h = fresh = None
        if ctx.needs_input_grad[3]:
            bits, stochastic, scale_dtype, backend, gen, u = ctx.bwd
            qt = qlib.quantize(torch.where(plan.recv_mask[..., None], g, 0.0),
                               bits, gen, stochastic, scale_dtype, u=u)
            qr, ok = checked_exchange(qt, plan, backend, sf.corrupt_bwd,
                                      sf.drop_bwd, reverse=True)
            # grad_in is zero outside send_mask — one blend suffices
            fresh = _blend(ok, plan.send_mask, qlib.dequantize(qr),
                           ctx.grad_in)
        if ctx.needs_input_grad[0]:
            grad_h = scatter_boundary_grad(ctx.grad_in, plan)
        return (grad_h, None, None, fresh) + (None,) * 8


def faulty_stale_halo(h, feat_cache, grad_in, gslot, sf, plan, bwd_bits,
                      stochastic, scale_dtype, backend, gen_bwd=None,
                      u_bwd=None) -> torch.Tensor:
    return FaultyStaleHalo.apply(h, feat_cache, grad_in, gslot, sf, plan,
                                 bwd_bits, stochastic, scale_dtype, backend,
                                 gen_bwd, u_bwd)
