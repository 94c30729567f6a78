"""Plain PyTorch versions of the flash-attention forward (``csrc/flash.cu``).

* :func:`flash_ref` — a copy of ``repro/kernels/flash/ref.py``: dense
  O(S^2) softmax attention over (BH, S, D), v (BH, S, Dv).
* :func:`flash_fwd_ref` — the Pallas kernel's arithmetic
  (``repro/kernels/flash/flash.py::_flash_kernel``) block by block: q scaled
  in float32, online softmax over KV blocks, the causal block skip, raw
  ``(acc, m, l)``. Its live scores are one (BH, blk_q, blk_k) tile, so it runs
  at the serving path's shapes on the card.
* :func:`attention_bshd_ref` — the LM's ``blockwise_attention``
  (``repro/models/lm/model.py:126``): (B, S, H, D) layout, GQA, ``kv_len``,
  window and softcap, v of its own width Dv, q scaled in its own dtype;
  with ``return_lse`` also each row's log-sum-exp of its (capped) scores.
* :func:`attention_bshd_bwd_ref` — its gradient by the explicit formulas
  over KV blocks (not autograd), the plain version of ``csrc/flash_bwd.cu``.
  The JAX package has no backward kernel: it differentiates
  ``blockwise_attention`` itself, and the tests hold this function to
  ``jax.vjp`` of it.

Masked scores contribute exactly 0 here and in the kernel
(``p = where(mask, exp(s - m), 0)``). For every query row that sees at least
one key this gives the JAX functions' bits, which add ``exp(NEG - NEG) = 1``
per masked score while the running max is still ``NEG`` and wipe those terms
out later with ``exp(NEG - m) = 0``. A row that sees no key at all gets
``acc = 0, l = 0, m = NEG`` (output 0), where the JAX functions return a
block-dependent mean of ``v``; the LM never makes such a row (causal, every
row sees its own position).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = -2.0e38


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
          window: Optional[int], kv_len: int) -> torch.Tensor:
    """(Sq, Skv) visibility: ``kv < kv_len``, causal, sliding window."""
    mask = kv_pos[None, :] < kv_len
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
    return mask


def flash_ref(q, k, v, *, causal: bool = True, scale: float = 1.0,
              window: Optional[int] = None) -> torch.Tensor:
    """q: (BH, Sq, D); k: (BH, Skv, D); v: (BH, Skv, Dv) -> (BH, Sq, Dv).
    O(S^2) reference."""
    logits = torch.einsum("bqd,bkd->bqk", q * scale, k).float()
    sq, skv = q.shape[1], k.shape[1]
    dev = q.device
    mask = _mask(torch.arange(sq, device=dev), torch.arange(skv, device=dev),
                 causal=causal, window=window, kv_len=skv)
    logits = torch.where(mask[None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v)


def online_softmax_step(m, l, acc, s, mask, vc):
    """One KV block of the online softmax, in float32: scores ``s`` (masked
    to ``NEG``) and values ``vc`` (f32 product, f32 sum) update the running
    max ``m``, sum ``l`` and accumulator ``acc``. Masked scores add 0."""
    m_new = torch.maximum(m, s.max(-1).values)
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.matmul(p.to(vc.dtype).float(),
                                               vc.float())
    return m_new, l, acc


def flash_fwd_ref(q, k, v, *, blk_q: int = 128, blk_k: int = 128,
                  causal: bool = True, scale: float = 1.0,
                  window: Optional[int] = None):
    """(BH, Sq, D) x (BH, Skv, D) x (BH, Skv, Dv) -> raw (acc (BH, Sq, Dv),
    m (BH, Sq), l (BH, Sq)), all float32; the attention is ``acc / l``."""
    bh, sq, _ = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    blk_q, blk_k = min(blk_q, sq), min(blk_k, skv)
    dev = q.device
    acc = torch.zeros((bh, sq, dv), dtype=torch.float32, device=dev)
    m = torch.full((bh, sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, sq), dtype=torch.float32, device=dev)
    for q_lo in range(0, sq, blk_q):
        q_hi = min(q_lo + blk_q, sq)
        qb = q[:, q_lo:q_hi].float() * scale
        q_pos = torch.arange(q_lo, q_hi, device=dev)
        mb, lb, ab = m[:, q_lo:q_hi], l[:, q_lo:q_hi], acc[:, q_lo:q_hi]
        for k_lo in range(0, skv, blk_k):
            if causal and k_lo > q_lo + blk_q - 1:
                break                      # the kernel's causal block skip
            kb = k[:, k_lo:k_lo + blk_k].float()
            mask = _mask(q_pos, torch.arange(k_lo, k_lo + kb.shape[1],
                                             device=dev),
                         causal=causal, window=window, kv_len=skv)
            s = torch.where(mask[None], torch.matmul(qb, kb.transpose(1, 2)),
                            NEG)
            mb, lb, ab = online_softmax_step(mb, lb, ab, s, mask[None],
                                             v[:, k_lo:k_lo + blk_k].float())
        m[:, q_lo:q_hi], l[:, q_lo:q_hi], acc[:, q_lo:q_hi] = mb, lb, ab
    return acc, m, l


def apply_softcap(x, cap):
    """Attention-logit softcap ``cap * tanh(x / cap)`` (none when ``cap`` is
    falsy)."""
    return cap * torch.tanh(x / cap) if cap else x


def attention_bshd_ref(q, k, v, *, causal: bool, window: Optional[int],
                       softcap: Optional[float], q_offset: int, kv_len: int,
                       block: int = 1024, scale: float = 1.0,
                       return_lse: bool = False):
    """``blockwise_attention``: q (B, Sq, H, D), k/v (B, Skv, Hkv, D|Dv) ->
    (B, Sq, H, Dv) in q's dtype. Query head ``h`` reads KV head
    ``h // (H / Hkv)``; scores and sums in float32. With ``return_lse`` also
    the float32 log-sum-exp (B * H, Sq) of each row's capped scores,
    ``m + log(l)`` (``-inf`` for a row that sees no key)."""
    b, sq, h, d = q.shape
    _, skv, hkv, dv = v.shape
    g = h // hkv
    q = q * scale
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, h, sq), NEG, dtype=torch.float32, device=dev)
    s = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=dev)
    for k_lo in range(0, skv, block):
        kc, vc = k[:, k_lo:k_lo + block], v[:, k_lo:k_lo + block]
        if g > 1:
            kc = kc.repeat_interleave(g, dim=2)       # (b, blk, H, d)
            vc = vc.repeat_interleave(g, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float())
        logits = apply_softcap(logits, softcap)
        mask = _mask(q_pos, k_lo + torch.arange(kc.shape[1], device=dev),
                     causal=causal, window=window, kv_len=kv_len)
        logits = torch.where(mask[None, None], logits, NEG)
        m, s, acc = online_softmax_step(m, s, acc, logits, mask[None, None],
                                        vc.transpose(1, 2))
    out = acc / torch.clamp(s[..., None], min=1e-30)
    out = out.transpose(1, 2).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(s)).reshape(b * h, sq)
    return out


def _group_sum(x, b, blk, hkv, g):
    """(B, blk, H, W) over query heads -> (B, blk, Hkv, W): the sum over
    each KV head's ``g`` query heads, in head order."""
    return x.reshape(b, blk, hkv, g, x.shape[-1]).sum(3) if g > 1 else x


def attention_bshd_bwd_ref(q, k, v, out, lse, d_out, *, causal: bool,
                           window: Optional[int], softcap: Optional[float],
                           kv_len: int, scale: float = 1.0,
                           block: int = 1024):
    """The gradient of :func:`attention_bshd_ref` (``q_offset`` 0) by the
    explicit formulas, one KV block of ``block`` keys at a time, in float32:

    * Delta = rowsum(dO * O);
    * P = exp(S_c - lse), S_c the scaled (and capped) score, 0 where masked;
    * dP = dO V^T; dS = P * (dP - Delta), times 1 - (S_c / cap)^2 under a
      softcap (the derivative of ``cap * tanh(s / cap)``);
    * dQ = scale * dS K, dK = scale * dS^T Q, dV = P^T dO.

    q (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv), out and d_out
    (B, Sq, H, Dv), lse (B * H, Sq) from the forward. Returns (dq, dk, dv)
    in the dtypes of q, k and v. dK and dV sum each KV head's H / Hkv query
    heads. A masked score, or a row that sees no key, contributes exactly
    0."""
    b, sq, h, d = q.shape
    _, skv, hkv, dv = v.shape
    g = h // hkv
    dev = q.device
    qs = (q * scale).float()                       # the forward's scores
    do = d_out.float().transpose(1, 2)             # (B, H, Sq, Dv)
    delta = (d_out.float() * out.float()).sum(-1).transpose(1, 2)
    lse = lse.reshape(b, h, sq)
    q_pos = torch.arange(sq, device=dev)
    dq = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, skv, hkv, d), dtype=torch.float32, device=dev)
    dvv = torch.zeros((b, skv, hkv, dv), dtype=torch.float32, device=dev)
    for k_lo in range(0, skv, block):
        kc, vc = k[:, k_lo:k_lo + block].float(), v[:, k_lo:k_lo + block].float()
        blk = kc.shape[1]
        if g > 1:
            kc = kc.repeat_interleave(g, dim=2)        # (b, blk, H, d)
            vc = vc.repeat_interleave(g, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qs, kc)
        s = apply_softcap(s, softcap)
        mask = _mask(q_pos, k_lo + torch.arange(blk, device=dev),
                     causal=causal, window=window, kv_len=kv_len)[None, None]
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        dp = torch.einsum("bhqe,bkhe->bhqk", do, vc)
        ds = p * (dp - delta[..., None])
        if softcap:
            ds = ds * (1.0 - torch.square(s / softcap))
        dq += torch.einsum("bhqk,bkhd->bhqd", ds, kc)
        dk[:, k_lo:k_lo + blk] = _group_sum(
            torch.einsum("bhqk,bqhd->bkhd", ds, qs), b, blk, hkv, g)
        dvv[:, k_lo:k_lo + blk] = _group_sum(
            torch.einsum("bhqk,bhqe->bkhe", p, do), b, blk, hkv, g)
    dq = (dq * scale).transpose(1, 2)
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)
