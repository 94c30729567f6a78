"""Transformer LM (GQA + RoPE, gated FFN) as functions over a parameter dict.

The port of ``repro/models/lm/model.py`` for the architectures with GQA
attention and a dense FFN (granite-3-2b, yi-34b). The parameter dict keeps
the JAX tree key for key — ``embed``, ``ln_final``, optional ``unembed``,
``seg{i}/sub{j}/{attn,ffn,ln_attn,ln_ffn}`` with a leading ``count`` axis —
so weights carry across (``repro_torch.models.convert``).

Differences of form, not of function:

* ``lax.scan`` over a segment's ``count`` is a Python loop; ``remat`` and
  ``unroll`` have no counterpart (no autodiff, no tracing here).
* Prefill attention is ``kernels.flash.ops.attention_bshd``: the CUDA flash
  kernel on the card (one launch per layer), ``blockwise_attention``'s plain
  version on the CPU. Decode attention is plain PyTorch, as in the reference.
* KV caches are updated in place (the reference's ``dynamic_update_slice``
  returns a new array): ``forward``, the prefill step and the decode step
  write into the caches they are given and return them.
* The prefill step unembeds only the last position it returns, not all of
  them (a row-wise product: the same function, without a (B, S, V) tensor).
* ``ShardCtx`` and its activation constraints are not ported: on one card
  they are identities.

The MLA attention and MoE FFN branches raise ``NotImplementedError`` (ROADMAP
queue A).

Hazards of the reference kept on purpose, for parity: the prefill step's
caches are bfloat16 even when the parameters are float32, and decode
attention rounds its probabilities to the cache dtype before the value
product (taken in float32).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ...kernels.flash.ops import attention_bshd
from ...kernels.flash.ref import NEG
from ...kernels.flash.ref import apply_softcap as _softcap
from .config import AttnConfig, LayerConfig, LMConfig

MLA_TODO = "MLA attention is not ported yet (deepseek-v2; ROADMAP queue A)"
MOE_TODO = "the MoE FFN is not ported yet (olmoe, deepseek-v2; ROADMAP queue A)"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def rms_norm(x, gamma, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) \
        * (1.0 + gamma.to(x.dtype))


def rope(x, positions, theta):
    """x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    ang = positions[..., None].float() * freqs                 # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def blockwise_attention(q, k, v, *, causal: bool, window: Optional[int],
                        softcap: Optional[float], q_offset, kv_len: int,
                        block: int = 1024, scale: float = 1.0):
    """Online-softmax attention. q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) ->
    (B, Sq, H, D). The flash kernel on a CUDA tensor; on the CPU, the
    reference's KV-block scan (``block`` keys at a time)."""
    return attention_bshd(q, k, v, causal=causal, window=window,
                          softcap=softcap, q_offset=q_offset, kv_len=kv_len,
                          block=block, scale=scale)


def decode_attention(q, k, v, *, softcap, kv_len, scale: float = 1.0):
    """One-token attention over the full cache. q: (B, 1, H, D);
    k/v: (B, S, Hkv, D|Dv). Positions at or beyond ``kv_len`` are masked.
    Products in float32 (the reference's ``preferred_element_type``); the
    probabilities are rounded to ``v``'s dtype first, as the reference does."""
    b, _, h, d = q.shape
    _, s, hkv, dv = v.shape
    g = h // hkv
    qg = q.reshape(b, hkv, g, d) * scale
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float())
    logits = _softcap(logits, softcap)
    mask = torch.arange(s, device=q.device) < kv_len
    logits = torch.where(mask, logits, NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, 1, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class _Draw:
    """Draws parameters: normal at ``1/sqrt(fan)`` from ``generator`` on its
    device, or zeros; a leading ``lead`` shape stacks layers."""

    def __init__(self, generator: Optional[torch.Generator], dtype,
                 device=None):
        self.gen = generator
        self.dtype = dtype
        self.device = generator.device if generator is not None else device

    def normal(self, shape, scale_axis, lead=()):
        x = torch.randn(tuple(lead) + tuple(shape), generator=self.gen,
                        dtype=torch.float32, device=self.device)
        return x.mul_(1.0 / np.sqrt(max(1, shape[scale_axis]))).to(self.dtype)

    def zeros(self, shape, lead=()):
        return torch.zeros(tuple(lead) + tuple(shape), dtype=self.dtype,
                           device=self.device)


def attn_params(draw: _Draw, cfg: LMConfig, a: AttnConfig, lead=()):
    if a.kind == "mla":
        raise NotImplementedError(MLA_TODO)
    d = cfg.d_model
    return {"wq": draw.normal((d, a.n_heads * a.d_head), 0, lead),
            "wk": draw.normal((d, a.n_kv_heads * a.d_head), 0, lead),
            "wv": draw.normal((d, a.n_kv_heads * a.d_head), 0, lead),
            "wo": draw.normal((a.n_heads * a.d_head, d), 0, lead)}


def ffn_params(draw: _Draw, cfg: LMConfig, lc: LayerConfig, lead=()):
    if lc.moe is not None:
        raise NotImplementedError(MOE_TODO)
    d = cfg.d_model
    return {"gate": draw.normal((d, lc.d_ff), 0, lead),
            "up": draw.normal((d, lc.d_ff), 0, lead),
            "down": draw.normal((lc.d_ff, d), 0, lead)}


def layer_params(draw: _Draw, cfg: LMConfig, lc: LayerConfig, lead=()):
    d = cfg.d_model
    p = {"attn": attn_params(draw, cfg, lc.attn, lead),
         "ffn": ffn_params(draw, cfg, lc, lead),
         "ln_attn": draw.zeros((d,), lead),
         "ln_ffn": draw.zeros((d,), lead)}
    if lc.post_norm:
        p["ln_attn_post"] = draw.zeros((d,), lead)
        p["ln_ffn_post"] = draw.zeros((d,), lead)
    return p


def _build(draw: _Draw, cfg: LMConfig) -> dict:
    params = {"embed": draw.normal((cfg.vocab_padded, cfg.d_model), 1),
              "ln_final": draw.zeros((cfg.d_model,))}
    if not cfg.tie_embeddings:
        params["unembed"] = draw.normal((cfg.d_model, cfg.vocab_padded), 0)
    for si, seg in enumerate(cfg.segments):
        params[f"seg{si}"] = {
            f"sub{li}": layer_params(draw, cfg, lc, lead=(seg.count,))
            for li, lc in enumerate(seg.layers)}
    return params


def init_params(cfg: LMConfig, generator: torch.Generator,
                dtype=torch.bfloat16) -> dict:
    """Stacked per-segment params (``seg{i}`` leaves have a leading ``count``
    axis), drawn from ``generator`` on its device at the reference's scales
    (normal / sqrt(fan-in); norms zero)."""
    return _build(_Draw(generator, dtype), cfg)


def param_shapes(cfg: LMConfig) -> dict:
    """The parameter tree's shapes, with nothing allocated."""
    return tree_map(lambda t: tuple(t.shape),
                    _build(_Draw(None, torch.float32, "meta"), cfg))


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: dict, prefix=()):
    """(path tuple, leaf) for every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def index_layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def project_qkv(p, x, a: AttnConfig, positions):
    """x (B, S, d) -> q (B, S, H, D), k and v (B, S, Hkv, D), RoPE applied."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, a.n_heads, a.d_head)
    k = (x @ p["wk"]).reshape(b, s, a.n_kv_heads, a.d_head)
    v = (x @ p["wv"]).reshape(b, s, a.n_kv_heads, a.d_head)
    return rope(q, positions, a.rope_theta), rope(k, positions, a.rope_theta), v


def _attn_forward(p, x, a: AttnConfig, cfg: LMConfig, *, positions, kv_len,
                  cache=None, cache_pos=None):
    """The attention sub-layer's output. ``cache`` (GQA: {"k": (B, S, Hkv,
    D), "v": ...}) is written in place when given."""
    if a.kind == "mla":
        raise NotImplementedError(MLA_TODO)
    b, s, _ = x.shape
    decode = cache is not None and s == 1
    q, k_new, v_new = project_qkv(p, x, a, positions)
    if cache is not None:
        kc, vc = cache["k"], cache["v"]
        cs = kc.shape[1]
        if decode:
            slot = cache_pos % cs if a.window else cache_pos
            kc[:, slot] = k_new[:, 0]
            vc[:, slot] = v_new[:, 0]
            k, v = kc, vc
        elif s >= cs:
            # prefill overflowing a ring (windowed) cache: keep the last
            # ``cs`` tokens, rotated so token p lands in slot p % cs.
            shift = (cache_pos + s) % cs
            kc.copy_(torch.roll(k_new[:, -cs:], shift, dims=1))
            vc.copy_(torch.roll(v_new[:, -cs:], shift, dims=1))
            k, v = k_new, v_new
        else:
            kc[:, cache_pos:cache_pos + s] = k_new
            vc[:, cache_pos:cache_pos + s] = v_new
            k, v = k_new, v_new
    else:
        k, v = k_new, v_new
    scale = 1.0 / np.sqrt(a.d_head)
    if decode:
        o = decode_attention(q, k, v, softcap=a.softcap,
                             kv_len=min(kv_len, k.shape[1]), scale=scale)
    else:
        o = blockwise_attention(q, k, v, causal=True, window=a.window,
                                softcap=a.softcap, q_offset=0, kv_len=kv_len,
                                scale=scale)
    return o.reshape(b, s, -1) @ p["wo"]


def _sub_layer(p, x, lc: LayerConfig, cfg: LMConfig, *, positions, kv_len,
               cache=None, cache_pos=None):
    dtype = x.dtype
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    h = _attn_forward(p["attn"], h, lc.attn, cfg, positions=positions,
                      kv_len=kv_len, cache=cache, cache_pos=cache_pos)
    if lc.post_norm:
        h = rms_norm(h, p["ln_attn_post"], cfg.norm_eps)
    x = (x + h).to(dtype)
    h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    if lc.moe is not None:
        raise NotImplementedError(MOE_TODO)
    f = p["ffn"]       # gated SiLU, whatever ``lc.act`` says (as the reference)
    h = (torch.nn.functional.silu(h @ f["gate"]) * (h @ f["up"])) @ f["down"]
    if lc.post_norm:
        h = rms_norm(h, p["ln_ffn_post"], cfg.norm_eps)
    return (x + h).to(dtype)


def _trunk(params, tokens, cfg: LMConfig, *, positions=None, kv_len=None,
           caches=None, cache_pos=None):
    """tokens (B, S) -> final hidden states (B, S, d), before the last norm."""
    s = tokens.shape[1]
    dtype = params["embed"].dtype
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dtype)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if kv_len is None:
        kv_len = s
    for si, seg in enumerate(cfg.segments):
        seg_p = params[f"seg{si}"]
        seg_cache = caches[f"seg{si}"] if caches is not None else None
        for i in range(seg.count):
            p_i = index_layer(seg_p, i)
            cache_i = None if seg_cache is None else index_layer(seg_cache, i)
            for li, lc in enumerate(seg.layers):
                x = _sub_layer(
                    p_i[f"sub{li}"], x, lc, cfg, positions=positions,
                    kv_len=kv_len,
                    cache=None if cache_i is None else cache_i[f"sub{li}"],
                    cache_pos=cache_pos)
    return x


def _logits(params, x, cfg: LMConfig):
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = x @ unembed
    if cfg.vocab_padded != cfg.vocab:
        logits = logits[..., :cfg.vocab]             # drop padded entries
    return _softcap(logits.float(), cfg.logit_softcap)


def forward(params, tokens, cfg: LMConfig, *, positions=None, kv_len=None,
            caches=None, cache_pos=None):
    """tokens (B, S) -> (logits (B, S, V) float32, aux 0.0, caches).
    ``caches``: per-segment dicts with a leading ``count`` axis, filled or
    updated in place and returned (``None`` when not given)."""
    x = _trunk(params, tokens, cfg, positions=positions, kv_len=kv_len,
               caches=caches, cache_pos=cache_pos)
    return _logits(params, x, cfg), 0.0, caches


# ---------------------------------------------------------------------------
# cache construction and serve steps
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, seq: int, dtype=torch.bfloat16,
               device=None):
    """Per-segment stacked KV caches. Local (windowed) layers ring-buffer at
    ``window`` instead of ``seq``."""
    caches = {}
    for si, seg in enumerate(cfg.segments):
        sub = {}
        for li, lc in enumerate(seg.layers):
            a = lc.attn
            if a.kind == "mla":
                raise NotImplementedError(MLA_TODO)
            s_eff = min(seq, a.window) if a.window else seq
            shape = (seg.count, batch, s_eff, a.n_kv_heads, a.d_head)
            sub[f"sub{li}"] = {"k": torch.zeros(shape, dtype=dtype,
                                                device=device),
                               "v": torch.zeros(shape, dtype=dtype,
                                                device=device)}
        caches[f"seg{si}"] = sub
    return caches


def make_prefill_step(cfg: LMConfig, batch: int, seq: int):
    def prefill(params, tokens):
        """tokens (batch, seq) -> (last-position logits (batch, V), caches).
        The caches are bfloat16, as the reference's default."""
        caches = init_cache(cfg, batch, seq, device=tokens.device)
        x = _trunk(params, tokens, cfg, caches=caches, cache_pos=0,
                   kv_len=seq)
        return _logits(params, x[:, -1:], cfg)[:, 0], caches
    return prefill


def make_decode_step(cfg: LMConfig):
    def decode(params, caches, token, pos: int):
        """token (B, 1) int; pos the current length. Updates ``caches`` in
        place; returns (logits (B, V), caches)."""
        pos = int(pos)
        logits, _, caches = forward(
            params, token, cfg,
            positions=torch.arange(pos, pos + 1, device=token.device),
            kv_len=pos + 1, caches=caches, cache_pos=pos)
        return logits[:, 0], caches
    return decode
