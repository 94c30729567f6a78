"""Transformer LM as functions over a parameter dict.

The port of ``repro/models/lm/model.py``: GQA or MLA attention (RoPE,
decoupled for MLA), a dense gated FFN or a capacity-dispatched MoE FFN,
sliding-window local layers, attention- and final-logit softcaps and
sandwich norms, so every LM of the JAX package (granite-3-2b, yi-34b,
olmoe-1b-7b, deepseek-v2-236b, gemma2-27b). The parameter dict keeps
the JAX tree key for key — ``embed``, ``ln_final``, optional ``unembed``,
``seg{i}/sub{j}/{attn,ffn,ln_attn,ln_ffn}`` with a leading ``count`` axis —
so weights carry across (``repro_torch.models.convert``).

Differences of form, not of function:

* ``lax.scan`` over a segment's ``count`` is a Python loop; ``unroll`` has
  no counterpart (no tracing here). ``remat`` is always on:
  ``torch.utils.checkpoint`` (non-reentrant) around one iteration of a
  segment's body, all its sub-layers, as the reference's
  ``jax.checkpoint(body, nothing_saveable)``; it is active only when a
  gradient is taken (grad enabled and a parameter or the stream requiring
  grad), so serving runs each layer once, as before.
* Prefill attention is ``kernels.flash.ops.attention_bshd``: the CUDA flash
  kernel on the card (one launch per layer, with the softcap and MLA's
  narrower value heads inside it), ``blockwise_attention``'s plain version
  on the CPU. Under a gradient it is ``FlashAttention``, whose backward is
  the two kernels of ``flash_bwd.cu`` on the card (the plain backward on the
  CPU); with remat a training step launches the forward kernel twice per
  layer (forward and recompute) and each backward kernel once. Decode
  attention is plain PyTorch, as in the reference.
* ``make_train_step`` takes the gradient with ``torch.autograd.grad`` and
  updates the parameters and the optimizer's state in place, leaf by leaf
  (``train.optimizer.update_in_place``: the reference's ``optimizer.update``
  and ``apply_updates``, the same bits), where JAX's step returns a new
  state; a full-width model's second copy of parameters and moments would
  not fit the card.
* The MoE dispatch writes each kept assignment into its own slot of the
  capacity buffer (``index_copy_``: a permutation, nothing accumulated);
  the reference's ``segment_sum`` also adds the dropped assignments' zeros
  to slot 0, which changes no value. The buffer is laid out (expert,
  group, slot) rather than (group, expert, slot), so each expert product is
  one ``torch.bmm`` over the experts.
* KV caches are updated in place (the reference's ``dynamic_update_slice``
  returns a new array): ``forward``, the prefill step and the decode step
  write into the caches they are given and return them.
* The prefill step unembeds only the last position it returns, not all of
  them (a row-wise product: the same function, without a (B, S, V) tensor).
* ``ShardCtx`` and its activation constraints are not ported: on one card
  they are identities.

Hazards of the reference kept on purpose, for parity: the prefill step's
caches are bfloat16 even when the parameters are float32, and decode
attention rounds its probabilities to the cache dtype before the value
product (taken in float32).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ...kernels.flash.ops import attention_bshd
from ...kernels.flash.ref import NEG
from ...kernels.flash.ref import apply_softcap as _softcap
from ...train.optimizer import update_in_place
from .config import AttnConfig, LayerConfig, LMConfig, MoEConfig

MOE_GROUP = 8192          # dispatch-group length in token-assignments


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
    """Online-softmax attention. q: (B, Sq, H, D); k: (B, Skv, Hkv, D);
    v: (B, Skv, Hkv, Dv) with Dv <= D -> (B, Sq, H, Dv). The flash kernel on
    a CUDA tensor; on the CPU, the reference's KV-block scan (``block`` keys
    at a time)."""
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

    def normal(self, shape, scale_axis, lead=(), dtype=None):
        x = torch.randn(tuple(lead) + tuple(shape), generator=self.gen,
                        dtype=torch.float32, device=self.device)
        x.mul_(1.0 / np.sqrt(max(1, shape[scale_axis])))
        return x.to(dtype or self.dtype)

    def zeros(self, shape, lead=()):
        return torch.zeros(tuple(lead) + tuple(shape), dtype=self.dtype,
                           device=self.device)


def attn_params(draw: _Draw, cfg: LMConfig, a: AttnConfig, lead=()):
    d = cfg.d_model
    if a.kind == "mla":
        p = {"kv_a": draw.normal((d, a.kv_lora + a.d_rope), 0, lead),
             "kv_norm": draw.zeros((a.kv_lora,), lead),
             "kv_b": draw.normal((a.kv_lora, a.n_heads * (a.d_nope + a.d_v)),
                                 0, lead),
             "wo": draw.normal((a.n_heads * a.d_v, d), 0, lead)}
        if a.q_lora:
            p["q_a"] = draw.normal((d, a.q_lora), 0, lead)
            p["q_norm"] = draw.zeros((a.q_lora,), lead)
            p["q_b"] = draw.normal((a.q_lora, a.q_out), 0, lead)
        else:
            p["wq"] = draw.normal((d, a.q_out), 0, lead)
        return p
    return {"wq": draw.normal((d, a.n_heads * a.d_head), 0, lead),
            "wk": draw.normal((d, a.n_kv_heads * a.d_head), 0, lead),
            "wv": draw.normal((d, a.n_kv_heads * a.d_head), 0, lead),
            "wo": draw.normal((a.n_heads * a.d_head, d), 0, lead)}


def _gated(draw: _Draw, d: int, f: int, lead=()):
    return {"gate": draw.normal((d, f), 0, lead),
            "up": draw.normal((d, f), 0, lead),
            "down": draw.normal((f, d), 0, lead)}


def ffn_params(draw: _Draw, cfg: LMConfig, lc: LayerConfig, lead=()):
    """A dense gated FFN, or an MoE's router (float32 in a model of any
    dtype, as the reference's), experts (E, d, f) / (E, f, d) and shared
    experts."""
    d = cfg.d_model
    m = lc.moe
    if m is None:
        return _gated(draw, d, lc.d_ff, lead)
    p = {"router": draw.normal((d, m.n_experts), 0, lead, torch.float32),
         "e_gate": draw.normal((m.n_experts, d, m.d_ff), 1, lead),
         "e_up": draw.normal((m.n_experts, d, m.d_ff), 1, lead),
         "e_down": draw.normal((m.n_experts, m.d_ff, d), 1, lead)}
    if m.n_shared:
        p["shared"] = _gated(draw, d, m.d_ff_shared, lead)
    return p


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
# MoE dispatch (capacity scatter)
# ---------------------------------------------------------------------------


def _gated_ffn(f, x):
    """Gated SiLU, whatever the layer's ``act`` says (as the reference)."""
    return (torch.nn.functional.silu(x @ f["gate"]) * (x @ f["up"])) \
        @ f["down"]


def moe_route(p, x, m: MoEConfig):
    """x (T, d) -> router probabilities (T, E) float32 and each token's top-k
    experts: weights (T, k) renormalised to sum 1, indices (T, k). The
    router product runs in the stream dtype, the softmax in float32."""
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, -1)
    gate_w, gate_i = torch.topk(probs, m.top_k, dim=-1)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_w, gate_i


def moe_dispatch(gate_i, m: MoEConfig, capacity: Optional[int] = None):
    """The reference's grouped capacity dispatch of the (T, k) choices.

    The T*k assignments, token-major, are cut into groups of
    ``gl = min(MOE_GROUP, T*k)`` (the last padded with expert E - 1, never
    kept); each group gives every expert ``c`` slots, ``int(capacity_factor
    * gl / E + 1)`` unless ``capacity`` is given, and an assignment's slot is
    its rank among the group's assignments to that expert (an exclusive
    cumsum). Ranks at or past ``c`` are dropped. Returns ``keep`` (T*k,) and
    ``dst`` (T*k,): each kept assignment's row of the (E * G * c) buffer,
    laid out (expert, group, slot); a dropped one's is the spare row
    E * G * c. Also ``(n_groups, c)``."""
    e_count = m.n_experts
    n_assign = gate_i.numel()
    gl = min(MOE_GROUP, n_assign)
    ng = (n_assign + gl - 1) // gl
    pad = ng * gl - n_assign
    c = capacity or int(m.capacity_factor * gl / e_count + 1)
    e_flat = gate_i.reshape(-1)
    if pad:
        e_flat = torch.nn.functional.pad(e_flat, (0, pad), value=e_count - 1)
    e_g = e_flat.reshape(ng, gl)
    oh = torch.nn.functional.one_hot(e_g, e_count)          # (G, L, E)
    pos = torch.gather(oh.cumsum(1) - oh, 2, e_g[..., None])[..., 0]
    keep = (pos < c).reshape(-1)[:n_assign]
    group = torch.arange(ng, device=gate_i.device)[:, None]
    dst = (e_g * ng + group) * c + pos
    dst = torch.where(keep, dst.reshape(-1)[:n_assign], e_count * ng * c)
    return keep, dst, (ng, c)


def expert_ffn(p, buf):
    """Each expert's gated SiLU over its slots: buf (E, N, d) -> (E, N, d),
    three batched products over the experts."""
    h = torch.nn.functional.silu(torch.bmm(buf, p["e_gate"])) \
        * torch.bmm(buf, p["e_up"])
    return torch.bmm(h, p["e_down"])


def moe_ffn(p, x, m: MoEConfig, capacity: Optional[int] = None):
    """x (T, d) -> (y (T, d), aux): ``repro``'s ``moe_ffn``. Each kept
    assignment's token row is copied into its slot (``moe_dispatch``; no
    sums, so no float atomics on the card), the experts run over their
    slots, each assignment reads its slot back (zero when dropped), and a
    token's k results are summed with their gate weights (a reshape and a
    sum over k). ``aux`` is the Switch-style load-balance loss, float32;
    the shared experts, if any, add to ``y``."""
    t, d = x.shape
    probs, gate_w, gate_i = moe_route(p, x, m)
    keep, dst, (ng, c) = moe_dispatch(gate_i, m, capacity)
    rows = m.n_experts * ng * c
    x_rep = x.repeat_interleave(m.top_k, dim=0)                # (T*k, d)
    buf = x.new_zeros((rows + 1, d))            # + 1: the dropped ones' row
    buf.index_copy_(0, dst, x_rep)
    out = expert_ffn(p, buf[:rows].view(m.n_experts, ng * c, d))
    back = out.reshape(rows, d)[torch.clamp(dst, max=rows - 1)]
    back = torch.where(keep[:, None], back, 0)
    y = (back * gate_w.reshape(-1, 1).to(back.dtype)).reshape(
        t, m.top_k, d).sum(1)
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(gate_i, m.n_experts).float().sum(1) \
        .mean(0)
    aux = m.n_experts * torch.sum(me * ce)
    if m.n_shared:
        y = y + _gated_ffn(p["shared"], x)
    return y.to(x.dtype), aux


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


def _mla_forward(p, x, a: AttnConfig, cfg: LMConfig, *, positions, kv_len,
                 cache=None, cache_pos=None):
    """MLA: queries from a low-rank (or full) projection, keys and values
    re-expanded from the compressed latent ``ckv`` (B, S, kv_lora + d_rope),
    whose last ``d_rope`` columns are the shared RoPE key. The cache holds
    ``ckv``; decode re-expands all of it, as the reference does. Queries and
    keys are ``d_nope + d_rope`` wide, values ``d_v``."""
    b, s, _ = x.shape
    decode = cache is not None and s == 1
    if a.q_lora:
        q = rms_norm(x @ p["q_a"], p["q_norm"], cfg.norm_eps) @ p["q_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(b, s, a.n_heads, a.d_nope + a.d_rope)
    q_rope = rope(q[..., a.d_nope:], positions, a.rope_theta)
    qf = torch.cat([q[..., :a.d_nope], q_rope], -1)
    ckv_new = x @ p["kv_a"]
    k_rope_new = rope(ckv_new[..., a.kv_lora:][:, :, None, :], positions,
                      a.rope_theta)[:, :, 0, :]
    ckv_new = torch.cat([ckv_new[..., :a.kv_lora], k_rope_new], -1)
    ckv = ckv_new
    if cache is not None:
        cache["ckv"][:, cache_pos:cache_pos + s] = ckv_new
        if decode:
            ckv = cache["ckv"]
    # a bfloat16 cache meets float32 weights: JAX promotes to float32
    wdt = torch.promote_types(ckv.dtype, p["kv_b"].dtype)
    c_lat = rms_norm(ckv[..., :a.kv_lora], p["kv_norm"], cfg.norm_eps)
    kv = (c_lat.to(wdt) @ p["kv_b"].to(wdt)).reshape(
        b, -1, a.n_heads, a.d_nope + a.d_v)
    k_nope, v = kv[..., :a.d_nope], kv[..., a.d_nope:]
    k_rope = ckv[..., None, a.kv_lora:].expand(
        k_nope.shape[:-1] + (a.d_rope,))
    k = torch.cat([k_nope, k_rope.to(wdt)], -1)
    scale = 1.0 / np.sqrt(a.d_nope + a.d_rope)
    if decode:
        o = decode_attention(qf, k, v, softcap=a.softcap, kv_len=kv_len,
                             scale=scale)
    else:
        o = blockwise_attention(qf, k, v, causal=True, window=a.window,
                                softcap=a.softcap, q_offset=0, kv_len=kv_len,
                                scale=scale)
    return o.reshape(b, s, -1) @ p["wo"]


def _attn_forward(p, x, a: AttnConfig, cfg: LMConfig, *, positions, kv_len,
                  cache=None, cache_pos=None):
    """The attention sub-layer's output. ``cache`` (GQA: {"k": (B, S, Hkv,
    D), "v": ...}; MLA: {"ckv": (B, S, kv_lora + d_rope)}) is written in
    place when given."""
    if a.kind == "mla":
        return _mla_forward(p, x, a, cfg, positions=positions, kv_len=kv_len,
                            cache=cache, cache_pos=cache_pos)
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
    """-> (x, the MoE aux loss or 0.0)."""
    dtype = x.dtype
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    h = _attn_forward(p["attn"], h, lc.attn, cfg, positions=positions,
                      kv_len=kv_len, cache=cache, cache_pos=cache_pos)
    if lc.post_norm:
        h = rms_norm(h, p["ln_attn_post"], cfg.norm_eps)
    x = (x + h).to(dtype)
    h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    aux = 0.0
    if lc.moe is not None:
        b, s, d = h.shape
        h2, aux = moe_ffn(p["ffn"], h.reshape(-1, d), lc.moe)
        h = h2.reshape(b, s, d)
    else:
        h = _gated_ffn(p["ffn"], h)
    if lc.post_norm:
        h = rms_norm(h, p["ln_ffn_post"], cfg.norm_eps)
    return (x + h).to(dtype), aux


def _trunk(params, tokens, cfg: LMConfig, *, positions=None, kv_len=None,
           caches=None, cache_pos=None):
    """tokens (B, S) -> (final hidden states (B, S, d) before the last
    norm, the summed MoE aux loss: 0.0 without MoE layers). With a
    gradient to take, each iteration of a segment's body is checkpointed:
    its activations are recomputed in the backward (the reference's
    remat)."""
    s = tokens.shape[1]
    dtype = params["embed"].dtype
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dtype)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if kv_len is None:
        kv_len = s
    total_aux = 0.0
    for si, seg in enumerate(cfg.segments):
        seg_p = params[f"seg{si}"]
        seg_cache = caches[f"seg{si}"] if caches is not None else None
        for i in range(seg.count):
            p_i = index_layer(seg_p, i)
            cache_i = None if seg_cache is None else index_layer(seg_cache, i)

            def body(x, p_i=p_i, cache_i=cache_i, seg=seg):
                aux_i = 0.0
                for li, lc in enumerate(seg.layers):
                    x, aux = _sub_layer(
                        p_i[f"sub{li}"], x, lc, cfg, positions=positions,
                        kv_len=kv_len,
                        cache=None if cache_i is None else cache_i[f"sub{li}"],
                        cache_pos=cache_pos)
                    aux_i = aux_i + aux
                return x, aux_i
            if torch.is_grad_enabled() and (x.requires_grad or any(
                    t.requires_grad for _, t in tree_leaves(p_i))):
                x, aux_i = checkpoint(body, x, use_reentrant=False)
            else:
                x, aux_i = body(x)
            total_aux = total_aux + aux_i
    return x, total_aux


def _logits(params, x, cfg: LMConfig):
    x = rms_norm(x, params["ln_final"], cfg.norm_eps)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = x @ unembed
    if cfg.vocab_padded != cfg.vocab:
        logits = logits[..., :cfg.vocab]             # drop padded entries
    return _softcap(logits.float(), cfg.logit_softcap)


def forward(params, tokens, cfg: LMConfig, *, positions=None, kv_len=None,
            caches=None, cache_pos=None):
    """tokens (B, S) -> (logits (B, S, V) float32, aux, caches). ``aux`` is
    the MoE layers' summed load-balance loss (a float32 scalar tensor; 0.0
    without MoE layers). ``caches``: per-segment dicts with a leading
    ``count`` axis, filled or updated in place and returned (``None`` when
    not given)."""
    x, aux = _trunk(params, tokens, cfg, positions=positions, kv_len=kv_len,
                    caches=caches, cache_pos=cache_pos)
    return _logits(params, x, cfg), aux, caches


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def lm_loss(params, tokens, labels, cfg: LMConfig):
    """The reference's ``lm_loss``: mean cross-entropy of ``labels`` under
    the logits over the real vocab (the padded entries are cut by
    ``forward``), plus ``0.01 * aux``, the MoE layers' load-balance loss. A
    float32 scalar."""
    logits, aux, _ = forward(params, tokens, cfg)
    logz = torch.logsumexp(logits, -1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - ll).mean() + 0.01 * aux


def make_train_step(cfg: LMConfig, optimizer):
    """``train_step(state, tokens, labels) -> (state, loss)`` with ``state =
    (params, opt_state, step)``, as the reference's: the loss and its
    gradient with respect to every parameter leaf (``torch.autograd.grad``),
    then ``optimizer.update`` and ``apply_updates``, leaf by leaf and in
    place (``update_in_place``): the parameters and the optimizer's state
    that ``state`` holds are updated, and returned with ``step + 1``. The
    loss is detached."""
    def train_step(state, tokens, labels):
        params, opt_state, step = state
        loss, grads = loss_and_grads(params, tokens, labels, cfg)
        update_in_place(optimizer, grads, opt_state, params)
        return (params, opt_state, step + 1), loss
    return train_step


def loss_and_grads(params, tokens, labels, cfg: LMConfig):
    """``lm_loss`` (detached) and its gradient with respect to every leaf
    of ``params``, a dict shaped as ``params``, by ``torch.autograd.grad``.
    The leaves require grad only while it runs."""
    leaves = [t for _, t in tree_leaves(params)]
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss = lm_loss(params, tokens, labels, cfg)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
    return loss.detach(), _tree_like(params, iter(grads))


def _tree_like(tree: dict, values):
    """A dict shaped as ``tree`` whose leaves are taken from ``values`` in
    ``tree_leaves`` order."""
    return {k: _tree_like(v, values) if isinstance(v, dict) else next(values)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# cache construction and serve steps
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, seq: int, dtype=torch.bfloat16,
               device=None):
    """Per-segment stacked KV caches (MLA: the compressed latent ``ckv``).
    Local (windowed) layers ring-buffer at ``window`` instead of ``seq``."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    caches = {}
    for si, seg in enumerate(cfg.segments):
        sub = {}
        for li, lc in enumerate(seg.layers):
            a = lc.attn
            s_eff = min(seq, a.window) if a.window else seq
            if a.kind == "mla":
                sub[f"sub{li}"] = {"ckv": zeros(seg.count, batch, s_eff,
                                                a.kv_lora + a.d_rope)}
            else:
                shape = (seg.count, batch, s_eff, a.n_kv_heads, a.d_head)
                sub[f"sub{li}"] = {"k": zeros(*shape), "v": zeros(*shape)}
        caches[f"seg{si}"] = sub
    return caches


def make_prefill_step(cfg: LMConfig, batch: int, seq: int):
    def prefill(params, tokens):
        """tokens (batch, seq) -> (last-position logits (batch, V), caches).
        The caches are bfloat16, as the reference's default."""
        caches = init_cache(cfg, batch, seq, device=tokens.device)
        x, _ = _trunk(params, tokens, cfg, caches=caches, cache_pos=0,
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
