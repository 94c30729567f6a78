"""LM architecture configs: GQA/MLA attention, dense/MoE FFN, layer segments.

A copy of ``repro/models/lm/config.py`` (it needs no JAX; the port keeps its
own copy rather than import the JAX package). A model is a sequence of
*segments*; each segment scans ``count`` repetitions of a tuple of sub-layer
configs (e.g. Gemma-2 = 23 x (local, global)). The schema expresses every LM
of the JAX package, and the port's model runs each of them
(``repro_torch/configs``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    kind: str = "gqa"                  # "gqa" | "mla"
    n_heads: int = 8
    n_kv_heads: int = 8
    d_head: int = 64
    rope_theta: float = 10000.0
    window: Optional[int] = None       # sliding-window (local) attention
    softcap: Optional[float] = None    # attention-logit softcap (Gemma-2)
    # MLA (DeepSeek-V2):
    q_lora: int = 0
    kv_lora: int = 512
    d_rope: int = 64
    d_nope: int = 128
    d_v: int = 128

    @property
    def q_out(self) -> int:
        if self.kind == "mla":
            return self.n_heads * (self.d_nope + self.d_rope)
        return self.n_heads * self.d_head

    @property
    def kv_cache_width(self) -> int:
        """Per-token KV cache floats (both K and V; MLA = compressed latent)."""
        if self.kind == "mla":
            return self.kv_lora + self.d_rope
        return 2 * self.n_kv_heads * self.d_head


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                          # per-expert hidden
    n_shared: int = 0
    d_ff_shared: int = 0               # total shared-expert hidden
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class LayerConfig:
    attn: AttnConfig
    d_ff: int = 0                      # dense (gated) FFN hidden; 0 if MoE
    moe: Optional[MoEConfig] = None
    post_norm: bool = False            # Gemma-2 pre+post sandwich norms
    act: str = "silu"                  # "silu" | "gelu"


@dataclasses.dataclass(frozen=True)
class Segment:
    count: int
    layers: Tuple[LayerConfig, ...]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    d_model: int
    vocab: int
    segments: Tuple[Segment, ...]
    norm_eps: float = 1e-6
    logit_softcap: Optional[float] = None
    tie_embeddings: bool = True
    embed_scale: bool = False          # Gemma: scale embeddings by sqrt(d)
    max_seq: int = 8192

    @property
    def n_layers(self) -> int:
        return sum(s.count * len(s.layers) for s in self.segments)

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to a multiple of 256 so the vocab axis
        shards evenly over any TP degree <= 256 (logits are sliced back)."""
        return (self.vocab + 255) // 256 * 256

    def sub_layers(self):
        """Yield (segment_idx, layer_cfg, repeat_count) for every sub-layer."""
        for si, seg in enumerate(self.segments):
            for li, lc in enumerate(seg.layers):
                yield si, li, lc, seg.count

    # ---- parameter / FLOP accounting (roofline MODEL_FLOPS) -----------------
    def _attn_params(self, a: AttnConfig) -> int:
        d = self.d_model
        if a.kind == "mla":
            p = 0
            dq = a.q_lora or d
            if a.q_lora:
                p += d * a.q_lora
            p += dq * a.n_heads * (a.d_nope + a.d_rope)      # q up
            p += d * a.kv_lora + d * a.d_rope                # kv down + k_rope
            p += a.kv_lora * a.n_heads * (a.d_nope + a.d_v)  # kv up
            p += a.n_heads * a.d_v * d                       # out
            return p
        return d * a.n_heads * a.d_head + 2 * d * a.n_kv_heads * a.d_head \
            + a.n_heads * a.d_head * d

    def _ffn_params(self, lc: LayerConfig, active_only: bool) -> int:
        d = self.d_model
        if lc.moe is None:
            return 3 * d * lc.d_ff
        m = lc.moe
        n_e = m.top_k if active_only else m.n_experts
        p = n_e * 3 * d * m.d_ff + d * m.n_experts  # experts + router
        if m.n_shared:
            p += 3 * d * m.d_ff_shared
        return p

    def param_count(self, active_only: bool = False) -> int:
        n = self.vocab * self.d_model
        if not self.tie_embeddings:
            n += self.vocab * self.d_model
        for _, _, lc, cnt in self.sub_layers():
            n += cnt * (self._attn_params(lc.attn)
                        + self._ffn_params(lc, active_only)
                        + (4 if lc.post_norm else 2) * self.d_model)
        n += self.d_model
        return n

    def model_flops(self, n_tokens: int) -> float:
        """6 * N_active * D (dense) — the §Roofline 'useful FLOPs' reference."""
        return 6.0 * self.param_count(active_only=True) * n_tokens

    def kv_cache_bytes(self, batch: int, seq: int, dtype_bytes: int = 2) -> int:
        w = sum(cnt * lc.attn.kv_cache_width
                for _, _, lc, cnt in self.sub_layers())
        return batch * seq * w * dtype_bytes
