"""deepseek-v2-236b [arXiv:2405.04434]: MLA (kv_lora 512, decoupled RoPE 64) +
2-shared/160-routed top-6 MoE; first layer dense (d_ff 12288)."""
from ..models.lm.config import (AttnConfig, LayerConfig, LMConfig, MoEConfig,
                                Segment)
from .base import ArchSpec, LM_SHAPES


def config() -> LMConfig:
    mla = AttnConfig(kind="mla", n_heads=128, n_kv_heads=128,
                     rope_theta=10000.0, q_lora=1536, kv_lora=512,
                     d_rope=64, d_nope=128, d_v=128)
    moe = MoEConfig(n_experts=160, top_k=6, d_ff=1536,
                    n_shared=2, d_ff_shared=3072)
    return LMConfig(
        name="deepseek-v2-236b", d_model=5120, vocab=102400,
        segments=(Segment(1, (LayerConfig(mla, d_ff=12288),)),
                  Segment(59, (LayerConfig(mla, moe=moe),))),
        tie_embeddings=False, max_seq=524288)


def reduced() -> LMConfig:
    mla = AttnConfig(kind="mla", n_heads=4, n_kv_heads=4, q_lora=48,
                     kv_lora=32, d_rope=8, d_nope=16, d_v=16)
    moe = MoEConfig(n_experts=8, top_k=2, d_ff=64, n_shared=1, d_ff_shared=96)
    return LMConfig(
        name="deepseek-v2-smoke", d_model=64, vocab=151,
        segments=(Segment(1, (LayerConfig(mla, d_ff=128),)),
                  Segment(2, (LayerConfig(mla, moe=moe),))),
        tie_embeddings=False)


SPEC = ArchSpec("deepseek-v2-236b", "lm", "arXiv:2405.04434; hf", config,
                reduced, LM_SHAPES,
                notes="MLA compressed-latent cache makes long_500k cheapest")
