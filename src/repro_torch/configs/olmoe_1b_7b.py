"""olmoe-1b-7b [arXiv:2409.02060]: 16L GQA + 64-expert top-8 MoE."""
from ..models.lm.config import (AttnConfig, LayerConfig, LMConfig, MoEConfig,
                                Segment)
from .base import ArchSpec, LM_SHAPES


def config() -> LMConfig:
    attn = AttnConfig(kind="gqa", n_heads=16, n_kv_heads=16, d_head=128,
                      rope_theta=10000.0)
    moe = MoEConfig(n_experts=64, top_k=8, d_ff=1024)
    return LMConfig(
        name="olmoe-1b-7b", d_model=2048, vocab=50304,
        segments=(Segment(16, (LayerConfig(attn, moe=moe),)),),
        tie_embeddings=False, max_seq=524288)


def reduced() -> LMConfig:
    attn = AttnConfig(kind="gqa", n_heads=4, n_kv_heads=4, d_head=16)
    moe = MoEConfig(n_experts=8, top_k=2, d_ff=96)
    return LMConfig(name="olmoe-smoke", d_model=64, vocab=173,
                    segments=(Segment(2, (LayerConfig(attn, moe=moe),)),),
                    tie_embeddings=False)


SPEC = ArchSpec("olmoe-1b-7b", "lm", "arXiv:2409.02060; hf", config, reduced,
                LM_SHAPES, notes="expert-parallel over the model axis")
