"""yi-34b [arXiv:2403.04652]: llama-architecture 60L GQA dense LM."""
from ..models.lm.config import AttnConfig, LayerConfig, LMConfig, Segment
from .base import ArchSpec, LM_SHAPES


def config() -> LMConfig:
    attn = AttnConfig(kind="gqa", n_heads=56, n_kv_heads=8, d_head=128,
                      rope_theta=5000000.0)
    return LMConfig(
        name="yi-34b", d_model=7168, vocab=64000,
        segments=(Segment(60, (LayerConfig(attn, d_ff=20480),)),),
        tie_embeddings=False, max_seq=524288)


def reduced() -> LMConfig:
    attn = AttnConfig(kind="gqa", n_heads=8, n_kv_heads=2, d_head=8)
    return LMConfig(name="yi-34b-smoke", d_model=64, vocab=199,
                    segments=(Segment(3, (LayerConfig(attn, d_ff=192),)),),
                    tie_embeddings=False)


SPEC = ArchSpec("yi-34b", "lm", "arXiv:2403.04652; hf", config, reduced,
                LM_SHAPES)
