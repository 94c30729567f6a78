"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]: 40L GQA dense LM."""
from ..models.lm.config import AttnConfig, LayerConfig, LMConfig, Segment
from .base import ArchSpec, LM_SHAPES


def config() -> LMConfig:
    attn = AttnConfig(kind="gqa", n_heads=32, n_kv_heads=8, d_head=64,
                      rope_theta=10000.0)
    return LMConfig(
        name="granite-3-2b", d_model=2048, vocab=49155,
        segments=(Segment(40, (LayerConfig(attn, d_ff=8192),)),),
        tie_embeddings=True, max_seq=524288)


def reduced() -> LMConfig:
    attn = AttnConfig(kind="gqa", n_heads=4, n_kv_heads=2, d_head=16)
    return LMConfig(name="granite-3-2b-smoke", d_model=64, vocab=211,
                    segments=(Segment(3, (LayerConfig(attn, d_ff=256),)),),
                    tie_embeddings=True)


SPEC = ArchSpec("granite-3-2b", "lm", "hf:ibm-granite/granite-3.0-2b-base; hf",
                config, reduced, LM_SHAPES)
