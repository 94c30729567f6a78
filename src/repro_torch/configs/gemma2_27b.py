"""gemma2-27b [arXiv:2408.00118]: alternating local(4096)/global GQA layers,
attention-logit + final-logit softcaps, sandwich (pre+post) norms."""
from ..models.lm.config import AttnConfig, LayerConfig, LMConfig, Segment
from .base import ArchSpec, LM_SHAPES


def config() -> LMConfig:
    common = dict(kind="gqa", n_heads=32, n_kv_heads=16, d_head=128,
                  rope_theta=10000.0, softcap=50.0)
    local = AttnConfig(window=4096, **common)
    glob = AttnConfig(window=None, **common)
    layer = dict(d_ff=36864, post_norm=True, act="gelu")
    return LMConfig(
        name="gemma2-27b", d_model=4608, vocab=256000,
        segments=(Segment(23, (LayerConfig(local, **layer),
                               LayerConfig(glob, **layer))),),
        logit_softcap=30.0, tie_embeddings=True, embed_scale=True,
        max_seq=524288)


def reduced() -> LMConfig:
    common = dict(kind="gqa", n_heads=4, n_kv_heads=2, d_head=16, softcap=50.0)
    local = AttnConfig(window=8, **common)
    glob = AttnConfig(window=None, **common)
    return LMConfig(
        name="gemma2-27b-smoke", d_model=64, vocab=223,
        segments=(Segment(2, (LayerConfig(local, d_ff=192, post_norm=True),
                              LayerConfig(glob, d_ff=192, post_norm=True))),),
        logit_softcap=30.0, tie_embeddings=True, embed_scale=True)


SPEC = ArchSpec("gemma2-27b", "lm", "arXiv:2408.00118; hf", config, reduced,
                LM_SHAPES,
                notes="local layers ring-buffer their KV cache at window=4096")
