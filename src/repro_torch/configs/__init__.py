"""Architecture registry of the port: ``--arch <id>`` resolution.

It holds only the architectures the port runs: the paper's GCN, GraphSAGE
and GAT (trained full-graph) and the GQA + dense-FFN language models
(served). granite-3-2b fits one card at full width in float32; yi-34b is
here for its reduced config, which exercises the untied unembedding. Every
other architecture of the JAX package is still to be ported (ROADMAP queue
A).
"""
from __future__ import annotations

from . import granite_3_2b, paper_gnn, yi_34b
from .base import ArchSpec, ShapeCell  # noqa: F401

REGISTRY: dict[str, ArchSpec] = {
    s.arch_id: s for s in (paper_gnn.GCN_SPEC, paper_gnn.SAGE_SPEC,
                           paper_gnn.GAT_SPEC, granite_3_2b.SPEC, yi_34b.SPEC)
}


def get(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ROADMAP queue A);"
                       f" the port runs {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
