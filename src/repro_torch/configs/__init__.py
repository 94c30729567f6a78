"""Architecture registry of the port: ``--arch <id>`` resolution.

It holds the architectures the port runs: the paper's GCN, GraphSAGE and
GAT and the zoo's PNA, MeshGraphNet and SchNet (trained full-graph), and the
GQA + dense-FFN language models (served). granite-3-2b fits one card at
full width in float32; yi-34b is here for its reduced config, which
exercises the untied unembedding. The JAX package's other architectures
(NequIP, DLRM, the MoE and MLA language models) are still to be ported
(ROADMAP queue A, items 11-15).
"""
from __future__ import annotations

from . import (granite_3_2b, meshgraphnet, paper_gnn, pna, schnet,
               yi_34b)
from .base import ArchSpec, ShapeCell  # noqa: F401

REGISTRY: dict[str, ArchSpec] = {
    s.arch_id: s for s in (paper_gnn.GCN_SPEC, paper_gnn.SAGE_SPEC,
                           paper_gnn.GAT_SPEC, pna.SPEC, meshgraphnet.SPEC,
                           schnet.SPEC, granite_3_2b.SPEC, yi_34b.SPEC)
}


def get(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ROADMAP queue A,"
                       f" items 11-15); the port runs {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
