"""Architecture registry of the port: ``--arch <id>`` resolution.

It holds the architectures the port runs: the paper's GCN, GraphSAGE and
GAT and the zoo's PNA, MeshGraphNet, SchNet and NequIP (trained
full-graph), and every language model of the JAX package (served):
granite-3-2b and yi-34b (GQA, dense FFN), olmoe-1b-7b (MoE FFN),
deepseek-v2-236b (MLA attention and MoE FFN) and gemma2-27b (local and
global layers, softcaps).
granite-3-2b and olmoe-1b-7b fit one card at full config in float32;
yi-34b, deepseek-v2-236b and gemma2-27b only with their depth cut. DLRM
is still to be ported (ROADMAP queue A, item 15).
"""
from __future__ import annotations

from . import (deepseek_v2_236b, gemma2_27b, granite_3_2b, meshgraphnet,
               nequip, olmoe_1b_7b, paper_gnn, pna, schnet, yi_34b)
from .base import ArchSpec, ShapeCell  # noqa: F401

REGISTRY: dict[str, ArchSpec] = {
    s.arch_id: s for s in (paper_gnn.GCN_SPEC, paper_gnn.SAGE_SPEC,
                           paper_gnn.GAT_SPEC, pna.SPEC, meshgraphnet.SPEC,
                           schnet.SPEC, nequip.SPEC, granite_3_2b.SPEC,
                           yi_34b.SPEC, olmoe_1b_7b.SPEC,
                           deepseek_v2_236b.SPEC, gemma2_27b.SPEC)
}


def get(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ROADMAP queue A,"
                       f" item 15: DLRM); the port runs {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
