"""Architecture registry of the port: ``--arch <id>`` resolution.

It holds every architecture of the JAX package's registry: the paper's
GCN, GraphSAGE and GAT and the zoo's PNA, MeshGraphNet, SchNet and NequIP
(trained full-graph), every language model (granite-3-2b and yi-34b: GQA,
dense FFN; olmoe-1b-7b: MoE FFN; deepseek-v2-236b: MLA attention and MoE
FFN; gemma2-27b: local and global layers, softcaps), and DLRM (MLPerf,
trained, served and ranked). granite-3-2b and olmoe-1b-7b fit one card at
full config in float32; yi-34b, deepseek-v2-236b and gemma2-27b only with
their depth cut, and DLRM only with its tables' rows capped
(``models/recsys/dlrm.py::capped``).
"""
from __future__ import annotations

from . import (deepseek_v2_236b, dlrm_mlperf, gemma2_27b, granite_3_2b,
               meshgraphnet, nequip, olmoe_1b_7b, paper_gnn, pna, schnet,
               yi_34b)
from .base import ArchSpec, ShapeCell  # noqa: F401

REGISTRY: dict[str, ArchSpec] = {
    s.arch_id: s for s in (
        granite_3_2b.SPEC, gemma2_27b.SPEC, yi_34b.SPEC, olmoe_1b_7b.SPEC,
        deepseek_v2_236b.SPEC,
        nequip.SPEC, schnet.SPEC, meshgraphnet.SPEC, pna.SPEC,
        dlrm_mlperf.SPEC,
        paper_gnn.GCN_SPEC, paper_gnn.SAGE_SPEC, paper_gnn.GAT_SPEC,
    )
}

ASSIGNED = ("granite-3-2b", "gemma2-27b", "yi-34b", "olmoe-1b-7b",
            "deepseek-v2-236b", "nequip", "schnet", "meshgraphnet", "pna",
            "dlrm-mlperf")


def get(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
