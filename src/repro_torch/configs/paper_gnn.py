"""The paper's evaluation models (Sylvie §4), as ``repro/configs/paper_gnn.py``
defines them: GCN and GraphSAGE with d_hidden 256, GAT with 4 heads of 64,
each 2 layers; the reduced configs have d_hidden 16."""
from ..models.gnn.models import GAT, GCN, GraphSAGE
from .base import GNN_SHAPES, ArchSpec
from .gnn_common import GNNArch


def _make(name, ctor, **kw):
    def config() -> GNNArch:
        return GNNArch(name, make=lambda d_in, d_out: ctor(
            d_in=d_in, d_out=d_out, **kw))

    def reduced() -> GNNArch:
        small = dict(kw)
        small["d_hidden"] = 16
        small["n_layers"] = 2
        return GNNArch(name + "-smoke", make=lambda d_in, d_out: ctor(
            d_in=d_in, d_out=d_out, **small))

    return ArchSpec(name, "gnn", "paper (Sylvie §4)", config, reduced,
                    GNN_SHAPES)


GCN_SPEC = _make("gcn", GCN, d_hidden=256, n_layers=2)
SAGE_SPEC = _make("graphsage", GraphSAGE, d_hidden=256, n_layers=2)
GAT_SPEC = _make("gat", GAT, d_hidden=64, n_layers=2, heads=4)
