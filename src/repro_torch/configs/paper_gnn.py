"""The paper's evaluation GCN (Sylvie §4), as ``repro/configs/paper_gnn.py``
defines it: d_hidden 256, 2 layers; the reduced config has d_hidden 16.
GraphSAGE and GAT are not ported yet (ROADMAP queue A item 8)."""
from ..models.gnn.models import GCN
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
