"""schnet [arXiv:1706.08566]: 3 interactions, d=64, 300 RBF, cutoff 10
(``repro/configs/schnet.py``)."""
from ..models.gnn.models import SchNet
from .base import GNN_SHAPES, ArchSpec
from .gnn_common import GNNArch


def config() -> GNNArch:
    return GNNArch(
        "schnet",
        make=lambda d_in, d_out: SchNet(d_in=d_in, d_out=d_out, d_hidden=64,
                                        n_interactions=3, n_rbf=300,
                                        cutoff=10.0),
        d_edge_attr=13, needs_weights=False)


def reduced() -> GNNArch:
    return GNNArch(
        "schnet-smoke",
        make=lambda d_in, d_out: SchNet(d_in=d_in, d_out=d_out, d_hidden=16,
                                        n_interactions=2, n_rbf=8, cutoff=3.0),
        d_edge_attr=13, needs_weights=False)


SPEC = ArchSpec("schnet", "gnn", "arXiv:1706.08566; paper", config, reduced,
                GNN_SHAPES)
