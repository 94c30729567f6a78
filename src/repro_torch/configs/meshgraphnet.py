"""meshgraphnet [arXiv:2010.03409]: 15 processor layers, d=128, sum agg
(``repro/configs/meshgraphnet.py``)."""
from ..models.gnn.models import MeshGraphNet
from .base import GNN_SHAPES, ArchSpec
from .gnn_common import GNNArch


def config() -> GNNArch:
    return GNNArch(
        "meshgraphnet",
        make=lambda d_in, d_out: MeshGraphNet(d_in=d_in, d_out=d_out,
                                              d_hidden=128, n_layers=15,
                                              mlp_layers=2),
        d_edge_attr=13, needs_weights=False)


def reduced() -> GNNArch:
    return GNNArch(
        "meshgraphnet-smoke",
        make=lambda d_in, d_out: MeshGraphNet(d_in=d_in, d_out=d_out,
                                              d_hidden=24, n_layers=3,
                                              mlp_layers=2),
        d_edge_attr=13, needs_weights=False)


SPEC = ArchSpec("meshgraphnet", "gnn", "arXiv:2010.03409; unverified", config,
                reduced, GNN_SHAPES)
