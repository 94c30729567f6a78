"""pna [arXiv:2004.05718]: 4 layers, d=75, mean/max/min/std aggregators,
identity/amplification/attenuation scalers (``repro/configs/pna.py``)."""
from ..models.gnn.models import PNA
from .base import GNN_SHAPES, ArchSpec
from .gnn_common import GNNArch


def config() -> GNNArch:
    return GNNArch(
        "pna",
        make=lambda d_in, d_out: PNA(d_in=d_in, d_out=d_out, d_hidden=75,
                                     n_layers=4),
        d_edge_attr=0, needs_weights=False)


def reduced() -> GNNArch:
    return GNNArch(
        "pna-smoke",
        make=lambda d_in, d_out: PNA(d_in=d_in, d_out=d_out, d_hidden=16,
                                     n_layers=2),
        d_edge_attr=0, needs_weights=False)


SPEC = ArchSpec("pna", "gnn", "arXiv:2004.05718; paper", config, reduced,
                GNN_SHAPES)
