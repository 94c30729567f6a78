"""nequip [arXiv:2101.03164]: E(3)-equivariant, 5 layers, mul=32, l_max=2,
8 RBF, cutoff 5 (``repro/configs/nequip.py``)."""
from ..models.gnn.nequip import NequIP
from .base import GNN_SHAPES, ArchSpec
from .gnn_common import GNNArch


def config() -> GNNArch:
    return GNNArch(
        "nequip",
        make=lambda d_in, d_out: NequIP(d_in=d_in, d_out=d_out, mul=32,
                                        n_layers=5, l_max=2, n_rbf=8,
                                        cutoff=5.0),
        d_edge_attr=13, needs_weights=False)


def reduced() -> GNNArch:
    return GNNArch(
        "nequip-smoke",
        make=lambda d_in, d_out: NequIP(d_in=d_in, d_out=d_out, mul=4,
                                        n_layers=2, l_max=2, n_rbf=4,
                                        cutoff=3.0),
        d_edge_attr=13, needs_weights=False)


SPEC = ArchSpec("nequip", "gnn", "arXiv:2101.03164; paper", config, reduced,
                GNN_SHAPES,
                notes="halo wire format = flat irrep features (32x0e+32x1o+32x2e)")
