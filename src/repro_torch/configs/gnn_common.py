"""Shared GNN arch descriptor (a copy of ``repro/configs/gnn_common.py``)."""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class GNNArch:
    name: str
    make: Callable[[int, int], object]   # (d_in, d_out) -> model
    d_edge_attr: int = 0                 # 0 = no geometry
    needs_weights: bool = True           # GCN-normalized A+I edge weights
