"""Useful FLOPs of one training epoch, by model family: each family's count
is ``bench/flops/<family>.py``'s ``train_flops`` (a frozen copy of the
port's ``launch/cells.py::_gnn_model_flops``), found by name. The count
depends on the cell alone (nodes, edges, widths), never on what implements
it."""
from __future__ import annotations

import importlib
import re

FAMILY = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def gnn_train_flops(family: str, n: int, e: int, d_in: int, d_hidden: int,
                    d_out: int, n_layers: int) -> float:
    if not FAMILY.match(family):
        raise ValueError(f"bad model family {family!r}")
    mod = importlib.import_module(f"bench.flops.{family}")
    return mod.train_flops(n, e, d_in, d_hidden, d_out, n_layers)
