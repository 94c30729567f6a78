"""Config schema shared by the architecture entries (a copy of
``repro/configs/base.py``).

Every ``configs/<id>.py`` exports ``SPEC: ArchSpec`` with the exact published
configuration, a reduced same-family smoke config, and its assigned
input-shape set.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    step: str                      # train | prefill | decode | serve | retrieval
    params: Mapping[str, Any]      # shape-specific sizes (seq_len, batch, ...)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    kind: str                      # "lm" | "gnn" | "recsys"
    source: str                    # citation tag from the assignment
    config: Callable[[], Any]      # full published config
    reduced: Callable[[], Any]     # small same-family config for CPU smoke tests
    shapes: tuple[ShapeCell, ...]
    notes: str = ""

    def shape(self, name: str) -> ShapeCell:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r}")


LM_SHAPES = (
    ShapeCell("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeCell("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeCell("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeCell("long_500k", "decode", dict(seq_len=524288, global_batch=1)),
)

GNN_SHAPES = (
    ShapeCell("full_graph_sm", "train",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
    ShapeCell("minibatch_lg", "train",
              dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                   fanout=(15, 10), d_feat=602)),
    ShapeCell("ogb_products", "train",
              dict(n_nodes=2449029, n_edges=61859140, d_feat=100)),
    ShapeCell("molecule", "train",
              dict(n_nodes=30, n_edges=64, batch=128, d_feat=16)),
)

RECSYS_SHAPES = (
    ShapeCell("train_batch", "train", dict(batch=65536)),
    ShapeCell("serve_p99", "serve", dict(batch=512)),
    ShapeCell("serve_bulk", "serve", dict(batch=262144)),
    ShapeCell("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1000000)),
)
