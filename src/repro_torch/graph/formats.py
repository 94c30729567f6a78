"""Graph container and the GCN pre-partition normalization (numpy).

Messages flow src -> dst; undirected graphs store both directions. The
partitioner (``partition.py``) turns a :class:`Graph` into static, padded
per-partition arrays; the device side never sees this container.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """Host-side (numpy) graph. ``edge_index[0]=src, edge_index[1]=dst``."""

    n_nodes: int
    edge_index: np.ndarray                 # (2, E) int32
    x: np.ndarray                          # (N, d) float32 node features
    y: Optional[np.ndarray] = None         # (N,) int32 labels
    train_mask: Optional[np.ndarray] = None
    val_mask: Optional[np.ndarray] = None
    test_mask: Optional[np.ndarray] = None
    pos: Optional[np.ndarray] = None       # (N, 3) positions
    edge_attr: Optional[np.ndarray] = None  # (E, d_e)
    n_classes: int = 0


def add_self_loops(edge_index: np.ndarray, n_nodes: int) -> np.ndarray:
    loop = np.arange(n_nodes, dtype=edge_index.dtype)
    return np.concatenate([edge_index, np.stack([loop, loop])], axis=1)


def gcn_edge_weights(edge_index: np.ndarray, n_nodes: int) -> np.ndarray:
    """Symmetric-normalized weights  w_uv = 1/sqrt((d_u+1)(d_v+1))  for A+I rows
    (the paper's  D^{-1/2}(A+I)D^{-1/2}, Alg. 1 line 15). Self loops must
    already be present in ``edge_index``."""
    deg = np.bincount(edge_index[1], minlength=n_nodes).astype(np.float64)
    inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    return (inv_sqrt[edge_index[0]] * inv_sqrt[edge_index[1]]).astype(np.float32)


def gcn_normalize(g: Graph, *, self_loops: bool = True,
                  gcn_weights: bool = True):
    """Append self-loops (zero attribute rows for graphs with ``edge_attr``)
    and attach symmetric-normalized weights. Returns ``(graph, edge_weight)``."""
    ei, ea = g.edge_index, g.edge_attr
    if self_loops:
        n_before = ei.shape[1]
        ei = add_self_loops(ei, g.n_nodes)
        if ea is not None:
            pad = np.zeros((ei.shape[1] - n_before, ea.shape[1]), ea.dtype)
            ea = np.concatenate([ea, pad], axis=0)
    ew = gcn_edge_weights(ei, g.n_nodes) if gcn_weights else None
    return dataclasses.replace(g, edge_index=ei, edge_attr=ea), ew
