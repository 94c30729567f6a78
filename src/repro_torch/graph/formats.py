"""Graph container, its CSR, the GCN pre-partition normalization and the
padding helpers (numpy).

Messages flow src -> dst; undirected graphs store both directions. The
partitioner (``partition.py``) turns a :class:`Graph` into static, padded
per-partition arrays; the device side never sees this container.
:func:`gcn_normalize` times itself into the gauge ``setup.normalize_s``
(``repro_torch.obs``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .. import obs


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

    @property
    def n_edges(self) -> int:
        return int(self.edge_index.shape[1])

    def degrees(self, kind: str = "in") -> np.ndarray:
        idx = self.edge_index[1] if kind == "in" else self.edge_index[0]
        return np.bincount(idx, minlength=self.n_nodes).astype(np.int64)

    def to_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """(indptr int64, indices int32) over the *outgoing* edges of each
        node (src -> its dsts), in edge-list order within a node."""
        order = np.argsort(self.edge_index[0], kind="stable")
        src = self.edge_index[0][order]
        dst = self.edge_index[1][order]
        counts = np.bincount(src, minlength=self.n_nodes)
        indptr = np.zeros(self.n_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return indptr, dst.astype(np.int32)


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


@obs.timed("setup.normalize_s")
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


def mean_edge_weights(edge_index: np.ndarray, n_nodes: int) -> np.ndarray:
    """1/deg_in(dst) weights — mean aggregation as edge weights (GraphSAGE-mean)."""
    deg = np.bincount(edge_index[1], minlength=n_nodes).astype(np.float64)
    w = 1.0 / np.maximum(deg, 1.0)
    return w[edge_index[1]].astype(np.float32)


def pad_edges(edge_index: np.ndarray, e_pad: int, fill_node: int = 0,
              extra: Optional[np.ndarray] = None):
    """Pad a (2, E) edge list to (2, e_pad) + mask. Padded edges point at
    ``fill_node`` with mask 0; ``extra`` (per-edge rows) is padded with
    zeros and returned third."""
    e = edge_index.shape[1]
    if e > e_pad:
        raise ValueError(f"{e} edges do not fit e_pad {e_pad}")
    mask = np.zeros(e_pad, dtype=bool)
    mask[:e] = True
    out = np.full((2, e_pad), fill_node, dtype=np.int32)
    out[:, :e] = edge_index
    if extra is not None:
        ex = np.zeros((e_pad,) + extra.shape[1:], dtype=extra.dtype)
        ex[:e] = extra
        return out, mask, ex
    return out, mask


def pad_to(arr: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    """``arr`` zero-padded along ``axis`` to length ``n``."""
    pad = n - arr.shape[axis]
    if pad < 0:
        raise ValueError(f"length {arr.shape[axis]} exceeds {n}")
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)
