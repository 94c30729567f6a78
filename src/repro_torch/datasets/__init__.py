"""repro_torch.datasets — named workloads, normalized and partitioned.

:func:`load_partitioned` is registry load + GCN normalization + partition in
one call, with the same defaults as ``repro.datasets.load_partitioned``
(self-loops, symmetric GCN weights, ``method="block"``, compact ring-bucket
layout, ``alignment=8``), so both packages serve the same partition. It
partitions directly; there is no on-disk plan cache here.
"""
from __future__ import annotations

from ..graph import formats
from ..graph.partition import PartitionedGraph, partition_graph
from . import registry
from .registry import (DEFAULT_TIER, TIERS, TargetStats,  # noqa: F401
                       WorkloadSpec, get, load, names, parse, register)

__all__ = [
    "TIERS", "DEFAULT_TIER", "TargetStats", "WorkloadSpec", "register",
    "names", "get", "parse", "load", "load_partitioned", "registry",
]


def load_partitioned(ref: str, n_parts: int, *, seed: int = 0,
                     method: str = "block", layout: str = "compact",
                     alignment: int = 8, self_loops: bool = True,
                     gcn_weights: bool = True) -> PartitionedGraph:
    """``"name@tier"`` -> partitioned graph::

        pg = load_partitioned("reddit_like@paper", n_parts=4)
    """
    g = load(ref, seed=seed)
    g, ew = formats.gcn_normalize(g, self_loops=self_loops,
                                  gcn_weights=gcn_weights)
    return partition_graph(g, n_parts, method=method, edge_weight=ew,
                           seed=seed, layout=layout, alignment=alignment)
