"""repro_torch.datasets — named workloads + the partition-plan cache.

The registry (:mod:`.registry`) maps a workload name and scale tier to a
seeded synthetic graph; the plan cache (:mod:`.plans`) memoizes
``partition_graph`` on disk under ``artifacts/torch/plans/``.
:func:`load_partitioned` composes the two with the same defaults as
``repro.datasets.load_partitioned`` (self-loops, symmetric GCN weights,
``method="block"``, compact ring-bucket layout, ``alignment=8``), so both
packages serve the same partition::

    pg, hit = load_partitioned("reddit_like@paper", n_parts=4)
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

from ..graph import formats
from . import plans, registry
from .plans import cached_partition, plan_key  # noqa: F401
from .registry import (DEFAULT_TIER, TIERS, TargetStats,  # noqa: F401
                       WorkloadSpec, get, load, names, parse, register)

__all__ = [
    "TIERS", "DEFAULT_TIER", "TargetStats", "WorkloadSpec", "register",
    "names", "get", "parse", "load", "load_partitioned", "cached_partition",
    "plan_key", "plans", "registry",
]


def load_partitioned(ref: str, n_parts: int, *, seed: int = 0,
                     method: str = "block", layout: str = "compact",
                     alignment: int = 8, self_loops: bool = True,
                     gcn_weights: bool = True,
                     cache_dir: Optional[Path] = None, refresh: bool = False):
    """Registry load + GCN normalization + cached partition, in one call.

    Returns ``(pg, hit)`` like :func:`.plans.cached_partition`::

        pg, hit = load_partitioned("yelp_like@small", n_parts=8)
        assert not hit              # first run partitions and saves
        pg, hit = load_partitioned("yelp_like@small", n_parts=8)
        assert hit                  # second run loads artifacts/torch/plans/
    """
    g = load(ref, seed=seed)
    g, ew = formats.gcn_normalize(g, self_loops=self_loops,
                                  gcn_weights=gcn_weights)
    return cached_partition(g, n_parts, method=method, edge_weight=ew,
                            seed=seed, layout=layout, alignment=alignment,
                            cache_dir=cache_dir, refresh=refresh)
