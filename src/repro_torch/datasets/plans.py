"""On-disk partition-plan cache, as ``repro.datasets.plans``.

``partition_graph`` is host numpy and rebuilds the same
:class:`~repro_torch.graph.partition.PartitionedGraph` for the same inputs
every run; at ``paper``-tier sizes that is seconds of start-up that the
scenario runner, the chaos harness's worker processes and the serving
launcher pay again and again. This module caches the *whole* partitioned
graph (plan + scattered node/edge arrays) as one ``.npz`` under
``artifacts/torch/plans/`` — the port's own directory, never the JAX
package's ``artifacts/plans/``.

Cache key (the **invalidation rule**, DESIGN.md §9): a sha256 over

* a format-version tag (bump :data:`CACHE_VERSION` whenever the serialized
  layout or ``partition_graph``'s output for the same inputs changes),
* the full graph content — ``edge_index``, features, labels, masks,
  positions, edge attributes, edge weights (dtype + shape + bytes each), and
* every partition parameter — ``n_parts``, ``method``, ``seed``, ``layout``,
  ``alignment``.

Any change to any of these is a different key, i.e. a miss; entries are never
mutated in place, and the directory can be deleted at any time. The key is
the reference's, byte for byte, so the two packages name one partition
alike (an entry's file format is the same too).

    from repro_torch.datasets import plans
    pg, hit = plans.cached_partition(g, n_parts=8)      # miss: partitions+saves
    pg, hit = plans.cached_partition(g, n_parts=8)      # hit: loads the .npz

Under a process group (``group=``, one process per partition: a sharded
runtime) rank 0 alone loads or writes the entry while the others wait at a
barrier, then they load it: no two processes race on one file, and every
rank reports ``hit`` as rank 0 saw it.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from ..graph.formats import Graph
from ..graph.partition import HaloPlan, PartitionedGraph, partition_graph

# Bump on any change to the serialization below or to partition_graph's
# output for identical inputs — old entries then simply stop being referenced.
CACHE_VERSION = 1


def default_cache_dir() -> Path:
    """``<repo>/artifacts/torch/plans``."""
    return Path(__file__).resolve().parents[3] / "artifacts" / "torch" \
        / "plans"


def _hash_array(h, label: str, arr: Optional[np.ndarray]) -> None:
    h.update(label.encode())
    if arr is None:
        h.update(b"<none>")
        return
    a = np.ascontiguousarray(arr)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())


def plan_key(g: Graph, n_parts: int, *, method: str = "block", seed: int = 0,
             layout: str = "compact", alignment: int = 8,
             edge_weight: Optional[np.ndarray] = None) -> str:
    """Content hash of (graph, partition parameters) — the cache key."""
    h = hashlib.sha256()
    h.update(f"v{CACHE_VERSION};n={g.n_nodes};cls={g.n_classes};"
             f"parts={n_parts};method={method};seed={seed};"
             f"layout={layout};align={alignment}".encode())
    for label, arr in (("ei", g.edge_index), ("x", g.x), ("y", g.y),
                       ("tr", g.train_mask), ("va", g.val_mask),
                       ("te", g.test_mask), ("pos", g.pos),
                       ("ea", g.edge_attr), ("ew", edge_weight)):
        _hash_array(h, label, arr)
    return h.hexdigest()[:32]


# -- (de)serialization -------------------------------------------------------

_PLAN_INTS = ("n_parts", "n_local", "h_pad", "alignment")
_PLAN_ARRS = ("send_idx", "send_mask", "recv_mask", "bucket_sizes",
              "pair_counts")
_PG_ARRS = ("part_of", "global_ids", "node_mask", "x", "y", "train_mask",
            "val_mask", "test_mask", "edges", "edge_mask", "edge_weight",
            "pos", "edge_attr")


def save_partitioned(path: Path, pg: PartitionedGraph) -> None:
    """Serialize a PartitionedGraph (plan included) to one ``.npz``."""
    arrays: dict = {}
    meta = {"version": CACHE_VERSION, "layout": pg.plan.layout,
            "n_classes": pg.n_classes,
            **{k: int(getattr(pg.plan, k)) for k in _PLAN_INTS}}
    for k in _PLAN_ARRS:
        v = getattr(pg.plan, k)
        if v is not None:
            arrays[f"plan__{k}"] = v
    for k in _PG_ARRS:
        v = getattr(pg, k)
        if v is not None:
            arrays[f"pg__{k}"] = v
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    # write-then-rename with a per-writer temp file: concurrent same-key
    # writers each publish a complete entry; readers never see partial bytes
    fd, tmp = tempfile.mkstemp(suffix=".tmp.npz", dir=path.parent)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_partitioned_file(path: Path) -> PartitionedGraph:
    """Inverse of :func:`save_partitioned`."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        plan_kw = {k: meta[k] for k in _PLAN_INTS}
        for k in _PLAN_ARRS:
            plan_kw[k] = z[f"plan__{k}"] if f"plan__{k}" in z else None
        plan = HaloPlan(layout=meta["layout"], **plan_kw)
        pg_kw = {k: (z[f"pg__{k}"] if f"pg__{k}" in z else None)
                 for k in _PG_ARRS}
    return PartitionedGraph(plan=plan, n_classes=meta["n_classes"], **pg_kw)


# -- the cached entry point --------------------------------------------------

def cached_partition(g: Graph, n_parts: int, *, method: str = "block",
                     edge_weight: Optional[np.ndarray] = None, seed: int = 0,
                     layout: str = "compact", alignment: int = 8,
                     cache_dir: Optional[Path] = None,
                     refresh: bool = False, group=None
                     ) -> tuple[PartitionedGraph, bool]:
    """``partition_graph`` behind the on-disk cache.

    Returns ``(pg, hit)`` — ``hit`` is True when the entry was loaded from
    disk. ``refresh=True`` forces a repartition (and rewrites the entry). A
    corrupt or unreadable entry is treated as a miss and overwritten.
    ``group``: a ``torch.distributed`` process group whose ranks all call
    this (see the module docstring); ``None`` for one process."""
    cache_dir = Path(cache_dir) if cache_dir is not None else \
        default_cache_dir()
    key = plan_key(g, n_parts, method=method, seed=seed, layout=layout,
                   alignment=alignment, edge_weight=edge_weight)
    path = cache_dir / f"{key}.npz"
    if group is not None:
        import torch.distributed as dist
        seen = [None]
        if dist.get_rank(group) == 0:
            pg, seen[0] = _cached(g, n_parts, path, refresh, method=method,
                                  edge_weight=edge_weight, seed=seed,
                                  layout=layout, alignment=alignment)
        dist.barrier(group=group)
        dist.broadcast_object_list(seen, group=group,
                                   group_src=0)
        if dist.get_rank(group) != 0:
            pg = load_partitioned_file(path)
        return pg, bool(seen[0])
    return _cached(g, n_parts, path, refresh, method=method,
                   edge_weight=edge_weight, seed=seed, layout=layout,
                   alignment=alignment)


def _cached(g: Graph, n_parts: int, path: Path, refresh: bool, **kw
            ) -> tuple[PartitionedGraph, bool]:
    """Load ``path``, or partition and write it."""
    if not refresh and path.exists():
        try:
            return load_partitioned_file(path), True
        except (OSError, ValueError, KeyError, EOFError):
            pass                        # fall through: repartition + rewrite
    pg = partition_graph(g, n_parts, **kw)
    save_partitioned(path, pg)
    return pg, False
