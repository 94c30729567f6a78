"""repro_torch.api — the one-import facade of the port, as ``repro.api``
(limited to what is ported: partitioning, full-graph training of GCN /
GraphSAGE / GAT and PNA / MeshGraphNet / SchNet, and the embedding store's
names). MeshGraphNet and SchNet read edge geometry: partition a graph that
carries ``edge_attr`` (``models.gnn.blocks.geometry_edge_attr``), as
``launch.train.gnn_graph`` does.

    import repro_torch.api as repro
    from repro_torch import datasets

    g = datasets.load("yelp_like@small")
    runtime = repro.Runtime.simulated(4)          # the CUDA card
    pg = repro.partition(g, runtime=runtime)
    trainer = repro.train(model, pg, mode="sync", bits=1, runtime=runtime,
                          epochs=40)
    print(trainer.evaluate("test"))

``Runtime.simulated(4, device="cpu")`` (or ``device="cpu"``) runs the
kernels' plain PyTorch versions on the CPU; without a card the default
raises. Inside each of P processes of ``dist.spawn.spawn`` the same calls
with ``runtime=repro.Runtime.sharded(P)`` train one partition per process
and compute what the simulated runtime computes.
"""
from __future__ import annotations

from typing import Optional

from . import datasets  # noqa: F401
from .core.sylvie import SylvieConfig
from .dist.runtime import Runtime
from .graph import formats
from .graph import partition as partlib
from .policy import (AdaQPVariance, BoundedStaleness, Chain,  # noqa: F401
                     CommPolicy, EpochDecision, SiteDecision, SiteStats,
                     Telemetry, Uniform, Warmup)
from .store import (LRUCache, Mutation, MutationStream,  # noqa: F401
                    ShardedEmbeddingStore, StoreBackend, StoreStats)
from .train.trainer import GNNTrainer


def partition(g: formats.Graph, n_parts: Optional[int] = None, *,
              runtime: Optional[Runtime] = None, method: str = "block",
              self_loops: bool = True, gcn_weights: bool = True,
              seed: int = 0, layout: str = "compact",
              alignment: int = 8) -> partlib.PartitionedGraph:
    """Partition a host graph and build its static halo-exchange plan,
    GCN-normalized by default (self-loops, symmetric edge weights).
    ``n_parts`` may come from ``runtime`` (a sharded one's: its processes;
    each builds the same whole plan, and its trainer keeps its partition)."""
    if n_parts is None and runtime is not None:
        n_parts = runtime.n_parts
    if n_parts is None:
        raise ValueError("pass n_parts or a runtime that fixes it")
    g, ew = formats.gcn_normalize(g, self_loops=self_loops,
                                  gcn_weights=gcn_weights)
    return partlib.partition_graph(g, n_parts, method=method,
                                   edge_weight=ew, seed=seed,
                                   layout=layout, alignment=alignment)


def train(model, pg: partlib.PartitionedGraph,
          cfg: Optional[SylvieConfig] = None, *,
          policy: Optional[CommPolicy] = None,
          runtime: Optional[Runtime] = None, device=None, epochs: int = 0,
          opt=None, seed: int = 0, ckpt_dir: Optional[str] = None,
          params=None, **cfg_kw) -> GNNTrainer:
    """Build a :class:`GNNTrainer` (and run ``epochs`` of training).

    Pass a :class:`SylvieConfig` as ``cfg`` or its fields as keywords
    (``mode="async"``, ``bits=1``, ...); ``policy`` decides the per-site,
    per-epoch schedule (default: ``Uniform`` from the config)::

        tr = repro.train(model, pg, mode="async", bits=1, epochs=40,
                         policy=repro.BoundedStaleness(eps_s=4))
    """
    if cfg is None:
        cfg = SylvieConfig(**cfg_kw)
    elif cfg_kw:
        raise TypeError(f"pass cfg or config keywords, not both: {cfg_kw}")
    trainer = GNNTrainer(model, pg, cfg, opt=opt, policy=policy,
                         runtime=runtime, device=device, seed=seed,
                         ckpt_dir=ckpt_dir, params=params)
    if epochs:
        trainer.fit(epochs)
    return trainer
