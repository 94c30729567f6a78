"""Fan-out neighbour sampler for the ``minibatch_lg`` shape (sampled training).

GraphSAINT-style: sample a k-hop neighbourhood subgraph around ``batch_nodes``
seed nodes with per-hop fan-outs (e.g. 15-10), then train on the induced
subgraph as a small full graph, which the runtime partitions like any other
(so Sylvie's quantized halo exchange applies unchanged).

Sampling is host-side numpy over the graph's CSR: uniform with replacement
per DGL's default, drawn from ``np.random.default_rng(seed)`` in the
reference's order, so for the same graph and seed :meth:`sample` returns
``repro.graph.sampling``'s subgraph array for array. ``SamplerShapes`` gives
the static bounds of a sample (the ``minibatch_lg`` cell's sizes).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .formats import Graph


@dataclasses.dataclass(frozen=True)
class SamplerShapes:
    """Static padded sizes for a (batch_nodes, fanouts) sampler config."""
    batch_nodes: int
    fanouts: tuple[int, ...]

    @property
    def max_nodes(self) -> int:
        n, tot = self.batch_nodes, self.batch_nodes
        for f in self.fanouts:
            n *= f
            tot += n
        return tot

    @property
    def max_edges(self) -> int:
        n, tot = self.batch_nodes, 0
        for f in self.fanouts:
            tot += n * f
            n *= f
        return tot


class NeighborSampler:
    def __init__(self, g: Graph, fanouts=(15, 10), seed: int = 0):
        self.g = g
        self.fanouts = tuple(fanouts)
        self.indptr, self.indices = g.to_csr()
        self.rng = np.random.default_rng(seed)
        self.train_ids = (np.where(g.train_mask)[0] if g.train_mask is not None
                          else np.arange(g.n_nodes))

    def _sample_hop(self, frontier: np.ndarray, fanout: int):
        """Uniform-with-replacement fan-out sample of each frontier node's
        neighbours: ``(src, dst)``, ``fanout`` edges per node that has any."""
        deg = (self.indptr[frontier + 1] - self.indptr[frontier]).astype(
            np.int64)
        has = deg > 0
        f = frontier[has]
        d = deg[has]
        offs = self.rng.integers(0, d[:, None], size=(f.size, fanout))
        nbrs = self.indices[self.indptr[f][:, None] + offs]
        return nbrs.ravel(), np.repeat(f, fanout)

    def sample(self, seeds: np.ndarray | None = None, batch_nodes: int = 1024
               ) -> Graph:
        """A Graph over the sampled subgraph (relabelled, deduplicated edges)
        with ``train_mask`` (and the val / test masks, copies) marking the
        seed nodes: the loss is the seeds'."""
        if seeds is None:
            seeds = self.rng.choice(self.train_ids, size=batch_nodes,
                                    replace=self.train_ids.size < batch_nodes)
        srcs, dsts = [], []
        frontier = np.unique(seeds)
        for f in self.fanouts:
            s, d = self._sample_hop(frontier, f)
            srcs.append(s)
            dsts.append(d)
            frontier = np.unique(s)
        src = np.concatenate(srcs)
        dst = np.concatenate(dsts)
        # dedupe (messages src -> dst; the seeds are hop 1's destinations)
        combo = np.unique(src.astype(np.int64) * self.g.n_nodes + dst)
        src = (combo // self.g.n_nodes).astype(np.int64)
        dst = (combo % self.g.n_nodes).astype(np.int64)
        nodes = np.unique(np.concatenate([seeds, src, dst]))
        relabel = np.full(self.g.n_nodes, -1, dtype=np.int64)
        relabel[nodes] = np.arange(nodes.size)
        ei = np.stack([relabel[src], relabel[dst]]).astype(np.int32)
        tr = np.zeros(nodes.size, dtype=bool)
        tr[relabel[seeds]] = True
        return Graph(
            n_nodes=int(nodes.size), edge_index=ei,
            x=self.g.x[nodes],
            y=None if self.g.y is None else self.g.y[nodes],
            train_mask=tr, val_mask=tr.copy(), test_mask=tr.copy(),
            pos=None if self.g.pos is None else self.g.pos[nodes],
            n_classes=self.g.n_classes)
