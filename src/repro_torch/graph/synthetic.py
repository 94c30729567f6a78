"""Seeded synthetic graph generators (numpy, offline).

* ``planted_partition`` — community graph with class-correlated features
  (Yelp-like: moderate degree, homophilous).
* ``powerlaw`` — heavy-tailed in-degrees, random features and labels (the
  sampler's test graph).
* ``powerlaw_community`` — heavy-tailed degrees *and* planted classes
  (Reddit / products / Amazon-like: hubs that skew the per-pair halo counts).
* ``grid_mesh`` — a 2D simulation mesh with world positions (MeshGraphNet).
* ``molecules`` — one random-geometric 3D radius graph (SchNet).

All return :class:`~repro_torch.graph.formats.Graph` with both edge
directions stored, and are pure functions of their kwargs + seed: the same
call gives the same arrays as ``repro.graph.synthetic``.
"""
from __future__ import annotations

import numpy as np

from .formats import Graph


def _split_masks(rng, n, frac=(0.6, 0.2, 0.2)):
    perm = rng.permutation(n)
    a = int(frac[0] * n)
    b = int((frac[0] + frac[1]) * n)
    tr = np.zeros(n, bool)
    va = np.zeros(n, bool)
    te = np.zeros(n, bool)
    tr[perm[:a]] = True
    va[perm[a:b]] = True
    te[perm[b:]] = True
    return tr, va, te


def _undirect(src, dst):
    return (np.concatenate([src, dst]), np.concatenate([dst, src]))


def planted_partition(n_nodes=2708, n_classes=7, d_feat=64, avg_degree=8,
                      p_in=0.9, noise=1.0, seed=0) -> Graph:
    """Stochastic block model with Gaussian class-mean features; ``p_in`` is
    the probability an edge stays inside its community."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    n_edges = n_nodes * avg_degree // 2
    src = rng.integers(0, n_nodes, n_edges)
    intra = rng.random(n_edges) < p_in
    dst = rng.integers(0, n_nodes, n_edges)
    by_class = [np.where(y == c)[0] for c in range(n_classes)]
    same = np.array([by_class[y[s]][rng.integers(0, len(by_class[y[s]]))]
                     for s in src[intra]], dtype=np.int64) \
        if intra.any() else np.array([], np.int64)
    dst = dst.copy()
    dst[intra] = same
    keep = src != dst
    src, dst = src[keep], dst[keep]
    src, dst = _undirect(src, dst)
    means = rng.normal(0, 1, (n_classes, d_feat))
    x = (means[y] + noise * rng.normal(0, 1, (n_nodes, d_feat))).astype(np.float32)
    tr, va, te = _split_masks(rng, n_nodes)
    ei = np.stack([src, dst]).astype(np.int32)
    return Graph(n_nodes, ei, x, y, tr, va, te, n_classes=n_classes)


def powerlaw(n_nodes=10000, avg_degree=16, d_feat=128, n_classes=16,
             seed=0) -> Graph:
    """Preferential-attachment-ish power-law graph (vectorized
    approximation): each node attaches ``avg_degree/2`` edges to targets
    drawn with probability proportional to a Zipf popularity (exponent 0.8)
    over a random node permutation — heavy-tailed in-degree."""
    rng = np.random.default_rng(seed)
    m = max(1, avg_degree // 2)
    pop = (1.0 / (np.arange(1, n_nodes + 1) ** 0.8))
    pop = pop[rng.permutation(n_nodes)]
    pop /= pop.sum()
    src = np.repeat(np.arange(n_nodes), m)
    dst = rng.choice(n_nodes, size=src.size, p=pop)
    keep = src != dst
    src, dst = _undirect(src[keep], dst[keep])
    x = rng.normal(0, 1, (n_nodes, d_feat)).astype(np.float32)
    y = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    tr, va, te = _split_masks(rng, n_nodes)
    return Graph(n_nodes, np.stack([src, dst]).astype(np.int32), x, y, tr, va,
                 te, n_classes=n_classes)


def powerlaw_community(n_nodes=4000, n_classes=16, d_feat=96, avg_degree=16,
                       p_in=0.8, gamma=0.8, noise=1.0, seed=0) -> Graph:
    """Heavy-tailed degrees + planted communities in one graph.

    Each node attaches ``avg_degree/2`` edges; with probability ``p_in`` the
    target is drawn popularity-weighted within the node's own class, else
    popularity-weighted over all nodes (hubs). Popularity is Zipf-like with
    exponent ``gamma`` over a random node permutation."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    pop = 1.0 / (np.arange(1, n_nodes + 1) ** gamma)
    pop = pop[rng.permutation(n_nodes)]
    m = max(1, avg_degree // 2)
    src = np.repeat(np.arange(n_nodes), m)
    intra = rng.random(src.size) < p_in
    dst = rng.choice(n_nodes, size=src.size, p=pop / pop.sum())
    for c in range(n_classes):
        nodes_c = np.where(y == c)[0]
        sel = intra & (y[src] == c)
        if nodes_c.size and sel.any():
            pc = pop[nodes_c] / pop[nodes_c].sum()
            dst[sel] = nodes_c[rng.choice(nodes_c.size, size=int(sel.sum()),
                                          p=pc)]
    keep = src != dst
    src, dst = _undirect(src[keep], dst[keep])
    means = rng.normal(0, 1, (n_classes, d_feat))
    x = (means[y] + noise * rng.normal(0, 1, (n_nodes, d_feat))).astype(
        np.float32)
    tr, va, te = _split_masks(rng, n_nodes)
    return Graph(n_nodes, np.stack([src, dst]).astype(np.int32), x, y,
                 tr, va, te, n_classes=n_classes)


def grid_mesh(nx=32, ny=32, d_feat=16, seed=0) -> Graph:
    """2D grid mesh with diagonal struts and world positions (the
    MeshGraphNet regime)."""
    rng = np.random.default_rng(seed)
    n = nx * ny
    idx = np.arange(n).reshape(nx, ny)
    pairs = [(idx[:-1, :].ravel(), idx[1:, :].ravel()),
             (idx[:, :-1].ravel(), idx[:, 1:].ravel()),
             (idx[:-1, :-1].ravel(), idx[1:, 1:].ravel())]
    src = np.concatenate([p[0] for p in pairs])
    dst = np.concatenate([p[1] for p in pairs])
    src, dst = _undirect(src, dst)
    xs, ys = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny),
                         indexing="ij")
    pos = np.stack([xs.ravel(), ys.ravel(), np.zeros(n)],
                   axis=1).astype(np.float32)
    x = rng.normal(0, 1, (n, d_feat)).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.int32)
    tr, va, te = _split_masks(rng, n)
    return Graph(n, np.stack([src, dst]).astype(np.int32), x, y, tr, va, te,
                 pos=pos, n_classes=4)


def molecules(n_nodes=30, d_feat=16, cutoff=2.0, box=4.0, seed=0) -> Graph:
    """One random-geometric 'molecule': 3D positions in a box, and an edge
    between every two atoms closer than ``cutoff``."""
    rng = np.random.default_rng(seed)
    pos = (rng.random((n_nodes, 3)) * box).astype(np.float32)
    diff = pos[:, None, :] - pos[None, :, :]
    dist = np.sqrt((diff ** 2).sum(-1))
    adj = (dist < cutoff) & ~np.eye(n_nodes, dtype=bool)
    src, dst = np.where(adj)
    x = rng.normal(0, 1, (n_nodes, d_feat)).astype(np.float32)
    y = rng.integers(0, 4, n_nodes).astype(np.int32)
    tr, va, te = _split_masks(rng, n_nodes)
    return Graph(n_nodes, np.stack([src, dst]).astype(np.int32), x, y, tr,
                 va, te, pos=pos, n_classes=4)


GENERATORS = {"planted": planted_partition, "powerlaw": powerlaw,
              "powerlaw_community": powerlaw_community,
              "grid": grid_mesh, "molecule": molecules}


def by_name(name: str, **kw) -> Graph:
    """Generator lookup by short name (the registry's ``generator`` field)."""
    return GENERATORS[name](**kw)
