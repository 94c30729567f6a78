"""The benchmark's ``powerlaw_community`` graph, seeded by the run's ``--seed``.

A frozen copy of the statistics of ``powerlaw_community`` (the port's
``graph/synthetic.py``): every node attaches ``avg_degree // 2`` edges; with
probability ``p_in`` the target is drawn by popularity inside the node's own
class, otherwise by popularity over all nodes, popularity being Zipf-like
with exponent ``gamma`` over a random permutation of the nodes; self-loops
are dropped and both directions stored; features are the class's mean plus
Gaussian noise; 60% / 20% / 20% of the nodes train / validate / test.

Written in PyTorch so that it runs on the card in a few large calls
(inverse-CDF draws by ``searchsorted`` in place of numpy's ``choice``): the
same seed on the same kind of device gives the same graph. It imports
nothing of the program.
"""
from __future__ import annotations

import torch


def powerlaw_community(n_nodes: int, n_classes: int, d_feat: int,
                       avg_degree: int, p_in: float, gamma: float,
                       noise: float = 1.0, *, seed: int,
                       device) -> dict:
    """The graph as tensors on ``device``: ``src``, ``dst`` (E,) int64,
    ``x`` (N, d) float32, ``y`` (N,) int64 and the boolean ``train_mask``,
    ``val_mask``, ``test_mask`` (N,)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n, c = int(n_nodes), int(n_classes)
    f64 = dict(dtype=torch.float64, device=dev)
    y = torch.randint(0, c, (n,), generator=gen, device=dev)
    pop = torch.arange(1, n + 1, **f64).pow(-float(gamma))
    pop = pop[torch.randperm(n, generator=gen, device=dev)]
    m = max(1, int(avg_degree) // 2)
    src = torch.arange(n, device=dev).repeat_interleave(m)
    intra = torch.rand(src.numel(), generator=gen, device=dev) < p_in

    # targets over all nodes: the inverse of popularity's CDF
    cdf = torch.cumsum(pop, 0)
    r = torch.rand(src.numel(), generator=gen, **f64) * cdf[-1]
    dst = torch.searchsorted(cdf, r, right=True).clamp_(max=n - 1)

    # targets inside the source's class: the CDF over the nodes sorted by
    # class, each class a contiguous range of it
    order = torch.argsort(y, stable=True)
    cdf_c = torch.cumsum(pop[order], 0)
    counts = torch.bincount(y, minlength=c)
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    before = torch.where(starts > 0, cdf_c[(starts - 1).clamp(min=0)],
                         torch.zeros_like(cdf_c[:1]))
    mass = cdf_c[(ends - 1).clamp(min=0)] - before
    cls = y[src[intra]]
    r = torch.rand(cls.numel(), generator=gen, **f64) * mass[cls] + before[cls]
    idx = torch.searchsorted(cdf_c, r, right=True)
    idx = torch.minimum(torch.maximum(idx, starts[cls]), ends[cls] - 1)
    dst[intra] = order[idx]

    keep = src != dst
    src, dst = src[keep], dst[keep]
    src, dst = torch.cat([src, dst]), torch.cat([dst, src])

    means = torch.randn((c, d_feat), generator=gen, device=dev)
    x = means[y] + noise * torch.randn((n, d_feat), generator=gen,
                                       device=dev)
    perm = torch.randperm(n, generator=gen, device=dev)
    a, b = int(0.6 * n), int(0.8 * n)
    masks = []
    for lo, hi in ((0, a), (a, b), (b, n)):
        mk = torch.zeros(n, dtype=torch.bool, device=dev)
        mk[perm[lo:hi]] = True
        masks.append(mk)
    return dict(src=src, dst=dst, x=x.to(torch.float32), y=y,
                train_mask=masks[0], val_mask=masks[1], test_mask=masks[2])


def generate(cfg: dict, seed: int, device) -> dict:
    """The graph of a configuration's keys."""
    return powerlaw_community(
        cfg["n_nodes"], cfg["n_classes"], cfg["d_feat"], cfg["avg_degree"],
        cfg["p_in"], cfg["gamma"], cfg.get("noise", 1.0), seed=seed,
        device=device)
