"""Named-workload registry: the paper's evaluation graphs as scale-tiered,
seeded synthetic stand-ins.

Sylvie validates on Reddit, Yelp, ogbn-products and Amazon. Each becomes a
named workload: a :class:`WorkloadSpec` records the real graph's statistics
(:class:`TargetStats`) and maps a scale tier to calibrated generator kwargs:

* ``smoke`` — a few hundred nodes; unit tests.
* ``small`` — a few thousand nodes; examples.
* ``paper`` — tens of thousands of nodes with the target graph's real feature
  width and class count.

Every load is a pure function of ``(name, tier, seed)`` and gives the same
arrays as ``repro.datasets`` for the same reference::

    from repro_torch import datasets
    g = datasets.load("reddit_like@paper")
    pg, hit = datasets.load_partitioned("reddit_like@paper", n_parts=4)
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from ..graph import synthetic
from ..graph.formats import Graph

TIERS = ("smoke", "small", "paper")
DEFAULT_TIER = "smoke"


@dataclasses.dataclass(frozen=True)
class TargetStats:
    """Published statistics of the real graph a workload is calibrated to
    (reference only; the ``paper`` tier keeps ``d_feat`` and ``n_classes``)."""

    n_nodes: int
    n_edges: int
    avg_degree: float
    d_feat: int
    n_classes: int


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One named workload: a generator plus per-tier calibrated kwargs."""

    name: str
    generator: str                      # key into synthetic.by_name
    tiers: Mapping[str, dict]           # tier -> generator kwargs
    description: str = ""
    target: Optional[TargetStats] = None
    # temporal workloads: tier -> MutationStream kwargs (rate in events/s,
    # feat_frac, skew) of the seeded node-feature/edge mutation feed; empty
    # for static graphs (``repro_torch.store.stream``)
    stream: Mapping[str, dict] = dataclasses.field(default_factory=dict)

    def load(self, tier: str = DEFAULT_TIER, seed: int = 0) -> Graph:
        """Generate the graph at ``tier`` (deterministic in ``(tier, seed)``)."""
        if tier not in self.tiers:
            raise KeyError(
                f"workload {self.name!r} has no tier {tier!r}; "
                f"known: {sorted(self.tiers)}")
        return synthetic.by_name(self.generator, seed=seed,
                                 **self.tiers[tier])


REGISTRY: dict[str, WorkloadSpec] = {}


def register(spec: WorkloadSpec) -> WorkloadSpec:
    """Add a workload to the registry (idempotent per name)."""
    REGISTRY[spec.name] = spec
    return spec


def names() -> tuple[str, ...]:
    """Registered workload names, sorted."""
    return tuple(sorted(REGISTRY))


def get(name: str) -> WorkloadSpec:
    """Resolve a workload name; raises with the known names on a miss."""
    if name not in REGISTRY:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def parse(ref: str) -> tuple[str, str]:
    """Split a ``"name@tier"`` reference (tier defaults to ``smoke``)."""
    name, _, tier = ref.partition("@")
    tier = tier or DEFAULT_TIER
    if tier not in TIERS:
        raise KeyError(f"unknown tier {tier!r} in {ref!r}; known: {TIERS}")
    return name, tier


def load(ref: str, tier: Optional[str] = None, seed: int = 0) -> Graph:
    """Load a workload by name or ``"name@tier"`` reference."""
    name, ref_tier = parse(ref)
    return get(name).load(tier or ref_tier, seed=seed)


# ---------------------------------------------------------------------------
# The built-in workloads (the same kwargs as repro.datasets.registry).
# ---------------------------------------------------------------------------

register(WorkloadSpec(
    name="reddit_like", generator="powerlaw_community",
    description="Reddit stand-in: dense hubs, strong communities "
                "(post-to-post graph).",
    target=TargetStats(n_nodes=232_965, n_edges=114_615_892,
                       avg_degree=492.0, d_feat=602, n_classes=41),
    tiers={
        "smoke": dict(n_nodes=600, avg_degree=16, d_feat=32, n_classes=8,
                      p_in=0.85, gamma=0.8),
        "small": dict(n_nodes=2500, avg_degree=32, d_feat=64, n_classes=16,
                      p_in=0.85, gamma=0.8),
        "paper": dict(n_nodes=25_000, avg_degree=64, d_feat=602,
                      n_classes=41, p_in=0.85, gamma=0.8),
    }))

register(WorkloadSpec(
    name="yelp_like", generator="planted",
    description="Yelp stand-in: moderate degree, homophilous business "
                "graph.",
    target=TargetStats(n_nodes=716_847, n_edges=13_954_819, avg_degree=19.5,
                       d_feat=300, n_classes=100),
    tiers={
        "smoke": dict(n_nodes=500, avg_degree=8, d_feat=32, n_classes=6,
                      p_in=0.9),
        "small": dict(n_nodes=1200, avg_degree=10, d_feat=64, n_classes=7,
                      p_in=0.9),
        "paper": dict(n_nodes=20_000, avg_degree=20, d_feat=300,
                      n_classes=50, p_in=0.9),
    }))

register(WorkloadSpec(
    name="products_like", generator="powerlaw_community",
    description="ogbn-products stand-in: co-purchase graph, heavy tail, "
                "many classes.",
    target=TargetStats(n_nodes=2_449_029, n_edges=123_718_280,
                       avg_degree=50.5, d_feat=100, n_classes=47),
    tiers={
        "smoke": dict(n_nodes=500, avg_degree=12, d_feat=32, n_classes=8,
                      p_in=0.8, gamma=0.8),
        "small": dict(n_nodes=4000, avg_degree=16, d_feat=96, n_classes=16,
                      p_in=0.8, gamma=0.8),
        "paper": dict(n_nodes=40_000, avg_degree=48, d_feat=100,
                      n_classes=47, p_in=0.8, gamma=0.8),
    }))

register(WorkloadSpec(
    name="amazon_like", generator="powerlaw_community",
    description="Amazon stand-in: the heaviest degree tail of the four "
                "(stresses per-pair halo imbalance).",
    target=TargetStats(n_nodes=1_569_960, n_edges=264_339_468,
                       avg_degree=168.0, d_feat=200, n_classes=107),
    tiers={
        "smoke": dict(n_nodes=600, avg_degree=20, d_feat=32, n_classes=8,
                      p_in=0.75, gamma=1.0),
        "small": dict(n_nodes=3000, avg_degree=40, d_feat=64, n_classes=32,
                      p_in=0.75, gamma=1.0),
        "paper": dict(n_nodes=30_000, avg_degree=96, d_feat=200,
                      n_classes=107, p_in=0.75, gamma=1.0),
    }))

register(WorkloadSpec(
    name="gdelt_like", generator="powerlaw_community",
    description="GDELT stand-in: temporal event knowledge graph whose "
                "node features and edges mutate continuously — the "
                "calibration source of the store's streaming feeds.",
    target=TargetStats(n_nodes=16_682, n_edges=191_290_882,
                       avg_degree=11_467.0, d_feat=413, n_classes=81),
    tiers={
        "smoke": dict(n_nodes=600, avg_degree=12, d_feat=32, n_classes=8,
                      p_in=0.8, gamma=0.9),
        "small": dict(n_nodes=12_000, avg_degree=16, d_feat=64,
                      n_classes=16, p_in=0.8, gamma=0.9),
        "paper": dict(n_nodes=16_682, avg_degree=64, d_feat=413,
                      n_classes=81, p_in=0.8, gamma=0.9),
    },
    # tens of mutations a second, ~70% feature refreshes and ~30% edge
    # events, heavily skewed toward hub entities
    stream={
        "smoke": dict(rate=40.0, feat_frac=0.7, skew=1.1),
        "small": dict(rate=80.0, feat_frac=0.7, skew=1.1),
    }))
