"""Built-in communication policies (a copy of ``repro.policy.builtin``).

* :class:`Uniform` — the paper's static setting: one bit-width everywhere,
  every epoch (``SylvieConfig(bits=...)`` degenerates to this).
* :class:`Warmup` — full-precision exchanges for the first ``epochs`` epochs,
  then ``bits``.
* :class:`BoundedStaleness` — the paper's Bounded Staleness Adaptor (§3.3):
  one synchronous cache-refresh epoch every ``eps_s`` epochs, pipelined
  otherwise.
* :class:`AdaQPVariance` — AdaQP-style per-site bit-widths: a uniform
  ``budget_bits`` byte envelope spent where the Theorem-1 variance over the
  observed per-site range stats is highest.
* :class:`Chain` — conservative merge of several policies' decisions.

All honor ``Telemetry.needs_sync`` and treat epoch 0 as a synchronous warmup
(``core.staleness.use_sync_step``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.quantization import comm_bytes
from ..core.staleness import use_sync_step
from .base import (EpochDecision, SiteDecision, SiteStats, Telemetry,
                   snap_bits)


def _uniform_sites(tel: Telemetry, bits: int, stochastic: bool,
                   boundary_sample_p: float) -> tuple[SiteDecision, ...]:
    site = SiteDecision(fwd_bits=bits, bwd_bits=bits, stochastic=stochastic,
                        boundary_sample_p=boundary_sample_p)
    return (site,) * tel.n_sites


@dataclasses.dataclass(frozen=True)
class Uniform:
    """One static decision for every site and epoch — the paper default.
    ``sync=None`` lets the mode decide (epoch 0 warmup only, pure Sylvie-A
    afterwards); ``sync=True`` forces every epoch synchronous.

    Example::

        repro_torch.api.train(model, pg, mode="sync", policy=Uniform(bits=1))
        Uniform(bits=32)                  # the fp32 vanilla baseline
    """

    bits: int = 1
    stochastic: bool = True
    boundary_sample_p: float = 0.0
    ef_bits: Optional[int] = None
    sync: Optional[bool] = None

    @staticmethod
    def from_config(cfg) -> "Uniform":
        """The ``SylvieConfig`` shim — the one sanctioned reader of
        ``cfg.bits`` (via ``effective_bits``) outside core."""
        return Uniform(bits=int(cfg.effective_bits), stochastic=cfg.stochastic,
                       boundary_sample_p=cfg.boundary_sample_p)

    @property
    def name(self) -> str:
        return "uniform"

    def decide(self, tel: Telemetry) -> EpochDecision:
        sync = (use_sync_step(tel.epoch, None) if self.sync is None
                else self.sync) or tel.needs_sync
        return EpochDecision(
            sites=_uniform_sites(tel, self.bits, self.stochastic,
                                 self.boundary_sample_p),
            sync=sync, ef_bits=self.ef_bits)


@dataclasses.dataclass(frozen=True)
class Warmup:
    """Full-precision exchanges for ``epochs`` epochs, then ``bits``.

    Example — ease early-training quantization noise, then go one-bit::

        repro_torch.api.train(model, pg, policy=Warmup(epochs=5, bits=1),
                              epochs=40)
    """

    epochs: int = 5
    bits: int = 1
    warmup_bits: int = 32
    stochastic: bool = True
    ef_bits: Optional[int] = None

    @property
    def name(self) -> str:
        return "warmup"

    def decide(self, tel: Telemetry) -> EpochDecision:
        bits = self.warmup_bits if tel.epoch < self.epochs else self.bits
        return EpochDecision(
            sites=_uniform_sites(tel, bits, self.stochastic, 0.0),
            sync=use_sync_step(tel.epoch, None) or tel.needs_sync,
            ef_bits=self.ef_bits)


@dataclasses.dataclass(frozen=True)
class BoundedStaleness:
    """The paper's Bounded Staleness Adaptor (§3.3) as a policy: one
    synchronous cache-refresh epoch every ``eps_s`` epochs (``None`` = pure
    Sylvie-A, ``1`` = always synchronous); epoch 0 and any
    ``Telemetry.needs_sync`` epoch (resume, elastic repartition) are forced
    synchronous.

    Example — Sylvie-A with a cache refresh every 4 epochs::

        repro_torch.api.train(model, pg, mode="async",
                              policy=BoundedStaleness(eps_s=4, bits=1))
    """

    eps_s: Optional[int] = None
    bits: int = 1
    stochastic: bool = True
    boundary_sample_p: float = 0.0
    ef_bits: Optional[int] = None

    @property
    def name(self) -> str:
        return f"bounded_staleness({self.eps_s})"

    def decide(self, tel: Telemetry) -> EpochDecision:
        # Fault-induced staleness counts against the same eps_s bound as the
        # scheduled staleness: a site that has been degrading to its cached
        # halo for eps_s consecutive epochs is due for a refresh now.
        stale = (bool(tel.site_staleness) and self.eps_s is not None
                 and max(tel.site_staleness) >= self.eps_s)
        return EpochDecision(
            sites=_uniform_sites(tel, self.bits, self.stochastic,
                                 self.boundary_sample_p),
            sync=use_sync_step(tel.epoch, self.eps_s) or tel.needs_sync
            or stale,
            ef_bits=self.ef_bits)


@dataclasses.dataclass(frozen=True)
class AdaQPVariance:
    """Variance-budgeted per-site bit-width assignment (AdaQP-style).

    Budget: the bytes one epoch would ship at uniform ``budget_bits``
    (both directions, every site). Assignment: every site starts at
    ``levels[0]``; upgrades (site -> next level, both directions) are applied
    greedily by Theorem-1 variance reduction per extra payload byte until the
    budget is exhausted. Sites whose boundary rows swing over a wider range —
    higher observed ``E[(max-min)^2]`` — therefore end up with more bits.

    Until stats exist (epoch 0, or a fresh resume) the decision is uniform at
    ``budget_bits``. The trainer smooths the stats with an EMA, so the
    assignment converges and stays on one lattice point — the recompile
    budget in practice is sync-warmup + one or two adaptive decisions.

    Example — spend a uniform-4-bit byte envelope where variance is worst::

        repro_torch.api.train(model, pg, policy=AdaQPVariance(budget_bits=4))
    """

    budget_bits: int = 4
    levels: tuple[int, ...] = (1, 2, 4, 8)
    stochastic: bool = True
    ef_bits: Optional[int] = None

    @property
    def name(self) -> str:
        return f"adaqp_variance({self.budget_bits})"

    def _payload(self, st: SiteStats, bits: int) -> float:
        pb, eb = comm_bytes(st.rows, st.dim, bits)
        return 2.0 * (pb + eb)          # fwd + bwd exchanges

    def decide(self, tel: Telemetry) -> EpochDecision:
        sync = use_sync_step(tel.epoch, None) or tel.needs_sync
        stats = tel.site_stats
        if not stats or len(stats) != tel.n_sites:
            return EpochDecision(
                sites=_uniform_sites(tel, self.budget_bits, self.stochastic,
                                     0.0),
                sync=sync, ef_bits=self.ef_bits)

        levels = tuple(sorted(snap_bits(b) for b in self.levels))
        budget = sum(self._payload(st, self.budget_bits) for st in stats)
        level_ix = [0] * tel.n_sites
        spent = sum(self._payload(st, levels[0]) for st in stats)
        while True:
            best, best_score = None, 0.0
            for i, st in enumerate(stats):
                j = level_ix[i]
                if j + 1 >= len(levels):
                    continue
                dvar = st.variance(levels[j]) - st.variance(levels[j + 1])
                dbytes = self._payload(st, levels[j + 1]) \
                    - self._payload(st, levels[j])
                if spent + dbytes > budget or dbytes <= 0:
                    continue
                score = dvar / dbytes
                if score > best_score:
                    best, best_score = i, score
            if best is None:
                break
            spent += self._payload(stats[best], levels[level_ix[best] + 1]) \
                - self._payload(stats[best], levels[level_ix[best]])
            level_ix[best] += 1
        sites = tuple(
            SiteDecision(fwd_bits=levels[j], bwd_bits=levels[j],
                         stochastic=self.stochastic)
            for j in level_ix)
        return EpochDecision(sites=sites, sync=sync, ef_bits=self.ef_bits)


class Chain:
    """Compose policies by conservative merge: any member asking for a
    synchronous epoch gets one; each site takes the *widest* bits any member
    assigned (per direction); stochastic rounding only if every member keeps
    it; the largest boundary-sampling rate and EF bit-width win.

    ``Chain(Warmup(5), BoundedStaleness(4))`` therefore trains full-precision
    for 5 epochs and refreshes caches every 4 epochs throughout.
    """

    def __init__(self, *policies):
        if not policies:
            raise ValueError("Chain needs at least one policy")
        self.policies = tuple(policies)

    @property
    def name(self) -> str:
        return "chain(" + ",".join(p.name for p in self.policies) + ")"

    def decide(self, tel: Telemetry) -> EpochDecision:
        decisions = [p.decide(tel) for p in self.policies]
        sites = []
        for per_site in zip(*(d.sites for d in decisions)):
            sites.append(SiteDecision(
                fwd_bits=max(s.fwd_bits for s in per_site),
                bwd_bits=max(s.bwd_bits for s in per_site),
                stochastic=all(s.stochastic for s in per_site),
                boundary_sample_p=max(s.boundary_sample_p for s in per_site)))
        # conservative EF merge: None means the full-precision (32-bit)
        # all-reduce — the widest option — so any member keeping it wins.
        efs = [d.ef_bits for d in decisions]
        ef = max(efs) if all(e is not None for e in efs) else None
        return EpochDecision(sites=tuple(sites),
                             sync=any(d.sync for d in decisions),
                             ef_bits=ef)
