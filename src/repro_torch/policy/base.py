"""CommPolicy vocabulary: decisions, telemetry, and the policy protocol.

A copy of ``repro.policy.base`` (pure Python):

* :class:`SiteDecision` — what one halo-exchange site does this epoch
  (forward/backward bit-widths, stochastic vs deterministic rounding,
  BNS-style boundary sampling);
* :class:`EpochDecision` — one :class:`SiteDecision` per exchange site plus
  the epoch-level choices (synchronous vs pipelined step, EF21 bits, the
  exchange schedule). Hashable: the trainer keys its step cache on
  :meth:`EpochDecision.step_key`;
* :class:`Telemetry` / :class:`SiteStats` — what a policy may observe, all
  host-side floats gathered once per epoch;
* :class:`CommPolicy` — the protocol: ``decide(telemetry) -> EpochDecision``.

The trainer snaps decisions to the lattice below before using them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

# The decision lattice: bit-widths a snapped decision may use and the grid
# boundary-sampling rates are rounded to.
BIT_LATTICE = (1, 2, 4, 8, 16, 32)
SAMPLE_P_STEP = 0.05


def snap_bits(bits: int | float) -> int:
    """Round a requested bit-width *up* to the nearest lattice width::

        snap_bits(3)    # -> 4
        snap_bits(100)  # -> 32 (clamped to the widest lattice point)
    """
    for b in BIT_LATTICE:
        if bits <= b:
            return b
    return BIT_LATTICE[-1]


def snap_sample_p(p: float) -> float:
    """Round a boundary-sampling rate to the lattice grid, clamped to
    [0, 0.95]."""
    q = round(float(p) / SAMPLE_P_STEP) * SAMPLE_P_STEP
    return min(max(q, 0.0), 0.95)


@dataclasses.dataclass(frozen=True)
class SiteDecision:
    """Per-exchange-site communication decision: ``fwd_bits`` quantizes the
    forward halo features, ``bwd_bits`` the backward gradient communication;
    ``boundary_sample_p`` is the BNS-GCN keep-out rate (0 disables)."""

    fwd_bits: int = 1
    bwd_bits: int = 1
    stochastic: bool = True
    boundary_sample_p: float = 0.0

    @staticmethod
    def from_config(cfg) -> "SiteDecision":
        """One global ``SylvieConfig`` decision for every site."""
        b = int(cfg.effective_bits)
        return SiteDecision(fwd_bits=b, bwd_bits=b, stochastic=cfg.stochastic,
                            boundary_sample_p=cfg.boundary_sample_p)

    def snapped(self) -> "SiteDecision":
        return SiteDecision(fwd_bits=snap_bits(self.fwd_bits),
                            bwd_bits=snap_bits(self.bwd_bits),
                            stochastic=bool(self.stochastic),
                            boundary_sample_p=snap_sample_p(
                                self.boundary_sample_p))


@dataclasses.dataclass(frozen=True)
class EpochDecision:
    """One full communication schedule: ``sites[i]`` drives the i-th
    ``comm.halo(h)`` call (``model.comm_dims()`` order); ``schedule`` is
    ``"blocking"`` or ``"overlap"``."""

    sites: tuple[SiteDecision, ...]
    sync: bool = False
    ef_bits: Optional[int] = None
    schedule: str = "blocking"

    @staticmethod
    def uniform(n_sites: int, bits: int = 1, *, sync: bool = False,
                stochastic: bool = True, boundary_sample_p: float = 0.0,
                ef_bits: Optional[int] = None,
                schedule: str = "blocking") -> "EpochDecision":
        site = SiteDecision(fwd_bits=bits, bwd_bits=bits, stochastic=stochastic,
                            boundary_sample_p=boundary_sample_p)
        return EpochDecision(sites=(site,) * n_sites, sync=sync,
                             ef_bits=ef_bits, schedule=schedule)

    @staticmethod
    def from_config(cfg, n_sites: int, *, sync: bool = False
                    ) -> "EpochDecision":
        """The ``SylvieConfig(bits=...)`` shim: every site gets the config's
        one global decision (see :meth:`SiteDecision.from_config`)."""
        return EpochDecision(sites=(SiteDecision.from_config(cfg),) * n_sites,
                             sync=sync, schedule=cfg.schedule)

    def snapped(self) -> "EpochDecision":
        return EpochDecision(
            sites=tuple(s.snapped() for s in self.sites), sync=bool(self.sync),
            ef_bits=None if self.ef_bits is None else snap_bits(self.ef_bits),
            schedule=str(self.schedule))

    def with_bits(self, bits: int) -> "EpochDecision":
        """Every site forced to ``bits`` both directions (the trainer pins
        vanilla mode at 32 this way)."""
        return EpochDecision(
            sites=tuple(dataclasses.replace(s, fwd_bits=bits, bwd_bits=bits)
                        for s in self.sites),
            sync=self.sync, ef_bits=self.ef_bits, schedule=self.schedule)

    def step_key(self):
        """Cache key of the built step functions. ``sync`` is excluded — it
        selects *which* step runs, not how either is built."""
        return (self.sites, self.ef_bits, self.schedule)

    def bits_per_site(self) -> tuple[tuple[int, int], ...]:
        """((fwd_bits, bwd_bits), ...) — the EpochMetrics record."""
        return tuple((s.fwd_bits, s.bwd_bits) for s in self.sites)


@dataclasses.dataclass(frozen=True)
class SiteStats:
    """Observed per-site quantization statistics from the previous epoch.

    ``mean_range_sq`` is the mean over live boundary rows of the squared
    per-row range ``(max - min)^2`` (Theorem 1's variance is built from it);
    ``rows`` the live boundary rows totaled across partitions; ``dim`` the
    feature width at this site."""

    dim: int
    rows: int
    mean_range_sq: float

    def variance(self, bits: int) -> float:
        """Theorem-1 quantization variance summed over this site's rows:
        ``rows * dim * E[range^2] / (6 * (2^bits - 1)^2)``; passthrough
        widths (16/32) contribute zero."""
        if bits >= 16:
            return 0.0
        big = 2.0 ** bits - 1.0
        return self.rows * self.dim * self.mean_range_sq / (6.0 * big * big)


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """Everything a policy may observe, gathered on the host once per epoch.

    ``site_stats`` is ``None`` until the first training epoch has run.
    ``prev`` is the previous epoch's (snapped) decision. ``needs_sync`` flags
    a cache-coherence requirement (resume after an elastic repartition):
    policies must return ``sync=True`` then, and the trainer enforces it.
    ``site_staleness`` counts consecutive faulty epochs per site under a
    fault plan (empty: the port runs none)."""

    epoch: int
    n_parts: int
    n_sites: int
    site_dims: tuple[int, ...]
    site_stats: Optional[tuple[SiteStats, ...]] = None
    val_history: tuple[float, ...] = ()
    needs_sync: bool = False
    prev: Optional[EpochDecision] = None
    site_staleness: tuple[int, ...] = ()


@runtime_checkable
class CommPolicy(Protocol):
    """Per-epoch communication schedules as a pluggable strategy: any object
    with ``decide(telemetry) -> EpochDecision`` and a ``name``. ``decide``
    must be a pure function of the telemetry (the trainer may call it
    speculatively, e.g. for byte accounting)."""

    def decide(self, tel: Telemetry) -> EpochDecision: ...

    @property
    def name(self) -> str: ...


def validate_decision(decision: EpochDecision, n_sites: int) -> EpochDecision:
    """Shape-check a decision against the model's exchange sites."""
    if len(decision.sites) != n_sites:
        raise ValueError(
            f"EpochDecision has {len(decision.sites)} site decisions but the "
            f"model has {n_sites} halo-exchange sites (comm_dims order)")
    return decision
