"""Communication decisions: what each halo-exchange site does.

The pure-Python vocabulary of ``repro.policy.base`` that the inference engine
needs: :class:`SiteDecision` (per-site forward/backward bit-widths, rounding,
boundary sampling), :class:`EpochDecision` (one per site, plus the step-level
choices) and the lattice they snap to. The policy loop itself comes with the
training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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

    def snapped(self) -> "EpochDecision":
        return EpochDecision(
            sites=tuple(s.snapped() for s in self.sites), sync=bool(self.sync),
            ef_bits=None if self.ef_bits is None else snap_bits(self.ef_bits),
            schedule=str(self.schedule))


def validate_decision(decision: EpochDecision, n_sites: int) -> EpochDecision:
    """Shape-check a decision against the model's exchange sites."""
    if len(decision.sites) != n_sites:
        raise ValueError(
            f"EpochDecision has {len(decision.sites)} site decisions but the "
            f"model has {n_sites} halo-exchange sites (comm_dims order)")
    return decision
