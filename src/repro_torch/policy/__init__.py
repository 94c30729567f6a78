"""Per-site, per-epoch communication schedules (``CommPolicy``)."""
from .base import (BIT_LATTICE, CommPolicy, EpochDecision, SiteDecision,
                   SiteStats, Telemetry, snap_bits, snap_sample_p,
                   validate_decision)
from .builtin import AdaQPVariance, BoundedStaleness, Chain, Uniform, Warmup

__all__ = [
    "BIT_LATTICE", "CommPolicy", "EpochDecision", "SiteDecision", "SiteStats",
    "Telemetry", "snap_bits", "snap_sample_p", "validate_decision",
    "AdaQPVariance", "BoundedStaleness", "Chain", "Uniform", "Warmup",
]
