"""Sylvie's communication config and the per-pass orchestrator handed to models.

Three communication modes (paper §3): ``vanilla`` (full precision), ``sync``
(Sylvie-S: quantize -> exchange -> dequantize each layer) and ``async``
(Sylvie-A: consume the previous step's halo, emit a fresh one). What each
exchange site does — forward/backward bit-widths, stochastic vs deterministic
rounding — is a :class:`~repro_torch.policy.base.SiteDecision`: the i-th
``halo`` call reads ``decision.sites[i]``.

This module holds the forward-only part the inference engine builds on
(``serve/engine.py::ServeComm`` implements ``halo``). The training halos —
``quantized_halo``, ``fresh_halo`` and ``stale_halo`` with their quantized
backward communication — come with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..dist.backend import SimulatedBackend
from ..policy.base import SiteDecision
from .exchange import PlanArrays

Mode = str  # "vanilla" | "sync" | "async"

# Exchange schedules: "blocking" consumes each halo exchange where it is
# produced; "overlap" issues it early and lands it through a backend fence.
SCHEDULES = ("blocking", "overlap")


@dataclasses.dataclass(frozen=True)
class SylvieConfig:
    mode: Mode = "sync"
    bits: int = 1
    stochastic: bool = True
    scale_dtype: torch.dtype = torch.bfloat16
    # BNS-GCN baseline: keep a (1-p) fraction of halo rows; p=0 disables.
    boundary_sample_p: float = 0.0
    schedule: str = "blocking"

    @property
    def effective_bits(self) -> int:
        return 32 if self.mode == "vanilla" else self.bits


class SylvieComm:
    """Created for each forward pass; models call ``comm.halo(h)`` once per
    layer-exchange site, in ``model.comm_dims()`` order. All communication goes
    through ``backend`` (the simulated stack by default); stochastic-rounding
    noise comes from ``generator``.

    ``decision`` is an :class:`~repro_torch.policy.base.EpochDecision` whose
    ``sites[i]`` drives the i-th ``halo`` call; ``None`` gives every site the
    one global ``SylvieConfig`` choice."""

    def __init__(self, cfg: SylvieConfig, plan: PlanArrays,
                 generator: Optional[torch.Generator] = None, backend=None,
                 decision=None):
        self.cfg = cfg
        self.plan = plan
        self.generator = generator
        self.backend = backend if backend is not None else SimulatedBackend()
        self.decision = decision
        self.new_feat_caches: list = []
        self._site = 0

    def _site_decision(self, i) -> SiteDecision:
        if self.decision is not None:
            return self.decision.sites[i]
        return SiteDecision.from_config(self.cfg)

    @property
    def schedule(self) -> str:
        """Exchange schedule: the decision's choice when one is threaded in,
        else the config's (both default to ``"blocking"``)."""
        sched = (self.decision.schedule if self.decision is not None
                 else self.cfg.schedule)
        if sched not in SCHEDULES:
            raise ValueError(f"unknown schedule {sched!r}; known: {SCHEDULES}")
        return sched
