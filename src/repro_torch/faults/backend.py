"""FaultyBackend: a halo backend wrapper that carries a chaos schedule, as
``repro.faults.backend``.

The wrapper is *transparent on the wire*: every method delegates to the
wrapped backend unchanged. Injection happens as data inside
``faults/comm.py`` (masks in ``GNNTrainState.faults``), never by altering
the exchange. What the wrapper does is bind a
:class:`~repro_torch.faults.plan.FaultPlan` to a runtime: ``GNNTrainer``
finds the plan on its runtime's backend and arms the per-epoch schedule, so
``Runtime(FaultyBackend(base, plan), device)`` turns a launch path into a
chaos run.
"""
from __future__ import annotations

import dataclasses

from ..dist.backend import SimulatedBackend
from .plan import FaultPlan


@dataclasses.dataclass(frozen=True)
class FaultyBackend:
    """Delegating wrapper binding a :class:`FaultPlan` to a backend."""

    base: SimulatedBackend
    plan: FaultPlan = FaultPlan()

    @property
    def n_parts(self):
        return self.base.n_parts

    def exchange(self, buf):
        return self.base.exchange(buf)

    def exchange_compact(self, buf, bucket_sizes, reverse=False):
        return self.base.exchange_compact(buf, bucket_sizes, reverse=reverse)

    def exchange_quantized(self, qt):
        return self.base.exchange_quantized(qt)

    def exchange_quantized_compact(self, qt, bucket_sizes, reverse=False):
        return self.base.exchange_quantized_compact(qt, bucket_sizes,
                                                    reverse=reverse)

    def psum(self, x):
        return self.base.psum(x)

    def fence(self, tree):
        return self.base.fence(tree)

    def side_stream(self, device):
        return self.base.side_stream(device)

    def axis_index(self):
        return self.base.axis_index()
