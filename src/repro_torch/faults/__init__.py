"""repro_torch.faults — seeded fault injection and staleness as recovery,
as ``repro.faults``.

Scheduling (``plan``) is host numpy, deterministic in (seed, epoch) and
equal to the reference's; injection (``wire``, ``comm``) is data (masks) in
the step; ``backend.FaultyBackend`` binds a plan to a runtime's backend.
"""
from .backend import FaultyBackend
from .comm import (FaultyQuantizedHalo, FaultyStaleHalo, faulty_fresh_halo,
                   faulty_quantized_halo, faulty_stale_halo)
from .plan import (BWD, FWD, FaultCtl, FaultEvents, FaultPlan, RowGeometry,
                   SiteFaults)
from .wire import checked_exchange, flip_rows, row_checksum

__all__ = [
    "BWD",
    "FWD",
    "FaultCtl",
    "FaultEvents",
    "FaultPlan",
    "FaultyBackend",
    "FaultyQuantizedHalo",
    "FaultyStaleHalo",
    "RowGeometry",
    "SiteFaults",
    "checked_exchange",
    "faulty_fresh_halo",
    "faulty_quantized_halo",
    "faulty_stale_halo",
    "flip_rows",
    "row_checksum",
]
