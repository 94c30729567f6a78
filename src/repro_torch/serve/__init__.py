"""repro_torch.serve — quantized full-graph inference with incremental
refresh, and the request path around it (as ``repro.serve``):

* :class:`~repro_torch.serve.engine.InferenceEngine` — materializes
  per-layer embedding caches through the quantized-halo machinery on the
  card; node queries are lookups; degraded mode and store hooks;
* :mod:`~repro_torch.serve.delta` — k-hop delta refresh planning + exact
  wire accounting;
* :class:`~repro_torch.serve.server.EmbeddingServer` — microbatched,
  admission-controlled in-process request path;
  :class:`~repro_torch.serve.server.ReplicaSet` runs N of them over one
  store behind the same interface;
* :mod:`~repro_torch.serve.loadgen` — seeded closed-loop and open-loop
  (fixed-QPS Poisson arrivals, latency-SLO gate) load generators;
* :class:`~repro_torch.serve.engine.StoreReader` — query-only replica view
  over a store-backed engine.

Under ``Runtime.sharded(P)`` (one partition per process) every rank builds
the engine and calls ``eng.lead(front)``: the front (server, replicas, load
generators, store) runs on rank 0 and the other ranks follow its sweeps.

::

    from repro_torch.serve import EmbeddingServer, InferenceEngine, ServeConfig
    from repro_torch.serve.loadgen import closed_loop

    eng, meta = InferenceEngine.from_checkpoint(ckpt_dir, model, pg,
                                                config=ServeConfig(bits=1))
    eng.full_sweep()
    report = closed_loop(EmbeddingServer(eng), n_nodes=pg.part_of.size)
"""
from __future__ import annotations

from . import delta, loadgen  # noqa: F401
from .delta import RefreshPlan, RefreshReport  # noqa: F401
from .engine import (InferenceEngine, LockstepError,  # noqa: F401
                     QueryResult, ServeComm, ServeConfig, StoreReader)
from .loadgen import closed_loop, open_loop  # noqa: F401
from .server import (EmbeddingServer, Rejection, ReplicaSet,  # noqa: F401
                     Request, Response)

__all__ = [
    "InferenceEngine", "LockstepError", "ServeConfig", "ServeComm",
    "QueryResult",
    "StoreReader", "RefreshPlan", "RefreshReport", "EmbeddingServer",
    "ReplicaSet", "Rejection", "Request", "Response", "closed_loop",
    "open_loop", "delta", "loadgen",
]
