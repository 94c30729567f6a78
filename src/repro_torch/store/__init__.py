"""repro_torch.store — sharded embedding store with a hot-node cache and a
streaming mutation feed; a copy of ``repro.store``.

The scale-out seam of the serving tier: per-partition shards of every
served table behind the :class:`~repro_torch.store.backend.StoreBackend`
protocol, an :class:`~repro_torch.store.cache.LRUCache` hot-node tier with
pinned semantics, and a :class:`~repro_torch.store.stream.MutationStream` —
the seeded, timestamped node-feature/edge feed whose batches drive the
engine's k-hop delta refreshes under the ``max_staleness`` bound. The store
is host memory (numpy), as in the reference: the engine publishes into it
from the card after each sweep, and readers never touch the card.

::

    from repro_torch.store import ShardedEmbeddingStore, MutationStream

    store = ShardedEmbeddingStore(cache_bytes=1 << 20)
    eng = InferenceEngine(model, pg, store=store)   # store-backed reads
    eng.full_sweep()
    eng.pin_hot(hot_node_ids)                       # hot tier
    g, stream = MutationStream.from_workload("gdelt_like@smoke")
"""
from __future__ import annotations

from .backend import ShardedEmbeddingStore, StoreBackend, StoreStats  # noqa: F401
from .cache import LRUCache  # noqa: F401
from .stream import Mutation, MutationStream, zipf_popularity  # noqa: F401

__all__ = [
    "StoreBackend", "StoreStats", "ShardedEmbeddingStore", "LRUCache",
    "Mutation", "MutationStream", "zipf_popularity",
]
