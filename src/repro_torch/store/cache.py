"""Hot-node row cache: LRU tier + pinned tier, byte-accounted (a copy of
``repro.store.cache``).

The cache fronts a :class:`~repro_torch.store.backend.ShardedEmbeddingStore` shard
on the read path. Two tiers:

* **pinned** — rows explicitly marked hot (``pin``). They stay materialized
  for the lifetime of the pin: never evicted, refreshed *in place* on
  ``put_rows`` (write-through), and do not compete with the LRU tier for
  capacity. This is the "hot nodes of a skewed workload" tier — the serving
  counterpart of pinned-memory feature caches in sampling systems.
* **LRU** — everything else, bounded by ``capacity_bytes``. A lookup hit
  moves the row to most-recently-used; an insert evicts from the LRU end
  until the new row fits. Rows larger than the whole capacity are simply not
  cached (the store still serves them from the shard). A shard write
  *invalidates* LRU-resident rows instead of updating them — the next read
  takes the miss path and refetches, which keeps the cache's contents
  trivially coherent with the shard.

Keys are ``(table, part, slot)`` row coordinates. All accounting is in bytes
of row payload (``row.nbytes``), mirrored into
:class:`~repro_torch.store.backend.StoreStats` by the owning store.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Hashable, Optional

import numpy as np

Key = Hashable


class LRUCache:
    """Byte-bounded LRU with a separate pinned tier.

    Example::

        c = LRUCache(capacity_bytes=2 * row.nbytes)
        c.insert(("logits", 0, 7), row)
        c.lookup(("logits", 0, 7)) is not None     # hit, row now MRU
        c.pin(("logits", 0, 3), hot_row)           # never evicted
    """

    def __init__(self, capacity_bytes: int):
        if capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        self.capacity_bytes = int(capacity_bytes)
        self._lru: OrderedDict[Key, np.ndarray] = OrderedDict()
        self._pinned: dict[Key, np.ndarray] = {}
        self.lru_bytes = 0
        self.pinned_bytes = 0
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.evictions = 0
        self.evicted_bytes = 0

    # -- read path ----------------------------------------------------------
    def lookup(self, key: Key) -> Optional[np.ndarray]:
        """The cached row, or None on miss. Hits count bytes and bump the row
        to most-recently-used (pinned rows have no recency to maintain)."""
        row = self._pinned.get(key)
        if row is None:
            row = self._lru.get(key)
            if row is not None:
                self._lru.move_to_end(key)
        if row is None:
            self.misses += 1
            return None
        self.hits += 1
        self.hit_bytes += row.nbytes
        return row

    # -- write path ---------------------------------------------------------
    def insert(self, key: Key, row: np.ndarray) -> None:
        """Admit a row to the LRU tier (typically on a miss-path fetch),
        evicting least-recently-used rows until it fits. No-op for pinned
        keys (already materialized) and for rows larger than the capacity."""
        if key in self._pinned:
            return
        old = self._lru.pop(key, None)
        if old is not None:
            self.lru_bytes -= old.nbytes
        if row.nbytes > self.capacity_bytes:
            return
        while self._lru and self.lru_bytes + row.nbytes > self.capacity_bytes:
            _, evicted = self._lru.popitem(last=False)
            self.lru_bytes -= evicted.nbytes
            self.evictions += 1
            self.evicted_bytes += evicted.nbytes
        self._lru[key] = row
        self.lru_bytes += row.nbytes

    def invalidate(self, key: Key) -> bool:
        """Drop an LRU-tier row (shard write: the cached copy is stale). The
        pinned tier is never invalidated — callers refresh it via ``repin``.
        Returns True when a row was actually dropped."""
        row = self._lru.pop(key, None)
        if row is None:
            return False
        self.lru_bytes -= row.nbytes
        return True

    # -- pinned tier --------------------------------------------------------
    def pin(self, key: Key, row: np.ndarray) -> None:
        """Materialize a row in the pinned tier (and drop any LRU copy)."""
        self.invalidate(key)
        old = self._pinned.get(key)
        if old is not None:
            self.pinned_bytes -= old.nbytes
        self._pinned[key] = row
        self.pinned_bytes += row.nbytes

    def repin(self, key: Key, row: np.ndarray) -> bool:
        """Write-through refresh of an already-pinned row; False if not
        pinned (the caller should invalidate the LRU copy instead)."""
        old = self._pinned.get(key)
        if old is None:
            return False
        self.pinned_bytes += row.nbytes - old.nbytes
        self._pinned[key] = row
        return True

    def unpin(self, key: Key) -> bool:
        row = self._pinned.pop(key, None)
        if row is None:
            return False
        self.pinned_bytes -= row.nbytes
        return True

    def is_pinned(self, key: Key) -> bool:
        return key in self._pinned

    # -- introspection ------------------------------------------------------
    @property
    def bytes_cached(self) -> int:
        """Total materialized bytes across both tiers."""
        return self.lru_bytes + self.pinned_bytes

    def lru_keys(self) -> tuple[Key, ...]:
        """LRU-tier keys, least-recently-used first (the eviction order)."""
        return tuple(self._lru)

    def pinned_keys(self) -> tuple[Key, ...]:
        return tuple(self._pinned)

    def __contains__(self, key: Key) -> bool:
        return key in self._pinned or key in self._lru

    def __len__(self) -> int:
        return len(self._pinned) + len(self._lru)
