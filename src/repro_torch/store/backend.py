"""KV-store-style sharded embedding tables behind a ``StoreBackend`` protocol
(a copy of ``repro.store.backend``).

The serving tier's table is too big to assume resident: a
:class:`ShardedEmbeddingStore` splits every named table (logits, final-layer
embeddings, ...) into **per-partition shards** — shard ``p`` of a table holds
the rows of the nodes partition ``p`` owns, addressed by local slot, exactly
the ``(part, slot)`` coordinates the partition plan already uses. Reads go
through an :class:`~repro_torch.store.cache.LRUCache` hot-node tier:

* **hit** — the row is served from cache (pinned or LRU), zero shard traffic;
* **miss** — the row is fetched from the shard (counted in ``miss_bytes`` —
  the modeled remote/disk tier traffic a production KV store would pay) and
  admitted to the LRU tier.

Writes (``put_rows``) land in the shard, refresh pinned rows in place, and
invalidate LRU-resident rows — read-your-writes coherence by construction
(``tests/test_torch_serve_front.py`` interleaves refreshes with reads to
hold it).

Everything is host-side numpy, as in the reference: the store models the
memory/traffic contract (what stays materialized, what ships on a miss),
not device placement. The engine stays the single writer (it copies the
rows a sweep could have changed from the card); any number of
:class:`~repro_torch.serve.engine.StoreReader` replicas read.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from .. import obs
from .cache import LRUCache


@dataclasses.dataclass(frozen=True)
class StoreStats:
    """One read/write traffic snapshot (cumulative since construction).

    ``hit_rate`` is row-weighted; ``miss_bytes`` is the shard-fetch traffic a
    remote tier would have served — the number the hot-node cache exists to
    drive down."""

    gets: int
    hits: int
    misses: int
    hit_bytes: int
    miss_bytes: int
    puts: int
    put_rows: int
    put_bytes: int
    evictions: int
    cached_bytes: int
    pinned_bytes: int
    capacity_bytes: int

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d


@runtime_checkable
class StoreBackend(Protocol):
    """What the serving tier requires of an embedding store.

    ``get_rows``/``put_rows`` move ``(len(slots), d)`` row blocks addressed
    by ``(table, part, local slots)``; ``stats`` reports the byte-accounted
    read/write traffic. Implementations may cache, tier, or shard however
    they like — the engine and its readers only speak this protocol."""

    def get_rows(self, table: str, part: int,
                 slots: np.ndarray) -> np.ndarray: ...

    def put_rows(self, table: str, part: int, slots: np.ndarray,
                 rows: np.ndarray) -> None: ...

    def stats(self) -> StoreStats: ...


class ShardedEmbeddingStore:
    """Per-partition shards + hot-node cache. The reference ``StoreBackend``.

    Example::

        store = ShardedEmbeddingStore(cache_bytes=1 << 20)
        store.create_table("logits", part_rows=(300, 300, 299, 301), d=7)
        store.put_rows("logits", 0, np.arange(300), fresh_rows)
        store.pin("logits", 0, hot_slots)          # hot tier: never evicted
        rows = store.get_rows("logits", 0, np.array([5, 17]))
        store.stats().hit_rate
    """

    def __init__(self, cache_bytes: int = 1 << 20):
        self.cache = LRUCache(cache_bytes)
        self._shards: dict[str, list[np.ndarray]] = {}
        self._gets = 0
        self._miss_bytes = 0
        self._puts = 0
        self._put_rows = 0
        self._put_bytes = 0

    # -- schema -------------------------------------------------------------
    def create_table(self, table: str, part_rows: Sequence[int], d: int,
                     dtype=np.float32) -> None:
        """Allocate one shard per partition: shard ``p`` is a
        ``(part_rows[p], d)`` array. Idempotent only for a brand-new table —
        recreating an existing one is a schema error."""
        if table in self._shards:
            raise ValueError(f"table {table!r} already exists")
        self._shards[table] = [np.zeros((int(r), int(d)), dtype=dtype)
                               for r in part_rows]

    def has_table(self, table: str) -> bool:
        return table in self._shards

    def tables(self) -> tuple[str, ...]:
        return tuple(sorted(self._shards))

    def _shard(self, table: str, part: int) -> np.ndarray:
        if table not in self._shards:
            raise KeyError(f"unknown table {table!r}; "
                           f"known: {sorted(self._shards)}")
        return self._shards[table][part]

    # -- read path ----------------------------------------------------------
    def get_rows(self, table: str, part: int, slots) -> np.ndarray:
        """Rows ``slots`` of shard ``(table, part)``: cache hits are served
        materialized; misses fetch from the shard (miss bytes), then admit to
        the LRU tier. Returns a fresh ``(len(slots), d)`` array the caller
        owns."""
        shard = self._shard(table, part)
        slots = np.asarray(slots, dtype=np.int64).reshape(-1)
        self._gets += 1
        out = np.empty((slots.size, shard.shape[1]), dtype=shard.dtype)
        miss_j: list[int] = []
        for j, s in enumerate(slots.tolist()):
            row = self.cache.lookup((table, part, s))
            if row is None:
                miss_j.append(j)
            else:
                out[j] = row
        obs.count("store.hits", slots.size - len(miss_j))
        if miss_j:
            fetched = shard[slots[miss_j]]
            self._miss_bytes += fetched.nbytes
            obs.count("store.miss_bytes", fetched.nbytes)
            out[miss_j] = fetched
            for j in miss_j:
                self.cache.insert((table, part, int(slots[j])),
                                  out[j].copy())
        return out

    def peek_rows(self, table: str, part: int, slots) -> np.ndarray:
        """Read rows straight from the shard, bypassing the cache and all
        accounting — verification/debug only (``engine.verify_store`` uses it
        so the check neither churns the LRU nor skews the hit rate)."""
        shard = self._shard(table, part)
        return shard[np.asarray(slots, dtype=np.int64).reshape(-1)].copy()

    # -- write path ---------------------------------------------------------
    def put_rows(self, table: str, part: int, slots, rows) -> None:
        """Overwrite rows of a shard. Pinned rows are refreshed in place
        (write-through — the hot tier stays materialized *and* fresh); LRU
        rows are invalidated (next read refetches)."""
        shard = self._shard(table, part)
        slots = np.asarray(slots, dtype=np.int64).reshape(-1)
        rows = np.asarray(rows, dtype=shard.dtype)
        if rows.shape != (slots.size, shard.shape[1]):
            raise ValueError(f"rows must be {(slots.size, shard.shape[1])}, "
                             f"got {rows.shape}")
        shard[slots] = rows
        self._puts += 1
        self._put_rows += int(slots.size)
        self._put_bytes += rows.nbytes
        for j, s in enumerate(slots.tolist()):
            key = (table, part, s)
            if not self.cache.repin(key, rows[j].copy()):
                self.cache.invalidate(key)

    # -- hot tier -----------------------------------------------------------
    def pin(self, table: str, part: int, slots) -> None:
        """Pin rows into the hot tier (materialized from the shard now,
        write-through refreshed on every future ``put_rows``)."""
        shard = self._shard(table, part)
        for s in np.asarray(slots, dtype=np.int64).reshape(-1).tolist():
            self.cache.pin((table, part, s), shard[s].copy())

    def unpin(self, table: str, part: int, slots) -> None:
        for s in np.asarray(slots, dtype=np.int64).reshape(-1).tolist():
            self.cache.unpin((table, part, s))

    # -- introspection ------------------------------------------------------
    def stats(self) -> StoreStats:
        c = self.cache
        return StoreStats(
            gets=self._gets, hits=c.hits, misses=c.misses,
            hit_bytes=c.hit_bytes, miss_bytes=self._miss_bytes,
            puts=self._puts, put_rows=self._put_rows,
            put_bytes=self._put_bytes, evictions=c.evictions,
            cached_bytes=c.bytes_cached, pinned_bytes=c.pinned_bytes,
            capacity_bytes=c.capacity_bytes)

    def shard_bytes(self) -> int:
        """Total bytes resident in the shard tier (the full table size the
        cache is saving readers from touching)."""
        return sum(sh.nbytes for shards in self._shards.values()
                   for sh in shards)

    def check_coherence(self) -> int:
        """Assert every cached row (both tiers) is bit-identical to its shard
        row; returns the number of rows checked. The invariant behind the
        store-backed read path's bit-exactness guarantee."""
        checked = 0
        # private access on purpose: lookup() would count hits and reorder
        # the LRU — introspection must not perturb the traffic accounting
        rows = list(self.cache._pinned.items()) + list(self.cache._lru.items())
        for (table, part, slot), row in rows:
            if not np.array_equal(row, self._shard(table, part)[slot]):
                raise AssertionError(
                    f"cache row {(table, part, slot)} diverged from its shard")
            checked += 1
        return checked
