"""The port's embedding store and mutation stream against ``repro.store``, on
the CPU.

* ``LRUCache``: a seeded sequence of inserts, lookups, pins, repins, unpins
  and invalidations gives, step by step, the same returned rows, the same
  LRU order (the eviction order), the same pinned keys and the same byte,
  hit, miss and eviction counts as the reference's cache;
* ``ShardedEmbeddingStore``: a seeded sequence of puts, gets and pins gives
  the same rows, the same ``StoreStats``, the same ``store.*`` counters and
  a coherent cache;
* ``MutationStream``: events (timestamps, kinds, nodes, rows) and consumption
  batches are array-equal to the reference's for the same seed, on
  ``gdelt_like`` at its stream tiers and with explicit rates, and so is
  ``zipf_popularity``;
* the port's ``gdelt_like`` graphs are array-equal to the reference's at
  the smoke and small tiers, and so are the workload's stream calibrations.

Tolerances: none; every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest

from repro import datasets as jdatasets
from repro import obs as jobs
from repro.store import LRUCache as JCache
from repro.store import MutationStream as JStream
from repro.store import ShardedEmbeddingStore as JStore
from repro.store import zipf_popularity as jzipf
from repro_torch import datasets, obs
from repro_torch.store import (LRUCache, MutationStream,
                               ShardedEmbeddingStore, StoreBackend,
                               zipf_popularity)


@pytest.fixture(autouse=True)
def _fresh_metrics(monkeypatch):
    """A fresh metrics registry in both packages (a reset keeps the names
    other tests created)."""
    for o in (obs, jobs):
        monkeypatch.setattr(o.metrics, "REGISTRY", o.MetricsRegistry())


def _cache_ops(seed, n_ops=400, n_keys=12, d=4):
    """A seeded sequence of cache operations: (op, key, row)."""
    rng = np.random.default_rng(seed)
    ops = ("insert", "lookup", "lookup", "pin", "repin", "unpin",
           "invalidate")
    out = []
    for _ in range(n_ops):
        op = ops[rng.integers(len(ops))]
        key = ("t", int(rng.integers(2)), int(rng.integers(n_keys)))
        width = d if rng.random() < 0.9 else 3 * d   # some rows are wider
        out.append((op, key, rng.normal(0, 1, width).astype(np.float32)))
    return out


def _cache_state(c):
    return (c.lru_keys(), c.pinned_keys(), c.lru_bytes, c.pinned_bytes,
            c.bytes_cached, c.hits, c.misses, c.hit_bytes, c.evictions,
            c.evicted_bytes, len(c))


@pytest.mark.parametrize("capacity_rows", [0, 1, 3, 8, 64])
def test_lru_cache_matches_reference_op_by_op(capacity_rows):
    cap = capacity_rows * 16
    mine, ref = LRUCache(cap), JCache(cap)
    for step, (op, key, row) in enumerate(_cache_ops(capacity_rows)):
        got = [getattr(c, op)(key, row) if op in ("insert", "pin", "repin")
               else getattr(c, op)(key) for c in (mine, ref)]
        if op == "lookup":
            assert (got[0] is None) == (got[1] is None), step
            if got[0] is not None:
                np.testing.assert_array_equal(got[0], got[1])
        else:
            assert got[0] == got[1], (step, op)
        assert _cache_state(mine) == _cache_state(ref), (step, op)
        assert (key in mine) == (key in ref)
        assert mine.is_pinned(key) == ref.is_pinned(key)
    assert mine.hits + mine.misses > 0
    with pytest.raises(ValueError):
        LRUCache(-1)


def _store_ops(store_cls, seed, cache_rows, parts=3, rows=20, d=6):
    """Drive one store through a seeded sequence; returns what it read."""
    st = store_cls(cache_bytes=cache_rows * d * 4)
    st.create_table("logits", part_rows=(rows,) * parts, d=d)
    st.create_table("emb", part_rows=(rows - 5,) * parts, d=2 * d)
    rng = np.random.default_rng(seed)
    reads = []
    for p in range(parts):
        st.put_rows("logits", p, np.arange(rows),
                    rng.normal(0, 1, (rows, d)).astype(np.float32))
        st.put_rows("emb", p, np.arange(rows - 5),
                    rng.normal(0, 1, (rows - 5, 2 * d)).astype(np.float32))
    st.pin("logits", 0, [0, 3, 7])
    for _ in range(60):
        table = "logits" if rng.random() < 0.7 else "emb"
        n = rows if table == "logits" else rows - 5
        p = int(rng.integers(parts))
        u = rng.random()
        if u < 0.6:
            reads.append(st.get_rows(table, p, rng.integers(0, n, size=5)))
        elif u < 0.9:
            slots = rng.choice(n, size=4, replace=False)
            width = d if table == "logits" else 2 * d
            st.put_rows(table, p, slots,
                        rng.normal(0, 1, (4, width)).astype(np.float32))
        elif u < 0.95:
            st.pin(table, p, rng.choice(n, size=2, replace=False))
        else:
            st.unpin(table, p, rng.choice(n, size=2, replace=False))
    return st, reads


@pytest.mark.parametrize("cache_rows", [0, 4, 32, 1000])
def test_store_matches_reference(cache_rows):
    st, reads = _store_ops(ShardedEmbeddingStore, 5, cache_rows)
    jst, jreads = _store_ops(JStore, 5, cache_rows)
    assert isinstance(st, StoreBackend)
    assert len(reads) == len(jreads) > 0
    for a, b in zip(reads, jreads):
        np.testing.assert_array_equal(a, b)
    assert st.stats().as_dict() == jst.stats().as_dict()
    assert st.stats().hits + st.stats().misses == 5 * len(reads)
    assert st.shard_bytes() == jst.shard_bytes()
    assert st.tables() == jst.tables()
    assert st.check_coherence() == jst.check_coherence()
    for table in st.tables():
        for p in range(3):
            slots = np.arange(15)
            np.testing.assert_array_equal(st.peek_rows(table, p, slots),
                                          jst.peek_rows(table, p, slots))
    assert obs.snapshot()["counters"] == jobs.snapshot()["counters"]
    with pytest.raises(ValueError):
        st.put_rows("logits", 0, [0, 1], np.zeros((2, 5), np.float32))
    with pytest.raises(KeyError):
        st.get_rows("nope", 0, [0])
    with pytest.raises(ValueError):
        st.create_table("logits", part_rows=(1,), d=1)


def _events(s, n):
    return [(e.t, e.kind, e.node, e.dst,
             None if e.row is None else e.row.tolist()) for e in s.events(n)]


@pytest.mark.parametrize("kw", [
    dict(rate=40.0, feat_frac=0.7, skew=1.1, seed=1),
    dict(rate=500.0, feat_frac=1.0, skew=0.0, seed=3),
    dict(rate=5.0, feat_frac=0.0, skew=0.9, seed=0)])
def test_stream_events_and_batches_match_reference(kw):
    n, d = 300, 8
    s, js = MutationStream(n, d, **kw), JStream(n, d, **kw)
    assert _events(s, 120) == _events(js, 120)
    table = np.random.default_rng(9).normal(0, 1, (n, d)).astype(np.float32)
    b = s.batches(120, 0.05, rows_of=lambda ids: table[ids])
    jb = js.batches(120, 0.05, rows_of=lambda ids: table[ids])
    assert len(b) == len(jb) > 0
    for (t, ids, rows), (jt, jids, jrows) in zip(b, jb):
        assert t == jt
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(rows, jrows)
    with pytest.raises(ValueError):
        s.batches(10, 0.0, rows_of=lambda ids: table[ids])
    with pytest.raises(ValueError):
        MutationStream(n, d, rate=0.0)


@pytest.mark.parametrize("n,skew,seed", [(100, 1.2, 0), (1000, 0.0, 3),
                                         (16_682, 1.1, 2)])
def test_zipf_popularity_matches_reference(n, skew, seed):
    p = zipf_popularity(n, skew, seed)
    np.testing.assert_array_equal(p, jzipf(n, skew, seed))
    assert p.shape == (n,) and p.sum() == pytest.approx(1.0)


@pytest.mark.parametrize("tier", ["smoke", "small"])
def test_gdelt_like_graph_and_stream_match_reference(tier):
    ref = f"gdelt_like@{tier}"
    g, s = MutationStream.from_workload(ref, seed=2)
    jg, js = JStream.from_workload(ref, seed=2)
    for f in ("edge_index", "x", "y", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
    assert (g.n_nodes, g.n_classes) == (jg.n_nodes, jg.n_classes)
    assert (s.n_nodes, s.d_feat, s.rate, s.feat_frac, s.skew, s.seed) == \
        (js.n_nodes, js.d_feat, js.rate, js.feat_frac, js.skew, js.seed)
    assert _events(s, 200) == _events(js, 200)
    spec, jspec = datasets.get("gdelt_like"), jdatasets.get("gdelt_like")
    assert spec.tiers == jspec.tiers and spec.stream == jspec.stream
    assert dataclasses.asdict(spec.target) == dataclasses.asdict(jspec.target)
    with pytest.raises(KeyError):
        MutationStream.from_workload("yelp_like@smoke")
    with pytest.raises(KeyError):
        MutationStream.from_workload("gdelt_like@paper")


def test_gdelt_like_partition_matches_reference(tmp_path):
    pg = datasets.load_partitioned("gdelt_like@smoke", n_parts=4)
    jpg, _ = jdatasets.load_partitioned("gdelt_like@smoke", n_parts=4,
                                        cache_dir=tmp_path)
    for f in ("part_of", "global_ids", "node_mask", "x", "edge_mask"):
        np.testing.assert_array_equal(getattr(pg, f), getattr(jpg, f))
    for f in ("send_idx", "send_mask", "recv_mask"):
        np.testing.assert_array_equal(getattr(pg.plan, f),
                                      getattr(jpg.plan, f))
    assert datasets.get("gdelt_like").stream == \
        jdatasets.get("gdelt_like").stream
