"""The port's serving front against the JAX reference, on the CPU: the
engine's store hooks and degraded mode, the server, the replica set, the
load generators and ``python -m repro_torch.launch.serve``.

``yelp_like@smoke`` and ``gdelt_like@smoke`` partitioned 4 ways, GCN
(d_hidden 32, 2 layers) with the JAX ``model.init`` parameters in both
packages, 1-bit deterministic halos unless said otherwise:

* a store-backed engine (a roomy and a tiny cache) answers queries and
  embeddings bit for bit as the materialized one through interleaved
  refreshes, and ``verify_store`` passes; ``StoreReader`` only reads;
* degraded mode: a partition marked down keeps its logits frozen bit for
  bit, its staleness counts sweeps as the JAX engine's does, and at 32 bits
  the logits are allclose to JAX's at rtol / atol 1e-5; after ``set_up``
  and a full sweep they equal a fresh engine's bit for bit;
* ``EmbeddingServer`` microbatches equal ``engine.query``, admission
  rejects at ``max_queue`` and when draining; the ``ReplicaSet`` routes
  around a draining replica and answers a mixed read / refresh workload as
  the materialized engine does;
* under a ``FakeClock`` the closed and open loops (the open one with Zipf
  skew 1.1, two store-backed replicas and a mutation-stream feed) return
  reports equal to ``repro.serve.loadgen``'s on the JAX engine, every
  field: counts, rejections, refreshes, escalations, wire bytes, latencies;
* a sweep runs each kernel's plain version as often as the kernels launch
  on the card (``chip_smoke.SERVE_LAUNCHES``);
* ``serve_once`` at ``--device cpu`` returns the reference's report keys
  and the same byte fields; without ``--device cpu`` the entry point raises
  here, and ``--runtime sharded`` is refused.

Tolerances are stated where used; everything else is exact.
"""
import jax
import numpy as np
import pytest
import torch

from repro import datasets as jdatasets
from repro import obs as jobs
from repro.launch import serve as jserve
from repro.models.gnn.models import GCN as JGCN
from repro.serve import EmbeddingServer as JServer
from repro.serve import InferenceEngine as JEngine
from repro.serve import ReplicaSet as JReplicaSet
from repro.serve import ServeConfig as JServeConfig
from repro.serve import loadgen as jloadgen
from repro.store import MutationStream as JStream
from repro.store import ShardedEmbeddingStore as JStore
from repro_torch import datasets, obs
from repro_torch.dist.runtime import Runtime
from repro_torch.kernels.gat import ref as gref
from repro_torch.kernels.quant import ref as qref
from repro_torch.kernels.spmm import ref as sref
from repro_torch.launch import serve as tserve
from repro_torch.models.gnn.models import GAT, GCN, GraphSAGE
from repro_torch.serve import (EmbeddingServer, InferenceEngine, Rejection,
                               ReplicaSet, ServeConfig, StoreReader, loadgen)
from repro_torch.store import MutationStream, ShardedEmbeddingStore

D_HIDDEN = 32
CPU = Runtime.simulated(4, device="cpu")


@pytest.fixture(autouse=True)
def _plans_in_tmp(tmp_path, monkeypatch):
    """The serving launcher's partition-plan cache writes under the test's
    temporary directory, not the repository's ``artifacts/torch/plans``."""
    monkeypatch.setattr(datasets.plans, "default_cache_dir",
                        lambda: tmp_path / "tplans")


def _graphs(ref, tmp):
    pg, _ = datasets.load_partitioned(ref, n_parts=4, cache_dir=tmp / "t")
    jpg, _ = jdatasets.load_partitioned(ref, n_parts=4, cache_dir=tmp)
    return pg, jpg


@pytest.fixture(scope="module")
def yelp(tmp_path_factory):
    pg, jpg = _graphs("yelp_like@smoke", tmp_path_factory.mktemp("plans"))
    jmodel = JGCN(pg.x.shape[-1], D_HIDDEN, pg.n_classes, n_layers=2)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return pg, jpg, jmodel, params


@pytest.fixture(scope="module")
def gdelt(tmp_path_factory):
    pg, jpg = _graphs("gdelt_like@smoke", tmp_path_factory.mktemp("plans"))
    jmodel = JGCN(pg.x.shape[-1], D_HIDDEN, pg.n_classes, n_layers=2)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    return pg, jpg, jmodel, params


def _engine(setup, store=None, **cfg):
    pg, _, _, params = setup
    return InferenceEngine(GCN(pg.x.shape[-1], D_HIDDEN, pg.n_classes), pg,
                           params, config=ServeConfig(**cfg), runtime=CPU,
                           store=store)


def _jengine(setup, store=None, **cfg):
    _, jpg, jmodel, params = setup
    return JEngine(jmodel, jpg, params, config=JServeConfig(**cfg),
                   store=store)


def _changes(pg, rng, n):
    ids = rng.choice(pg.part_of.size, size=n, replace=False)
    return ids, rng.normal(0, 1, (n, pg.x.shape[-1])).astype(np.float32)


# ---------------------------------------------------------------------------
# the engine's store hooks and degraded mode
# ---------------------------------------------------------------------------
def test_store_engine_bitexact_through_interleaved_refreshes(yelp):
    pg = yelp[0]
    n_cls = pg.n_classes
    eng = _engine(yelp)
    big = _engine(yelp, store=ShardedEmbeddingStore(cache_bytes=1 << 22))
    tiny = _engine(yelp, store=ShardedEmbeddingStore(
        cache_bytes=40 * n_cls * 4))
    for e in (eng, big, tiny):
        e.full_sweep()
    big.pin_hot(np.arange(10))
    all_ids = np.arange(pg.part_of.size)
    rng = np.random.default_rng(7)
    for it in range(4):
        ids, rows = _changes(pg, rng, 6)
        for e in (eng, big, tiny):
            assert e.refresh(ids, rows).kind == "delta"
        q = rng.choice(pg.part_of.size, size=40)
        for e in (big, tiny):
            np.testing.assert_array_equal(e.query(q).logits,
                                          eng.query(q).logits,
                                          err_msg=f"refresh {it}")
            np.testing.assert_array_equal(e.embeddings(q),
                                          eng.embeddings(q))
            np.testing.assert_array_equal(e.embeddings(q, site=0),
                                          eng.embeddings(q, site=0))
        np.testing.assert_array_equal(big.query(all_ids).logits,
                                      eng.query(all_ids).logits)
        assert big.verify_store() > 0 and tiny.verify_store() > 0
    assert tiny.store.stats().miss_bytes > 0
    assert big.store.stats().pinned_bytes > 0
    assert eng.reader() is eng
    with pytest.raises(RuntimeError):
        eng.verify_store()


def test_store_reader_is_query_only(yelp):
    pg = yelp[0]
    eng = _engine(yelp, store=ShardedEmbeddingStore(cache_bytes=1 << 20))
    with pytest.raises(RuntimeError):
        eng.query([0])                      # no sweep yet
    eng.full_sweep()
    rd = eng.reader()
    assert isinstance(rd, StoreReader)
    ids = np.array([0, 5, 100, pg.part_of.size - 1])
    np.testing.assert_array_equal(rd.query(ids).logits,
                                  eng.query(ids).logits)
    np.testing.assert_array_equal(rd.embeddings(ids), eng.embeddings(ids))
    assert rd.query([]).logits.shape == (0, pg.n_classes)
    for name in ("refresh", "full_sweep", "set_down", "attach_store"):
        assert not hasattr(rd, name)
    with pytest.raises(ValueError):
        StoreReader(_engine(yelp))


@pytest.mark.parametrize("down", [[1], [0, 2]])
def test_degraded_mode_freezes_rows_as_jax_does(yelp, down):
    pg = yelp[0]
    eng = _engine(yelp, bits=32)
    jeng = _jengine(yelp, bits=32)
    rng = np.random.default_rng(11)
    for e in (eng, jeng):
        e.full_sweep()
    before = eng._logits_host.copy()
    ids, rows = _changes(pg, rng, 8)
    for step in (1, 2):
        for e in (eng, jeng):
            e.set_down(down)
            rep = e.refresh(ids, rows if step == 1 else rows + 1)
            assert rep.kind == "delta"
        np.testing.assert_array_equal(eng.down_partitions(), down)
        np.testing.assert_array_equal(eng.part_staleness,
                                      jeng.part_staleness)
        assert eng.part_staleness[down].tolist() == [step] * len(down)
        np.testing.assert_array_equal(eng._logits_host[down], before[down])
        np.testing.assert_allclose(eng.logits, jeng.logits, rtol=1e-5,
                                   atol=1e-5)
        q = np.arange(pg.part_of.size)
        res, jres = eng.query(q), jeng.query(q)
        np.testing.assert_array_equal(res.staleness, jres.staleness)
    for e in (eng, jeng):
        e.set_up(down)
        e.full_sweep()
    assert eng.part_staleness.tolist() == [0] * 4
    fresh = _engine(yelp, bits=32)
    fresh.x = eng.x.clone()
    fresh._x_host = eng._x_host.copy()
    fresh.full_sweep()
    np.testing.assert_array_equal(eng._logits_host, fresh._logits_host)
    np.testing.assert_allclose(eng.logits, jeng.logits, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the request path
# ---------------------------------------------------------------------------
def test_server_microbatching_and_admission(yelp):
    pg = yelp[0]
    eng = _engine(yelp)
    eng.full_sweep()
    srv = EmbeddingServer(eng, microbatch=7, max_queue=3,
                          clock=obs.FakeClock(tick=0.001))
    reqs = [np.array([1, 2, 3]), np.array([4, 5]), np.array([6, 7, 8])]
    rids = [srv.submit(r) for r in reqs]
    assert all(isinstance(r, int) for r in rids) and srv.depth == 3
    rej = srv.submit([9])
    assert isinstance(rej, Rejection) and rej.reason == "queue_full" \
        and rej.depth == 3
    first = srv.step()                      # 3 + 2 ids fit, 3 more do not
    assert [r.req_id for r in first] == rids[:2]
    rest = srv.drain()
    assert [r.req_id for r in rest] == rids[2:]
    for resp, ids in zip(first + rest, reqs):
        np.testing.assert_array_equal(resp.logits, eng.query(ids).logits)
        assert resp.latency_s > 0.0 and resp.staleness.tolist() == \
            [0] * ids.size
    with pytest.raises(ValueError):
        srv.submit(np.arange(8))            # larger than a microbatch
    srv.submit([1], deadline_s=0.0005)
    assert srv.step() == [] and srv.expired == 1
    srv.mark_partition_down(1)
    assert srv.health == "degraded"
    srv.mark_partition_up(1)
    assert srv.health == "healthy"
    srv.start_draining()
    rej = srv.submit([1])
    assert isinstance(rej, Rejection) and rej.reason == "draining"
    assert (srv.accepted, srv.rejected, srv.served) == (4, 2, 3)
    assert srv.refresh([0], np.zeros((2, 2), np.float32)) is None
    assert srv.refresh_failures == 1 and srv.health == "draining"


def test_replicaset_routes_around_draining_and_matches_engine(yelp):
    pg = yelp[0]
    eng = _engine(yelp)
    big = _engine(yelp, store=ShardedEmbeddingStore(cache_bytes=1 << 20))
    for e in (eng, big):
        e.full_sweep()
    rs = ReplicaSet(big, n_replicas=3, microbatch=32)
    assert all(isinstance(s.engine, StoreReader) for s in rs.replicas)
    rng = np.random.default_rng(5)
    want, got = {}, {}
    for round_ in range(6):
        for _ in range(6):
            ids = rng.integers(0, pg.part_of.size, size=4)
            rid = rs.submit(ids)
            assert isinstance(rid, int)
            want[rid] = ids
        if round_ % 3 == 2:
            ids, rows = _changes(pg, rng, 5)
            assert rs.refresh(ids, rows) is not None
            eng.refresh(ids, rows)
        for resp in rs.drain():
            got[resp.req_id] = resp.logits
            np.testing.assert_array_equal(
                resp.logits, eng.query(want[resp.req_id]).logits)
    assert set(got) == set(want)
    assert all(r["accepted"] > 0 for r in rs.per_replica())
    rs2 = ReplicaSet(big, n_replicas=2, microbatch=16)
    rs2.replicas[0].start_draining()
    assert all(isinstance(rs2.submit([i]), int) for i in range(5))
    assert rs2.replicas[1].accepted == 5 and rs2.health == "healthy"
    rs2.replicas[1].start_draining()
    assert isinstance(rs2.submit([0]), Rejection)
    assert rs2.health == "draining" and len(rs2.drain()) == 5


# ---------------------------------------------------------------------------
# the load generators under a FakeClock, against repro.serve.loadgen
# ---------------------------------------------------------------------------
def _closed(setup, pkg):
    eng = (_engine if pkg == "port" else _jengine)(setup)
    server, clock = (EmbeddingServer, obs.FakeClock) if pkg == "port" \
        else (JServer, jobs.FakeClock)
    eng.full_sweep()
    srv = server(eng, microbatch=32, max_queue=3, clock=clock(tick=1e-4))
    run = loadgen.closed_loop if pkg == "port" else jloadgen.closed_loop
    return run(srv, setup[0].part_of.size, clients=6, batch=8, requests=60,
               seed=3, refresh_every=15, refresh_nodes=5)


def _open(setup, pkg):
    port = pkg == "port"
    store = (ShardedEmbeddingStore if port else JStore)(cache_bytes=1 << 14)
    eng = (_engine if port else _jengine)(setup, store=store,
                                          max_staleness=2)
    eng.full_sweep()
    pg = setup[0]
    stream = (MutationStream if port else JStream)(
        pg.part_of.size, pg.x.shape[-1], rate=40.0, feat_frac=0.7, skew=1.1,
        seed=2)
    feed = stream.batches(40, 0.25, rows_of=eng.feature_rows)
    rs = (ReplicaSet if port else JReplicaSet)(
        eng, n_replicas=2, microbatch=16, max_queue=2,
        clock=(obs if port else jobs).FakeClock(tick=2e-3))
    run = loadgen.open_loop if port else jloadgen.open_loop
    rep = run(rs, pg.part_of.size, qps=300.0, requests=120, batch=4, seed=6,
              skew=1.1, slo_ms=50.0, feed=feed)
    rep["store"] = store.stats().as_dict()
    rep["per_replica"] = rs.per_replica()
    assert eng.verify_store() > 0
    return rep


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_load_reports_match_jax_under_a_fake_clock(yelp, gdelt, loop):
    drive, setup = {"closed": (_closed, yelp), "open": (_open, gdelt)}[loop]
    rep, jrep = drive(setup, "port"), drive(setup, "jax")
    assert rep == jrep
    if loop == "closed":
        assert rep["requests"] == 60 and rep["refreshes"] == 4
        assert rep["rejected"] > 0 and rep["refresh_wire_bytes"] > 0
    else:
        assert rep["completed"] + rep["lost"] == rep["offered"] == 120
        assert rep["lost"] > 0 and rep["refresh_escalations"] > 0
        assert rep["refreshes"] > 0
        assert 0.0 < rep["refresh_lag_mean_s"] <= rep["refresh_lag_max_s"]
        s = rep["store"]
        assert s["hits"] + s["misses"] > 0 and s["miss_bytes"] > 0


# ---------------------------------------------------------------------------
# kernel calls per sweep (what chip_smoke.py holds the card to)
# ---------------------------------------------------------------------------
# the plain versions of chip_smoke.TRAIN_KERNELS, in its order
REFS = ((qref, "quantize_pack_ref"), (qref, "unpack_dequantize_ref"),
        (sref, "spmm_ref"), (sref, "spmm_heads_ref"),
        (gref, "gat_softmax_ref"), (gref, "sddmm_heads_ref"),
        (gref, ("gat_softmax_bwd_ref", "row_sums_t_ref")))
ARCHS = {"gcn": GCN, "graphsage": GraphSAGE, "gat": GAT}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sweep_runs_each_kernel_as_documented(yelp, arch, monkeypatch):
    import chip_smoke

    counts = {}
    for i, (mod, names) in enumerate(REFS):
        for name in (names if isinstance(names, tuple) else (names,)):
            real = getattr(mod, name)

            def counted(*a, _real=real, _i=i):
                counts[_i] = counts.get(_i, 0) + 1
                return _real(*a)
            monkeypatch.setattr(mod, name, counted)
    pg = yelp[0]
    model = ARCHS[arch](pg.x.shape[-1], 16, pg.n_classes,
                        generator=torch.Generator().manual_seed(0))
    eng = InferenceEngine(model, pg, config=ServeConfig(bits=1), runtime=CPU)
    for kind in ("full", "delta"):
        counts.clear()
        if kind == "full":
            eng.full_sweep()
        else:
            assert eng.refresh(*_changes(pg, np.random.default_rng(0), 4)
                               ).kind == "delta"
        assert tuple(counts.get(i, 0) for i in range(len(REFS))) == \
            chip_smoke.SERVE_LAUNCHES[arch], kind


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
def _args(tmp_path, *extra):
    return tserve.build_parser().parse_args([
        "--reduced", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"),
        "--train-epochs", "2", "--requests", "40", "--refresh-nodes", "6",
        *extra])


@pytest.mark.parametrize("flow", ["closed", "store-open"])
def test_serve_once_matches_the_reference_report(tmp_path, monkeypatch,
                                                 capsys, flow):
    extra = {"closed": ["--graph", "yelp_like@smoke", "--refresh-every",
                        "10"],
             "store-open": ["--graph", "gdelt_like@smoke", "--store",
                            "--replicas", "2", "--open-loop", "--qps",
                            "2000", "--skew", "1.1", "--stream-events",
                            "30", "--stream-window", "0.05", "--slo-ms",
                            "1000"]}[flow]
    args = _args(tmp_path, *extra)

    def jload(ref, parts, seed):            # the reference at the port's
        pg, _ = jdatasets.load_partitioned(  # reduced width, plans in tmp
            ref, parts, seed=seed, cache_dir=tmp_path / "plans")
        return pg, {"gcn": lambda d_in, d_out: JGCN(d_in, 16, d_out)}
    monkeypatch.setattr(jserve, "_load", jload)
    rep = tserve.serve_once(args)           # trains the checkpoint
    jrep = jserve.serve_once(args)          # restores the port's
    assert "trained now" in capsys.readouterr().out
    assert rep["checkpoint"]["trained_now"] and \
        not jrep["checkpoint"]["trained_now"]

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}
    assert keys(rep) == keys(jrep)
    for k in ("full_sweep_wire_bytes", "delta_vs_full_bytes", "graph",
              "arch", "n_parts", "bits", "runtime", "seed"):
        assert rep[k] == jrep[k], k
    for k in ("kind", "changed", "affected_rows", "wire_bytes"):
        assert rep["delta_refresh"][k] == jrep["delta_refresh"][k], k
    assert rep["delta_refresh"]["wire_bytes"] < rep["full_sweep_wire_bytes"]
    load, jl = rep["load"], jrep["load"]
    for k in ("refreshes", "refresh_failures", "refresh_wire_bytes"):
        assert load[k] == jl[k], k
    if flow == "closed":
        assert load["requests"] == jl["requests"] == 40
        assert load["refreshes"] == 4
    else:
        assert load["completed"] + load["lost"] == 40
        assert load["refreshes"] > 0
        assert load["refresh_escalations"] == jl["refresh_escalations"]
        assert len(rep["replicas"]) == 2
        s = rep["store"]
        assert s["hits"] + s["misses"] > 0 and s["shard_bytes"] > 0


def test_serve_matrix_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(tserve, "_out_root", lambda: tmp_path)
    reps = tserve.run_serve_matrix("smoke", device="cpu", reduced=True)
    assert [(r["bits"], r["refresh"]) for r in reps] == [
        (32, "full"), (32, "delta"), (1, "full"), (1, "delta")]
    assert reps[3]["refresh_wire_bytes"] < reps[2]["refresh_wire_bytes"] \
        < reps[0]["refresh_wire_bytes"]
    assert (tmp_path / "scenarios" / "serve_smoke" / "summary.json").exists()
    with pytest.raises(KeyError):
        tserve.run_serve_matrix("nope", device="cpu")


def test_entry_point_needs_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tserve, "_out_root", lambda: tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--graph", "yelp_like@smoke", "--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--matrix", "smoke", "--reduced"])
    with pytest.raises(SystemExit, match="not ported"):
        tserve.main(["--graph", "yelp_like@smoke", "--runtime", "sharded",
                     "--device", "cpu"])
    assert not any(tmp_path.iterdir())      # refused before any work
