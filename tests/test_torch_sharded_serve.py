"""Serving under the port's multi-process runtime (``Runtime.sharded``: one
partition per process, the front on rank 0) on the CPU, four ``gloo``
processes from ``repro_torch.dist.spawn``, against the simulated engine and
the JAX reference.

The workload is the reference's ``SHARDMAP_SERVE`` program
(``tests/test_serve.py``): ``planted_partition(300, 16)``, GCN 16->32
trained 4 epochs (Sylvie-S, 1 bit) and checkpointed; a 5-node delta.

* GCN, GraphSAGE and GAT, at 32 bits and at deterministic 1 bit: the
  sharded engine's logits equal the simulated engine's bit for bit after a
  full sweep and after the delta (serving has no all-reduce, so no sum
  changes order); the delta's kind, affected rows and wire bytes are equal;
* the sharded GCN engine against ``repro``'s simulated ``InferenceEngine``
  on the checkpoint's parameters: rtol 1e-5 / atol 1e-5 at 32 bits, atol
  1e-4 at 1 bit (the tolerances of ``tests/test_torch_serve.py``);
* degraded mode (rank 2 down, two refreshes, back up), the store
  (``verify_store``, store-served queries, a store attached after a sweep)
  and ``embeddings(site=0)`` against the simulated engine;
* stochastic rounding: no two ranks draw the same noise;
* a closed loop on rank 0 with interleaved refreshes: every follower ran
  every command and was stopped; a refresh with an out-of-range id is
  counted in ``refresh_failures`` and sends nothing, and the next refresh
  still equals the simulated engine's;
* the census (the counterpart of ``contract_serve_census``): a 1-bit GCN
  sweep makes one ``all_to_all_single`` per exchanged tensor (payload,
  scale, zero and the affected mask at each site) with only uint8 and
  bfloat16 on the wire, and no all-reduce;
* the launcher: ``--runtime sharded --dist-backend gloo`` reports the
  simulated run's wire bytes.

All the ranks' work runs in one spawn for the module. The JAX package is
imported inside the tests, not here: the ranks import this module, and need
only torch.
"""
import numpy as np
import pytest
import torch

from repro_torch.dist.spawn import spawn

P = 4
TIMEOUT = 240
ARCHS = ("gcn", "graphsage", "gat")
BITS = (32, 1)


def _graph():
    from repro_torch.graph import synthetic
    return synthetic.planted_partition(n_nodes=300, d_feat=16, seed=0)


def _pg(g):
    import repro_torch.api as repro
    return repro.partition(g, n_parts=P)


def _model(arch: str, n_classes: int):
    """GCN 16->32 (the checkpoint's), or GraphSAGE 16->32 or GAT 2 heads x 8
    with weights drawn from a seeded generator (the same in every
    process)."""
    from repro_torch.models.gnn.models import GAT, GCN, GraphSAGE
    gen = torch.Generator().manual_seed(3)
    if arch == "gat":
        return GAT(16, 8, n_classes, n_layers=2, heads=2, generator=gen)
    if arch == "graphsage":
        return GraphSAGE(16, 32, n_classes, n_layers=2, generator=gen)
    return GCN(16, 32, n_classes, n_layers=2)


def _delta(n_nodes: int, seed: int = 0, n: int = 5):
    rng = np.random.default_rng(seed)
    ids = rng.choice(n_nodes, n, replace=False)
    return ids, rng.normal(0, 1, (n, 16)).astype(np.float32)


def _engine(arch, pg, runtime, ckpt, store=None, **cfg):
    from repro_torch.serve import InferenceEngine, ServeConfig
    model = _model(arch, pg.n_classes)
    if arch == "gcn":
        return InferenceEngine.from_checkpoint(
            ckpt, model, pg, config=ServeConfig(**cfg), runtime=runtime,
            store=store)[0]
    return InferenceEngine(model, pg, config=ServeConfig(**cfg),
                           runtime=runtime, store=store)


# ---------------------------------------------------------------------------
# the fronts: each runs on rank 0 of the sharded engine, and on the stack
# ---------------------------------------------------------------------------
def _sweep_and_delta(eng, ids, rows) -> dict:
    full = eng.full_sweep()
    out = dict(full=eng._logits_host.copy(), full_bytes=full.wire_bytes)
    rep = eng.refresh(ids, rows)
    out.update(delta=eng._logits_host.copy(), kind=rep.kind,
               affected=rep.affected_rows, bytes=rep.wire_bytes)
    return out


def _degraded(eng, ids, rows) -> dict:
    eng.full_sweep()
    eng.set_down([2])
    steps = []
    for k in range(2):
        rep = eng.refresh(ids, rows + k)
        steps.append(dict(kind=rep.kind, logits=eng._logits_host.copy(),
                          staleness=eng.part_staleness,
                          down=eng.down_partitions()))
    eng.set_up([2])
    eng.full_sweep()
    return dict(steps=steps, back=eng._logits_host.copy(),
                staleness=eng.part_staleness)


def _stored(eng, ids, rows) -> dict:
    from repro_torch.store import ShardedEmbeddingStore
    q = np.arange(eng.pg.part_of.size)
    eng.full_sweep()
    emb0 = eng.embeddings(q, site=0)
    emb_deep = eng.embeddings(q[::7])
    eng.attach_store(ShardedEmbeddingStore(cache_bytes=4 << 10))
    late = eng.verify_store()
    eng.refresh(ids, rows)
    return dict(late=late, verified=eng.verify_store(),
                query=eng.query(q).logits, emb=eng.embeddings(q[::3]),
                emb0=emb0, emb_deep=emb_deep,
                emb1=eng.embeddings(q[::5], site=1))


def _loop(eng, ids, rows, sent: list) -> dict:
    from repro_torch.serve import EmbeddingServer
    from repro_torch.serve.loadgen import closed_loop
    eng.full_sweep()
    srv = EmbeddingServer(eng)
    load = closed_loop(srv, eng.pg.part_of.size, clients=4, batch=8,
                       requests=60, seed=5, refresh_every=10,
                       refresh_nodes=4)
    before = len(sent)
    bad = srv.refresh([eng.pg.part_of.size + 3], rows[:1])
    bad_sent = len(sent) - before
    good = srv.refresh(ids, rows)
    return dict(load=load, bad=bad, bad_sent=bad_sent,
                failures=srv.refresh_failures, health=srv.health,
                kind=good.kind, logits=eng._logits_host.copy())


def _counting(log: list):
    """Wrap ``dist.api.broadcast_command`` so that ``log`` records every
    command this process sends or receives."""
    from repro_torch.dist import api
    real = api.broadcast_command

    def counted(command, group):
        got = real(command, group)
        log.append(got[0])
        return got
    api.broadcast_command = counted
    return real


def _census(eng) -> dict:
    """The collectives of one raw 1-bit sweep (``eng._sweep``, every rank
    at once) and of one lockstep full sweep on rank 0, each as ``(name,
    dtype of the tensor sent)`` from ``repro_torch.analysis.census``."""
    from repro_torch.analysis.census import collectives
    from repro_torch.serve import delta as deltalib

    def named(log):
        return [(e.name, None if e.dtype is None else f"torch.{e.dtype}")
                for e in log]
    masks = deltalib.plan_full(eng.pg, eng.n_sites).device_masks(
        eng.device, part=eng.rank)
    with collectives([]) as sweep:
        eng._sweep(eng.block, eng.x, eng._halos, masks, eng._generator())
    with collectives([]) as lockstep:
        eng.lead(lambda e: e.full_sweep())
    return dict(sweep=named(sweep), lockstep=named(lockstep))


def _stochastic_noise(eng) -> np.ndarray:
    """The site-0 noise ``u`` this process draws in a stochastic sweep."""
    from repro_torch.core import quantization as qlib
    real, drawn = qlib.quantize, []

    def recording(h, bits, generator=None, stochastic=True,
                  scale_dtype=torch.bfloat16, u=None):
        if stochastic and u is None:
            u = torch.rand(h.shape, generator=generator)
            drawn.append(u)
        return real(h, bits, generator, stochastic, scale_dtype, u)
    qlib.quantize = recording
    try:
        eng.lead(lambda e: e.full_sweep())
    finally:
        qlib.quantize = real
    return drawn[0].numpy()


def _rank(ckpt: str) -> dict:
    """Every sharded run of the module, on one rank; rank 0 returns the
    results (its own and the ones gathered from every rank)."""
    import torch.distributed as dist

    from repro_torch.dist.runtime import Runtime
    rt = Runtime.sharded(P, device="cpu")
    g = _graph()
    pg = _pg(g)
    ids, rows = _delta(g.n_nodes)
    out = {"parity": {}}
    for arch in ARCHS:
        for bits in BITS:
            eng = _engine(arch, pg, rt, ckpt, bits=bits, stochastic=False)
            out["parity"][arch, bits] = eng.lead(_sweep_and_delta, ids, rows)
    eng = _engine("gcn", pg, rt, ckpt, bits=32)
    out["degraded"] = eng.lead(_degraded, ids, rows)
    eng = _engine("gcn", pg, rt, ckpt, bits=1, stochastic=False)
    out["stored"] = eng.lead(_stored, ids, rows)
    log: list = []
    real = _counting(log)
    try:
        eng = _engine("gcn", pg, rt, ckpt, bits=1, stochastic=False)
        out["loop"] = eng.lead(_loop, ids, rows, log)
    finally:
        from repro_torch.dist import api
        api.broadcast_command = real
    mine = dict(commands=list(log), following=eng._following, rank=rt.rank)
    eng = _engine("gcn", pg, rt, ckpt, bits=1, stochastic=False)
    mine["census"] = _census(eng)
    eng = _engine("gcn", pg, rt, ckpt, bits=1, stochastic=True)
    mine["noise"] = _stochastic_noise(eng)
    every = [None] * P
    dist.all_gather_object(every, mine)
    out["ranks"] = every
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The checkpoint (4 epochs of Sylvie-S on the stack) and every
    sharded run of ``_rank``."""
    import repro_torch.api as repro
    from repro_torch.dist.runtime import Runtime
    ckpt = tmp_path_factory.mktemp("ckpt")
    g = _graph()
    tr = repro.GNNTrainer(_model("gcn", g.n_classes), _pg(g),
                          repro.SylvieConfig(mode="sync", bits=1),
                          runtime=Runtime.simulated(P, device="cpu"),
                          ckpt_dir=str(ckpt))
    tr.fit(4)
    tr.save()
    got = spawn(_rank, P, device="cpu", dist_backend="gloo",
                args=(str(ckpt),), timeout=TIMEOUT)
    return str(ckpt), g, got


def _simulated(served, front, arch="gcn", *args, **cfg):
    from repro_torch.dist.runtime import Runtime
    ckpt, g, _ = served
    eng = _engine(arch, _pg(g), Runtime.simulated(P, device="cpu"), ckpt,
                  **cfg)
    return eng.lead(front, *args)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_equals_the_simulated_engine_bit_for_bit(served,
                                                                 arch, bits):
    g = served[1]
    got = served[2]["parity"][arch, bits]
    want = _simulated(served, _sweep_and_delta, arch, *_delta(g.n_nodes),
                      bits=bits, stochastic=False)
    np.testing.assert_array_equal(got["full"], want["full"])
    np.testing.assert_array_equal(got["delta"], want["delta"])
    assert got["kind"] == want["kind"] == "delta"
    assert (got["affected"], got["bytes"], got["full_bytes"]) == \
        (want["affected"], want["bytes"], want["full_bytes"])
    assert got["bytes"] < got["full_bytes"]
    assert not np.array_equal(got["full"], got["delta"])


@pytest.mark.parametrize("bits", BITS)
def test_sharded_serving_matches_the_jax_engine(served, bits):
    from repro import api as jrepro
    from repro.graph import synthetic as jsynthetic
    from repro.models.gnn.models import GCN as JGCN
    from repro.serve import InferenceEngine as JEngine
    from repro.serve import ServeConfig as JServeConfig
    ckpt, g, got = served
    jpg = jrepro.partition(jsynthetic.planted_partition(
        n_nodes=300, d_feat=16, seed=0), n_parts=P)
    jeng, _ = JEngine.from_checkpoint(
        ckpt, JGCN(16, 32, g.n_classes, n_layers=2), jpg,
        config=JServeConfig(bits=bits))
    jeng.full_sweep()
    pg = _pg(g)
    tol = dict(rtol=1e-5, atol=1e-5) if bits == 32 else \
        dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pg.unpartition(got["parity"]["gcn", bits][
        "full"]), jeng.logits, **tol)
    rep = jeng.refresh(*_delta(g.n_nodes))
    np.testing.assert_allclose(pg.unpartition(got["parity"]["gcn", bits][
        "delta"]), jeng.logits, **tol)
    assert rep.kind == got["parity"]["gcn", bits]["kind"]
    assert rep.wire_bytes == got["parity"]["gcn", bits]["bytes"]


def test_degraded_mode_under_the_sharded_runtime(served):
    got = served[2]["degraded"]
    want = _simulated(served, _degraded, "gcn", *_delta(served[1].n_nodes),
                      bits=32)
    for a, b in zip(got["steps"], want["steps"]):
        assert a["kind"] == b["kind"] == "delta"
        np.testing.assert_array_equal(a["logits"], b["logits"])
        np.testing.assert_array_equal(a["staleness"], b["staleness"])
        np.testing.assert_array_equal(a["down"], [2])
    assert got["steps"][1]["staleness"].tolist() == [0, 0, 2, 0]
    np.testing.assert_array_equal(got["steps"][1]["logits"][2],
                                  got["steps"][0]["logits"][2])
    np.testing.assert_array_equal(got["back"], want["back"])
    assert got["staleness"].tolist() == [0] * P


def test_store_and_embeddings_under_the_sharded_runtime(served):
    got = served[2]["stored"]
    want = _simulated(served, _stored, "gcn", *_delta(served[1].n_nodes),
                      bits=1, stochastic=False)
    assert got["late"] == want["late"] > 0
    assert got["verified"] == want["verified"] > 0
    for k in ("query", "emb", "emb0", "emb_deep", "emb1"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_no_two_ranks_draw_the_same_noise(served):
    noise = [r["noise"] for r in served[2]["ranks"]]
    assert all(n.shape == noise[0].shape and n.size for n in noise)
    for i in range(P):
        for j in range(i + 1, P):
            assert not np.array_equal(noise[i], noise[j]), (i, j)


def test_closed_loop_on_rank_0_and_every_follower_stopped(served):
    got = served[2]["loop"]
    ranks = served[2]["ranks"]
    want = _simulated(served, _loop, "gcn", *_delta(served[1].n_nodes), [],
                      bits=1, stochastic=False)
    assert got["load"]["requests"] == 60
    assert got["load"]["refreshes"] == want["load"]["refreshes"] == 6
    assert got["load"]["refresh_wire_bytes"] == \
        want["load"]["refresh_wire_bytes"]
    # the bad update failed on rank 0 alone: counted, no command sent
    assert got["bad"] is None and got["bad_sent"] == 0
    assert got["failures"] == want["failures"] == 1
    assert got["kind"] == "delta"
    np.testing.assert_array_equal(got["logits"], want["logits"])
    # every rank saw the same commands, the last one the stop
    cmds = ranks[0]["commands"]
    assert cmds.count("refresh") == 7 and cmds[-1] == "stop"
    assert all(r["commands"] == cmds for r in ranks)
    assert not any(r["following"] for r in ranks)


def test_a_one_bit_sweep_puts_only_uint8_and_bf16_on_the_wire(served):
    """Per site: payload (uint8), scale and zero (bf16) and the affected
    mask (uint8), one ``all_to_all_single`` each; nothing reduced. The
    lockstep sweep adds the command's broadcast and the logits' gather."""
    for r in served[2]["ranks"]:
        sweep, lock = r["census"]["sweep"], r["census"]["lockstep"]
        assert sweep == [("all_to_all_single", d) for d in (
            "torch.uint8", "torch.bfloat16", "torch.bfloat16",
            "torch.uint8")] * 2, sweep
        assert lock == [("broadcast_object_list", None)] + sweep + \
            [("all_gather", "torch.float32"),
             ("broadcast_object_list", None)], lock


def test_launch_serve_sharded_reports_the_simulated_bytes(tmp_path,
                                                          monkeypatch):
    from repro_torch.launch import serve as tserve
    monkeypatch.setattr(tserve, "_out_root", lambda: tmp_path)
    reps = {}
    for runtime in ("sharded", "simulated"):
        args = tserve.build_parser().parse_args([
            "--graph", "yelp_like@smoke", "--reduced", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--train-epochs", "2",
            "--requests", "40", "--refresh-every", "10",
            "--refresh-nodes", "6", "--runtime", runtime,
            "--dist-backend", "gloo"])
        reps[runtime] = tserve.serve_once(args)
    shd, sim = reps["sharded"], reps["simulated"]
    assert shd["runtime"] == "sharded" and sim["runtime"] == "simulated"
    assert shd["checkpoint"]["trained_now"] and \
        not sim["checkpoint"]["trained_now"]
    assert shd["full_sweep_wire_bytes"] == sim["full_sweep_wire_bytes"]
    assert shd["delta_refresh"] == {**sim["delta_refresh"],
                                    "seconds": shd["delta_refresh"][
                                        "seconds"]}
    for k in ("requests", "refreshes", "refresh_failures",
              "refresh_wire_bytes"):
        assert shd["load"][k] == sim["load"][k], k
    assert shd["load"]["refreshes"] == 4


def _broken_front(eng, ids, rows):
    """Rank 0's sweep fails after its command went out: the server must
    not count it as a failed refresh, and the run must end."""
    from repro_torch.serve import EmbeddingServer

    def fail(*args, **kw):
        raise RuntimeError("boom on rank 0")
    eng.full_sweep()
    eng._run = fail
    EmbeddingServer(eng).refresh(ids, rows)


def _broken_rank(ckpt: str):
    from repro_torch.dist.runtime import Runtime
    rt = Runtime.sharded(P, device="cpu")
    g = _graph()
    eng = _engine("gcn", _pg(g), rt, ckpt, bits=1, stochastic=False)
    eng.lead(_broken_front, *_delta(g.n_nodes))


def test_a_failure_after_the_command_ends_the_run(served):
    with pytest.raises(RuntimeError) as err:
        spawn(_broken_rank, P, device="cpu", dist_backend="gloo",
              args=(served[0],), timeout=120)
    msg = str(err.value)
    assert "rank 0:" in msg and "LockstepError" in msg
    assert "'refresh' failed on rank 0" in msg and "boom on rank 0" in msg
