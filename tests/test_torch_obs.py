"""The port's ``obs`` layer against ``repro.obs``, on the CPU.

* The tracer: a disabled tracer hands out the one ``NULL_SPAN`` and records
  nothing; the same spans, events and metrics under the same ``FakeClock``
  drain to the same events and write the same Perfetto trace JSON and the
  same metrics JSON, byte for byte (both packages write schema
  ``repro.obs/1``).
* The CLI: ``python -m repro_torch.obs summarize|timeline|diff`` renders
  files written by ``repro.obs`` to the same text as ``python -m repro.obs``,
  and exits 2 on missing or invalid files.
* The instrumented layers: with the JAX steps compiled first (a trace
  would add ``retrace`` events the port never emits), the port's trainer and
  serving path emit, under the same ``FakeClock``, the same events as the
  JAX package's — ``epoch > decide > step``, ``admit``, ``request >
  lookup``, ``refresh > plan > sweep`` — with the same timestamps, so the
  same clock reads; ``EpochMetrics.wall_s`` and ``seconds`` are equal too,
  and the counters (``serve.rejected.*``, ``store.*``) match.

Tolerances: none; every comparison is exact.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import datasets as jdatasets
from repro import obs as jobs
from repro.core.sylvie import SylvieConfig as JConfig
from repro.models.gnn.models import GCN as JGCN
from repro.obs import __main__ as jcli
from repro.obs import export as jx
from repro.policy import builtin as jpol
from repro.serve import EmbeddingServer as JServer
from repro.serve import InferenceEngine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.store import ShardedEmbeddingStore as JStore
from repro.train.trainer import GNNTrainer as JTrainer
from repro_torch import datasets, obs
from repro_torch.core.sylvie import SylvieConfig
from repro_torch.dist.runtime import Runtime
from repro_torch.models.gnn.models import GCN
from repro_torch.obs import __main__ as cli
from repro_torch.obs import export as tx
from repro_torch.policy import builtin as tpol
from repro_torch.serve import EmbeddingServer, InferenceEngine, ServeConfig
from repro_torch.store import ShardedEmbeddingStore
from repro_torch.train.trainer import GNNTrainer

ROOT = Path(__file__).resolve().parents[1]
REF = "yelp_like@smoke"
D_HIDDEN = 32
CPU = Runtime.simulated(4, device="cpu")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Every test starts and ends untraced, in both packages, with a fresh
    metrics registry (a reset keeps the names other tests created)."""
    for o in (obs, jobs):
        o.disable()
        monkeypatch.setattr(o.metrics, "REGISTRY", o.MetricsRegistry())
    yield
    for o in (obs, jobs):
        o.disable()


def _script(o):
    """The same instrumentation calls, against either package."""
    with o.span("epoch", {"epoch": 0}):
        with o.span("decide"):
            o.event("halo.issue", {"site": 0})
        with o.span("step", {"mode": "sync"}):
            o.count("store.hits", 3)
            o.observe("serve.batch", 16)
            o.observe("serve.batch", 4)
    o.event("marker")
    o.gauge("queue.depth").set(7)
    o.counter("serve.rejected.queue_full").inc()
    log = o.TraceLog("serve")
    log.append("sweep")
    log.append(("train", 1))


def test_disabled_tracer_returns_the_one_null_span():
    assert not obs.enabled() and obs.current() is None
    assert obs.span("sweep") is obs.NULL_SPAN
    assert obs.span("refresh", {"changed": 3}) is obs.NULL_SPAN
    with obs.span("x") as s:
        assert s is obs.NULL_SPAN
    obs.event("ignored")
    assert obs.drain() == []
    assert obs.clock() > 0.0


@pytest.mark.parametrize("start,tick", [(0.0, 0.0), (10.0, 0.25),
                                        (3.5, 1e-3)])
def test_same_calls_give_same_events_trace_and_metrics(tmp_path, start, tick):
    got = {}
    for name, o, ex in (("port", obs, tx), ("jax", jobs, jx)):
        o.enable(o.FakeClock(start=start, tick=tick))
        _script(o)
        events = o.drain()
        trace = ex.write_trace(tmp_path / name / "run.trace.json", events)
        metrics = ex.write_metrics(
            tmp_path / name / "run.metrics.json", metrics=o.snapshot(),
            run="smoke/run", trace_path="run.trace.json",
            merge=ex.modeled_vs_measured([1.0, 1.5], 0.25, 0.125))
        got[name] = (events, trace.read_text(), metrics.read_text(),
                     o.snapshot())
    assert got["port"] == got["jax"]
    spans = {e["name"] for e in got["port"][0] if e["ph"] == "X"}
    assert spans == {"epoch", "decide", "step"}
    assert got["port"][3]["counters"]["retrace.serve"] == 2


def test_fake_clock_sleep_and_advance_match_jax():
    a, b = obs.FakeClock(start=1.0, tick=0.5), jobs.FakeClock(start=1.0,
                                                               tick=0.5)
    seq = []
    for c in (a, b):
        out = [c(), c()]
        c.sleep(2.0)
        c.sleep(-1.0)                       # never goes backwards
        c.advance(0.25)
        out.append(c())
        seq.append(out)
    assert seq[0] == seq[1] == [1.0, 1.5, 4.25]


def _reference_files(tmp_path):
    """A trace and two metrics files written by ``repro.obs``."""
    jobs.enable(jobs.FakeClock(tick=0.125))
    _script(jobs)
    trace = jx.write_trace(tmp_path / "cell.trace.json", jobs.drain())
    mm = jx.modeled_vs_measured([1.0, 2.0], 0.25, 0.0)
    a = jx.write_metrics(tmp_path / "a.metrics.json", metrics=jobs.snapshot(),
                         run="smoke/cell_a", merge=mm, trace_path=str(trace))
    jobs.count("retrace.train", 2)
    jobs.count("store.hits", 5)
    b = jx.write_metrics(tmp_path / "b.metrics.json", metrics=jobs.snapshot(),
                         run="smoke/cell_b", merge=mm)
    return trace, a, b


@pytest.mark.parametrize("cmd", ["summarize", "timeline", "timeline-limit",
                                 "diff"])
def test_cli_renders_reference_files_to_the_same_text(tmp_path, capsys, cmd):
    trace, a, b = _reference_files(tmp_path)
    argv = {"summarize": ["summarize", str(tmp_path)],
            "timeline": ["timeline", str(trace), "--width", "40"],
            "timeline-limit": ["timeline", str(trace), "--limit", "3"],
            "diff": ["diff", str(a), str(b)]}[cmd]
    out = []
    for main in (cli.main, jcli.main):
        assert main(argv) == 0
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and out[0].strip()


def test_cli_module_runs_and_exits_2_on_bad_input(tmp_path):
    trace, a, b = _reference_files(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def run(*args):
        return subprocess.run([sys.executable, "-m", "repro_torch.obs",
                               *args], capture_output=True, text=True,
                              cwd=ROOT, env=env, timeout=120)
    r = run("diff", str(a), str(b))
    assert r.returncode == 0 and "retrace.train" in r.stdout \
        and "+2" in r.stdout
    r = run("summarize", str(tmp_path / "nowhere"))
    assert r.returncode == 2 and "error:" in r.stderr
    bad = tmp_path / "bad.trace.json"
    bad.write_text("{}")
    assert run("timeline", str(bad)).returncode == 2
    (tmp_path / "junk.metrics.json").write_text('{"schema": "nope"}')
    assert run("diff", str(a), str(tmp_path / "junk.metrics.json")
               ).returncode == 2


def test_default_directory_is_the_ports_own():
    assert tx.default_obs_dir() == ROOT / "artifacts" / "torch" / "obs"
    assert jx.default_obs_dir() != tx.default_obs_dir()


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    pg, _ = datasets.load_partitioned(
        REF, n_parts=4, cache_dir=tmp_path_factory.mktemp("tplans"))
    jpg, _ = jdatasets.load_partitioned(
        REF, n_parts=4, cache_dir=tmp_path_factory.mktemp("plans"))
    return pg, jpg


def _events_without_tid(events):
    return [{k: v for k, v in e.items() if k != "tid"} for e in events]


def test_trainer_spans_and_wall_s_match_jax(graphs):
    """Sylvie-A with ``eps_s = 2``: epochs 0 and 1 (sync, async) untraced
    compile the JAX steps; epochs 2 and 3 (sync, async) are traced."""
    pg, jpg = graphs
    dims = (pg.x.shape[-1], D_HIDDEN, pg.n_classes)
    cfg = dict(mode="async", bits=1)
    jtr = JTrainer(JGCN(*dims), jpg, JConfig(**cfg),
                   policy=jpol.BoundedStaleness(eps_s=2))
    tr = GNNTrainer(GCN(*dims), pg, SylvieConfig(**cfg),
                    policy=tpol.BoundedStaleness(eps_s=2), runtime=CPU,
                    params=jax.tree.map(np.asarray, jtr.state.params))
    for t in (tr, jtr):
        t.fit(2)
    events = []
    for t, o in ((tr, obs), (jtr, jobs)):
        o.enable(o.FakeClock(start=100.0, tick=0.01))
        t.fit(2)
        events.append(_events_without_tid(o.drain()))
    assert events[0] == events[1]
    names = [(e["name"], e.get("args")) for e in events[0]]
    assert names == [("epoch", {"epoch": 2}), ("decide", None),
                     ("step", {"mode": "sync"}), ("epoch", {"epoch": 3}),
                     ("decide", None), ("step", {"mode": "async"})]
    for m, jm in zip(tr.history, jtr.history):
        assert m.mode == jm.mode
    for m, jm in zip(tr.history[2:], jtr.history[2:]):
        assert (m.wall_s, m.seconds) == (jm.wall_s, jm.seconds)
        assert m.wall_s >= m.seconds > 0.0
    # untraced, wall_s is the host clock's and still brackets the step
    assert all(m.wall_s >= m.seconds > 0.0 for m in tr.history[:2])


def test_serving_spans_and_counters_match_jax(graphs):
    """Store-backed engines behind one server each: an accepted and a
    rejected submit, a microbatch, a delta refresh and a forced full sweep,
    traced under the same ``FakeClock`` (the JAX sweep compiled first)."""
    pg, jpg = graphs
    dims = (pg.x.shape[-1], D_HIDDEN, pg.n_classes)
    jmodel = JGCN(*dims)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    eng = InferenceEngine(GCN(*dims), pg, params, config=ServeConfig(bits=1),
                          runtime=CPU, store=ShardedEmbeddingStore(1 << 16))
    jeng = JEngine(jmodel, jpg, params, config=JServeConfig(bits=1),
                   store=JStore(1 << 16))
    rng = np.random.default_rng(3)
    ids = rng.choice(pg.part_of.size, size=4, replace=False)
    rows = rng.normal(0, 1, (4, pg.x.shape[-1])).astype(np.float32)
    events, counters = [], []
    for e, o, server in ((eng, obs, EmbeddingServer),
                         (jeng, jobs, JServer)):
        e.full_sweep()
        e.refresh(ids, rows)                # compiles JAX's sweep
        o.reset_metrics()
        srv = server(e, microbatch=8, max_queue=1)
        o.enable(o.FakeClock(start=5.0, tick=0.001))
        assert isinstance(srv.submit([1, 2, 3]), int)
        assert not isinstance(srv.submit([4]), int)     # queue_full
        [resp] = srv.step()
        assert resp.staleness.tolist() == [0, 0, 0]
        assert srv.refresh(ids[:2], rows[:2]).kind == "delta"
        assert srv.refresh(ids, rows, full=True).kind == "full"
        events.append(_events_without_tid(o.drain()))
        # the JAX package also counts its jit traces (retrace.*), which
        # the port never makes
        counters.append({k: v for k, v in o.snapshot()["counters"].items()
                         if not k.startswith("retrace.")})
    assert events[0] == events[1]
    assert [ev["name"] for ev in events[0]] == [
        "admit", "admit", "request", "lookup", "refresh", "plan", "sweep",
        "refresh", "sweep"]
    assert counters[0] == counters[1]
    assert counters[0]["serve.rejected.queue_full"] == 1
    assert counters[0]["store.hits"] + counters[0]["store.miss_bytes"] > 0
