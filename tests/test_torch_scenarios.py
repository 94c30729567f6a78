"""The port's plan cache, scenario runner and chaos harness against the JAX
reference, on the CPU.

* the plan cache (``repro_torch.datasets.plans``): a hit equals a fresh
  partition array for array and the reference's partition; the key is the
  reference's; the invalidation rule (n_parts, layout, method, alignment,
  graph content) and a corrupt entry rewritten;
* the scenario runner (``repro_torch.launch.scenarios``): the report key set
  is the reference's with the three ``modeled_tpu_comm*`` keys renamed
  ``modeled_comm*``; cell ids equal the reference's for every named
  scenario; ``parse_policy`` / ``parse_fault`` build equal objects; a cell
  runs on the CPU with its plan-cache outcome, the traced cell writes its
  trace and metrics files, the ``chaos_smoke`` cell's accounting holds and
  equals JAX's; ``--scenario`` through the launcher; ``runtime="sharded"``
  is refused, naming ROADMAP item 6;
* kill-and-resume (``python -m repro_torch.launch.chaos --kill-resume
  --device cpu``, 3 epochs, worker processes): bit-exact, the crash orphan
  collected, every leg a plan-cache hit after the first load.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import datasets as jdatasets
from repro import policy as JP
from repro.datasets import plans as jplans
from repro.launch import scenarios as JS
from repro_torch import datasets
from repro_torch import policy as TP
from repro_torch.datasets import plans
from repro_torch.faults import FaultPlan
from repro_torch.launch import chaos
from repro_torch.launch import scenarios as S
from repro_torch.launch import train as launch
from repro_torch.obs import export as ox

RENAMED = {"modeled_tpu_comm_s": "modeled_comm_s",
           "modeled_tpu_comm_exposed_s": "modeled_comm_exposed_s",
           "modeled_tpu_comm_overlapped_s": "modeled_comm_overlapped_s"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the plan cache
# ---------------------------------------------------------------------------
PG_FIELDS = ("part_of", "global_ids", "node_mask", "x", "y", "train_mask",
             "val_mask", "test_mask", "edges", "edge_mask", "edge_weight")
PLAN_FIELDS = ("send_idx", "send_mask", "recv_mask", "bucket_sizes",
               "pair_counts")


def _same_partition(a, b):
    for f in PLAN_FIELDS:
        x, y = getattr(a.plan, f), getattr(b.plan, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
    for f in ("layout", "n_parts", "n_local", "h_pad", "alignment"):
        assert getattr(a.plan, f) == getattr(b.plan, f), f
    for f in PG_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert a.n_classes == b.n_classes


@pytest.mark.parametrize("layout", ["compact", "dense"])
def test_a_plan_cache_hit_equals_a_fresh_partition_and_jax(tmp_path, layout):
    pg1, hit1 = datasets.load_partitioned("yelp_like@smoke", 4, layout=layout,
                                          cache_dir=tmp_path / "t")
    pg2, hit2 = datasets.load_partitioned("yelp_like@smoke", 4, layout=layout,
                                          cache_dir=tmp_path / "t")
    assert (hit1, hit2) == (False, True)
    _same_partition(pg1, pg2)
    jpg, _ = jdatasets.load_partitioned("yelp_like@smoke", 4, layout=layout,
                                        cache_dir=tmp_path / "j")
    _same_partition(pg2, jpg)
    # one key for one partition in both packages (the same file name)
    assert sorted(f.name for f in (tmp_path / "t").glob("*.npz")) == \
        sorted(f.name for f in (tmp_path / "j").glob("*.npz"))
    _, hit = datasets.load_partitioned("yelp_like@smoke", 4, layout=layout,
                                       cache_dir=tmp_path / "t",
                                       refresh=True)
    assert not hit


def test_the_plan_key_is_the_references_and_invalidates_alike(tmp_path):
    g, jg = datasets.load("yelp_like@smoke"), jdatasets.load("yelp_like@smoke")
    base = plans.plan_key(g, 4)
    assert base == jplans.plan_key(jg, 4) == plans.plan_key(g, 4)
    assert plans.CACHE_VERSION == jplans.CACHE_VERSION
    variants = [dict(n_parts=8), dict(layout="dense"), dict(method="random"),
                dict(alignment=16), dict(seed=1),
                dict(edge_weight=np.ones(g.edge_index.shape[1], np.float32))]
    keys = set()
    for kw in variants:
        kw = dict(kw)
        n = kw.pop("n_parts", 4)
        k = plans.plan_key(g, n, **kw)
        assert k != base and k == jplans.plan_key(jg, n, **kw)
        keys.add(k)
    assert len(keys) == len(variants)
    g2 = datasets.load("yelp_like@smoke", seed=1)            # content
    assert plans.plan_key(g2, 4) != base
    x = g.x.copy()
    x[0, 0] += 1.0
    assert plans.plan_key(dataclasses.replace(g, x=x), 4) != base
    # an alignment change is a miss; both entries then coexist
    _, hit = datasets.load_partitioned("yelp_like@smoke", 4,
                                       cache_dir=tmp_path)
    (entry,) = tmp_path.glob("*.npz")
    pg16, hit16 = datasets.load_partitioned("yelp_like@smoke", 4,
                                            alignment=16, cache_dir=tmp_path)
    assert not hit and not hit16 and pg16.plan.alignment == 16
    assert all(b % 16 == 0 for b in pg16.plan.bucket_sizes)
    assert datasets.load_partitioned("yelp_like@smoke", 4,
                                     cache_dir=tmp_path)[1]
    # a corrupt entry is a miss, and is rewritten
    entry.write_bytes(b"not an npz")
    assert not datasets.load_partitioned("yelp_like@smoke", 4,
                                         cache_dir=tmp_path)[1]
    assert datasets.load_partitioned("yelp_like@smoke", 4,
                                     cache_dir=tmp_path)[1]
    assert plans.default_cache_dir().parts[-3:] == ("artifacts", "torch",
                                                    "plans")


# ---------------------------------------------------------------------------
# the scenario runner
# ---------------------------------------------------------------------------
def test_report_keys_and_cells_are_the_references():
    assert S.REPORT_SCHEMA_VERSION == JS.REPORT_SCHEMA_VERSION
    assert S.REPORT_KEYS == frozenset(RENAMED.get(k, k)
                                      for k in JS.REPORT_KEYS)
    assert sorted(S.SCENARIOS) == sorted(JS.SCENARIOS)
    for name in S.SCENARIOS:
        mine, ref = S.resolve(name), JS.resolve(name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert [c.cell_id for c in mine.cells()] == \
            [c.cell_id for c in ref.cells()]
    with pytest.raises(KeyError, match="unknown scenario"):
        S.resolve("nope")
    with pytest.raises(ValueError, match="matched no cell"):
        S.run_scenario("smoke", only="no_such_cell", device="cpu")


def test_parse_policy_and_parse_fault_equal_the_references():
    for spec in ("uniform:32", "uniform:1", "uniform", "warmup:3:2",
                 "warmup", "bounded_staleness:4:1", "adaqp:4", "adaqp"):
        mine, ref = S.parse_policy(spec), JS.parse_policy(spec)
        assert type(mine).__name__ == type(ref).__name__
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.name == ref.name
    assert isinstance(S.parse_policy("warmup:3:2"), TP.Warmup)
    assert not isinstance(S.parse_policy("warmup:3:2"), JP.Warmup)
    with pytest.raises(KeyError, match="unknown policy"):
        S.parse_policy("nope:1")
    for spec in ("drop=0.15,corrupt=0.05,seed=7", "delay=0.2,delay_s=0.01",
                 "preempt=0.1,escalate=2,seed=3"):
        mine, ref = S.parse_fault(spec), JS.parse_fault(spec)
        assert isinstance(mine, FaultPlan)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert S.parse_fault(None) is None and S.parse_fault("") is None
    with pytest.raises(KeyError, match="unknown fault key"):
        S.parse_fault("nope=1")


def test_a_traced_smoke_cell_reports_every_key(tmp_path):
    scn = S.resolve("smoke")
    cell = scn.cells()[0]
    obs_dir = tmp_path / "obs" / "smoke"
    loaded: dict = {}
    rep = S.run_cell(scn, cell, cache_dir=tmp_path / "p", loaded=loaded,
                     obs_dir=obs_dir, device="cpu")
    assert set(rep) == S.REPORT_KEYS
    assert rep["cell"] == cell.cell_id and not rep["plan_cache_hit"]
    assert rep["obs"]["enabled"] is True and rep["obs"]["n_epochs"] == 3
    assert rep["comm_payload_bytes_per_epoch"] > 0
    assert rep["modeled_comm_s"] > 0 and rep["modeled_comm_overlapped_s"] == 0
    assert rep["modeled_comm_exposed_s"] == pytest.approx(
        rep["modeled_comm_s"], rel=1e-12)
    trace = obs_dir / f"{cell.cell_id}.trace.json"
    assert rep["trace_path"] == str(trace)
    assert {"epoch", "decide", "step"} <= {e["name"]
                                           for e in ox.load_trace(trace)}
    body = ox.load_metrics(obs_dir / f"{cell.cell_id}.metrics.json")
    assert body["run"] == f"smoke/{cell.cell_id}"
    assert body["modeled_vs_measured"]["n_epochs"] == 3
    # the overlap schedule splits the same total
    over = S.run_cell(dataclasses.replace(scn, schedule="overlap"), cell,
                      cache_dir=tmp_path / "p", device="cpu")
    assert over["plan_cache_hit"] and not over["obs"]["enabled"]
    assert over["modeled_comm_overlapped_s"] > 0
    assert over["modeled_comm_exposed_s"] + \
        over["modeled_comm_overlapped_s"] == pytest.approx(
            over["modeled_comm_s"], rel=1e-12)
    assert over["final_loss"] == rep["final_loss"]


def test_a_chaos_smoke_cell_accounts_for_every_fault_as_jax_does(tmp_path):
    scn = S.resolve("chaos_smoke")
    only = "bounded_staleness-4-1__async"
    (rep,) = S.run_scenario(scn, out_dir=tmp_path / "s",
                            cache_dir=tmp_path / "p", only=only,
                            device="cpu")
    (jrep,) = JS.run_scenario(JS.resolve("chaos_smoke"),
                              out_dir=tmp_path / "js",
                              cache_dir=tmp_path / "jp", only=only)
    assert rep["faults_injected"] == \
        rep["halos_reused"] + rep["forced_syncs"] > 0
    for k in ("faults_injected", "halos_reused", "forced_syncs", "stall_s",
              "comm_payload_bytes_per_epoch", "comm_ec_bytes_per_epoch",
              "wire_payload_bytes_per_epoch", "fault", "cell"):
        assert rep[k] == jrep[k], k
    summary = json.loads((tmp_path / "s" / "chaos_smoke" / "summary.json")
                         .read_text())
    assert summary["n_cells"] == 1


def test_the_launcher_runs_a_scenario_and_refuses_sharded(tmp_path, capsys,
                                                         monkeypatch):
    monkeypatch.setattr(plans, "default_cache_dir", lambda: tmp_path / "p")
    launch.main(["--scenario", "smoke", "--only",
                 "graphsage__products_like@smoke__uniform-1",
                 "--scenario-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "wrote 1 cell reports" in out
    (f,) = (tmp_path / "smoke").glob("graphsage*.json")
    assert set(json.loads(f.read_text())) == S.REPORT_KEYS
    assert len(list((tmp_path / "p").glob("*.npz"))) == 1
    scn = S.Scenario(name="s", archs=("gcn",), datasets=("yelp_like@smoke",),
                     policies=("uniform:1",), runtimes=("sharded",))
    with pytest.raises(NotImplementedError, match="item 6"):
        S.run_cell(scn, scn.cells()[0], cache_dir=tmp_path / "p",
                   device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        chaos.main(["--kill-resume", "--runtime", "sharded", "--device",
                    "cpu"])


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------
def test_kill_and_resume_is_bit_exact_on_the_cpu(tmp_path, capsys,
                                                monkeypatch):
    """The worker processes run one BLAS / OpenMP thread each: a CPU BLAS
    may split a product by its thread count, and under a busy parallel test
    run two legs need not get the same one (on the card the kernels and
    cuBLAS give the same bits every run)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        monkeypatch.setenv(var, "1")
    cache = tmp_path / "plans"
    datasets.load_partitioned("yelp_like@smoke", 4, cache_dir=cache)
    args = chaos.build_parser().parse_args([
        "--kill-resume", "--epochs", "3", "--device", "cpu",
        "--plan-cache", str(cache), "--out-dir", str(tmp_path / "kr")])
    res = chaos.kill_resume(args)
    assert res["bit_exact"] and res["max_deviation"] == 0.0
    assert res["kill_at"] == 2
    assert res["plan_cache_hits"] == [True, True, True]
    assert res["ref"]["losses"][-1] == res["resumed"]["losses"][-1]
    assert not list((tmp_path / "kr" / "chaos").glob(".tmp_step_*"))
    assert '"bit_exact": true' in capsys.readouterr().out
