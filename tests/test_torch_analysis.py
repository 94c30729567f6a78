"""repro_torch.analysis against repro.analysis: the census contracts' expectations,
the census the port's entry points really make, planted faults, the lint and the
CLI's exit codes.

* For every census contract the port's expectation (``train_exp``,
  ``eval_exp``, ``serve_exp``, ``expected_shift_census``) equals the
  reference's on the same 96-node skewed workload (``repro.analysis.contracts``,
  ``jaxpr_checks``), but for one deliberate difference (``FEWER_BWD``): the
  async step runs no backward exchange at site 0, whose ``h`` is the input.
* The census each sharded entry point makes, in four ``gloo`` processes
  (one spawn for every sharded case), equals that expectation on every
  rank: the ``(shift, rows)`` multiset of its ``all_to_all_single`` splits,
  the all-reduces, the wire dtypes, the backend's directions.
* Planted faults fire exactly their code, as ``tests/test_analysis.py`` does
  for the reference: fabricated censuses for RC201 / RC202 / RC203,
  monkeypatched entry points for RC204 and RC206-RC210, a raising contract
  for RC200; each lint rule on its fixture under
  ``tests/fixtures/analysis_torch/``.
* The full suite and ``python -m repro_torch.analysis --device cpu`` are
  clean; the CLI exits 1 on a planted fixture and 0 once it is baselined.

The JAX package is imported inside the tests, not here: the spawned ranks
import this module, and need only torch.
"""
import collections
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.analysis import contracts as C
from repro_torch.analysis.census import (BackendEvent, Census,
                                         CollectiveEvent, census,
                                         collectives, shift_census)
from repro_torch.analysis.checks import (ExchangeExpectation,
                                         check_exchange_census,
                                         check_no_collectives,
                                         check_overlap, check_wire_dtypes,
                                         expected_shift_census,
                                         quant_components)
from repro_torch.analysis.lint import run_lint
from repro_torch.analysis.report import (Finding, load_baseline,
                                         split_by_baseline,
                                         stale_baseline_entries,
                                         write_report)
from repro_torch.dist.runtime import Runtime
from repro_torch.dist.spawn import spawn

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "analysis_torch")
CLI_ENV = {**os.environ,
           "PYTHONPATH": os.path.join(ROOT, "src")
           + os.pathsep + os.environ.get("PYTHONPATH", "")}
P = 4
TIMEOUT = 240
# the sharded censuses recorded on every rank: name -> (arch, layout, mode)
TRAIN_CASES = {
    **{f"train_sync/{a}/{lay}": (a, lay, "sync")
       for a in ("gcn", "sage") for lay in ("compact", "dense")},
    "train_async/gcn/compact": ("gcn", "compact", "async"),
}


# ---------------------------------------------------------------------------
# the reference's expectations on its own workload
# ---------------------------------------------------------------------------
def _ref_train_exp(arch, layout, mode):
    from repro.analysis import contracts as rc
    model, pg, _, state, _ = rc._workload(arch, layout)
    return rc._train_exp(model, state, pg, layout, bits=1,
                         sync=mode == "sync")


def _ref_eval_exp():
    from repro.analysis import contracts as rc
    from repro.analysis.jaxpr_checks import ExchangeExpectation as RefExp
    model, pg, _, _, _ = rc._workload("gcn", "compact")
    return RefExp(fwd_ops=len(model.comm_dims()), bwd_ops=0, bits=32,
                  buckets=rc._buckets(pg, "compact"), psums=2,
                  wire_dtypes=frozenset({"float32"}))


def _ref_serve_exp():
    from repro.analysis import contracts as rc
    from repro.analysis.jaxpr_checks import ExchangeExpectation as RefExp
    model, pg, _, _, _ = rc._workload("gcn", "compact")
    n_sites = len(model.comm_dims())
    return RefExp(fwd_ops=n_sites, bwd_ops=0, bits=1,
                  buckets=rc._buckets(pg, "compact"), mask_ops=n_sites,
                  psums=0)


def _ref_exp(name):
    if name == "eval/gcn/compact":
        return _ref_eval_exp()
    if name == "serve_sweep/gcn/compact":
        return _ref_serve_exp()
    if name == "overlap_census/gcn/compact":
        return _ref_train_exp("gcn", "compact", "sync")
    return _ref_train_exp(*TRAIN_CASES[name])


# the one deliberate difference from the reference: the port's async step
# wires no gradient slot at site 0, whose h is the raw input (nothing reads
# that gradient), so it runs one backward exchange fewer than the
# reference's, which differentiates every cache
FEWER_BWD = {"train_async/gcn/compact": 1}


def _held_to(name):
    """The reference's expectation of ``name`` less the port's one
    deliberate difference."""
    ref = _ref_exp(name)
    return dataclasses.replace(ref,
                               bwd_ops=ref.bwd_ops - FEWER_BWD.get(name, 0))


def _port_exp(name):
    rt = Runtime.simulated(P, device="cpu")
    if name == "eval/gcn/compact":
        w = C.workload("gcn", "compact", rt)
        return C.eval_exp(w.model, w.pg)
    if name == "serve_sweep/gcn/compact":
        _, pg = C.graph_and_partition("compact")
        return C.serve_exp(2, pg)
    arch, layout, _ = TRAIN_CASES.get(name, ("gcn", "compact", "sync"))
    w = C.workload(arch, layout, rt)
    return C.train_exp(w.model, w.state, w.pg, layout, bits=1)


CENSUS_CASES = (*TRAIN_CASES, "eval/gcn/compact", "serve_sweep/gcn/compact",
                "overlap_census/gcn/compact")


@pytest.mark.parametrize("name", CENSUS_CASES)
def test_expectation_equals_the_references(name):
    from repro.analysis import jaxpr_checks as rj
    ref, port = _held_to(name), _port_exp(name)
    assert _ref_exp(name).bwd_ops - ref.bwd_ops == FEWER_BWD.get(name, 0)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.comps == ref.comps
    if port.buckets is not None:
        assert expected_shift_census(port) == rj.expected_shift_census(ref)


@pytest.mark.parametrize("exp", [
    dict(fwd_ops=2, bwd_ops=1, bits=1, buckets=(0, 44, 28, 24)),
    dict(fwd_ops=2, bwd_ops=2, bits=8, buckets=(0, 5, 0, 3)),
    dict(fwd_ops=3, bwd_ops=0, bits=32, buckets=(2, 1, 7), mask_ops=3),
    dict(fwd_ops=1, bwd_ops=1, bits=16, buckets=(0, 9, 9, 9, 1, 0)),
])
def test_expected_shift_census_is_the_references(exp):
    from repro.analysis import jaxpr_checks as rj
    assert expected_shift_census(ExchangeExpectation(**exp)) == \
        rj.expected_shift_census(rj.ExchangeExpectation(**exp))
    assert all(quant_components(b) == rj.quant_components(b)
               for b in (1, 2, 4, 8, 16, 32))


# ---------------------------------------------------------------------------
# the sharded entry points' censuses, in one spawn of four gloo processes
# ---------------------------------------------------------------------------
def _unfenced(backend, inflight):
    """The planted fault: land an issued exchange without the backend's
    fence — the received rows are put in order but never waited for."""
    from repro_torch.dist.backend import Inflight
    if inflight.finish is None:
        return inflight
    return Inflight(inflight.finish(inflight.qt))


def _rank() -> dict:
    """Every sharded case on one rank: the censuses of each entry point, the
    sharded contracts' findings, and the overlap contract with its fence
    stripped; rank 0 returns every rank's."""
    import torch.distributed as dist

    from repro_torch.dist import overlap as olap
    mine = {"rank": dist.get_rank(), "census": {}}
    for name, (arch, layout, mode) in TRAIN_CASES.items():
        mine["census"][name] = C.train_census(arch, layout, mode, "cpu")[0]
    mine["census"]["eval/gcn/compact"] = C.eval_census("cpu")[0]
    mine["census"]["serve_sweep/gcn/compact"] = C.serve_census("cpu")[0]
    mine["census"]["overlap_census/gcn/compact"] = C.train_census(
        "gcn", "compact", "sync", "cpu", schedule="overlap")[0]
    mine["findings"] = C.run_sharded(C.SHARDED, "cpu")
    real = olap.fence
    olap.fence = _unfenced
    try:
        mine["no_fence"] = C.contract_overlap_census("cpu")
    finally:
        olap.fence = real
    dist.barrier()          # the unfenced exchanges have landed
    every = [None] * P
    dist.all_gather_object(every, mine)
    return every


@pytest.fixture(scope="module")
def ranks():
    return spawn(_rank, P, device="cpu", dist_backend="gloo",
                 timeout=TIMEOUT)


def test_the_sharded_contracts_are_clean_on_every_rank(ranks):
    assert [r["rank"] for r in ranks] == list(range(P))
    for r in ranks:
        assert r["findings"] == [], \
            "\n".join(f.render() for f in r["findings"])


@pytest.mark.parametrize("name", CENSUS_CASES)
def test_the_observed_census_is_the_references_expectation(ranks, name):
    exp = _held_to(name)
    for r in ranks:
        c = r["census"][name]
        a2a = c.calls("all_to_all_single")
        if exp.buckets is not None:
            assert shift_census(c, r["rank"], P) == \
                expected_shift_census(exp)
            assert all(e.in_splits[r["rank"]] == exp.buckets[0]
                       for e in a2a)
        else:
            assert len(a2a) == (exp.fwd_ops + exp.bwd_ops) * exp.comps \
                + exp.mask_ops
            assert all(e.in_splits is None for e in a2a)
        assert {e.dtype for e in a2a} <= exp.wire_dtypes
        assert len(c.calls("all_reduce")) == exp.psums
        assert len(c.methods("psum")) == exp.psums
        assert not c.calls("all_gather", "broadcast",
                           "broadcast_object_list")
        quant = c.methods("exchange_quantized", "exchange_quantized_compact",
                          "issue_quantized")
        assert sum(e.reverse is True for e in quant) == \
            (exp.bwd_ops if exp.buckets is not None else 0)
        assert len(quant) == exp.fwd_ops + exp.bwd_ops
        assert c.launches == []          # the CPU: plain versions only


def test_the_overlap_census_is_blockings_with_async_exchanges(ranks):
    for r in ranks:
        blocking = r["census"]["train_sync/gcn/compact"]
        overlap = r["census"]["overlap_census/gcn/compact"]
        assert check_overlap(blocking, overlap, "t") == []
        a2a = overlap.calls("all_to_all_single")
        assert a2a and all(e.async_op for e in a2a)
        assert len(overlap.methods("fence")) == \
            len(overlap.methods("issue_quantized")) == 3


def test_an_overlap_step_without_fence_fires_rc209(ranks):
    for r in ranks:
        assert {f.code for f in r["no_fence"]} == {"RC209"}
        assert all("fence" in f.message for f in r["no_fence"])


# ---------------------------------------------------------------------------
# fabricated censuses: planted violations of RC201-RC203
# ---------------------------------------------------------------------------
BUCKETS = (0, 44, 28, 24)   # ragged, as the skewed partitioner makes them
RANK = 1
ROWS = sum(BUCKETS)


def _exp(**kw):
    base = dict(fwd_ops=2, bwd_ops=1, bits=1, buckets=BUCKETS, psums=7)
    base.update(kw)
    return ExchangeExpectation(**base)


def _splits(reverse: bool) -> tuple:
    sign = -1 if reverse else 1
    return tuple(BUCKETS[(sign * (d - RANK)) % P] for d in range(P))


def _a2a(dtype, reverse=False, splits=None):
    s = _splits(reverse) if splits is None else splits
    return CollectiveEvent("all_to_all_single", dtype, (sum(s), 4),
                           in_splits=s, out_splits=s)


def _exchange(reverse, payload="uint8"):
    """One compact quantized exchange at both seams."""
    arrays = ((payload, (1, ROWS, 1)), ("bfloat16", (1, ROWS)),
              ("bfloat16", (1, ROWS)))
    return (BackendEvent("exchange_quantized_compact", reverse, BUCKETS,
                         arrays),
            [_a2a(d, reverse) for d, _ in arrays])


def _clean(exp=None, payload_of=None) -> Census:
    exp = exp or _exp()
    c = Census()
    for i, rev in enumerate([False] * exp.fwd_ops + [True] * exp.bwd_ops):
        ev, calls = _exchange(rev, (payload_of or {}).get(i, "uint8"))
        c.backend.append(ev)
        c.collectives += calls
    for _ in range(exp.psums):
        c.backend.append(BackendEvent("psum", arrays=(("float32", (8,)),)))
        c.collectives.append(CollectiveEvent("all_reduce", "float32", (8,)))
    return c


def _codes(c, exp=None):
    return [f.code for f in check_exchange_census(c, exp or _exp(), "t",
                                                  RANK, P)]


def test_a_clean_census_passes():
    c = _clean()
    assert shift_census(c, RANK, P) == expected_shift_census(_exp())
    assert _codes(c) == [] and check_wire_dtypes(c, _exp(), "t") == []


def test_a_second_all_reduce_fires_rc201():
    c = _clean()
    c.collectives.append(CollectiveEvent("all_reduce", "float32", (8,)))
    assert _codes(c) == ["RC201"]


def test_a_missing_bucket_fires_rc201():
    c = _clean()
    s = list(c.collectives[-8].in_splits)
    s[(RANK + 3) % P] = 0                    # one bucket never sent
    c.collectives[-8] = _a2a("bfloat16", splits=tuple(s))
    assert _codes(c) == ["RC201"]


def test_a_backward_exchange_that_is_not_reversed_fires_rc203():
    c = _clean()
    ev, calls = _exchange(False)             # the backward on the fwd rings
    c.backend[2] = ev
    c.collectives[6:9] = calls
    assert set(_codes(c)) == {"RC203"}


def test_float32_on_a_quantized_exchange_fires_rc202():
    c = _clean(payload_of={1: "float32"})
    assert {f.code for f in check_wire_dtypes(c, _exp(), "t")} == {"RC202"}
    assert _codes(c) == []


def test_all_reduces_are_exempt_from_the_wire_audit():
    c = Census(collectives=[CollectiveEvent("all_reduce", "float32", (4,))],
               backend=[BackendEvent("psum", arrays=(("float32", (4,)),))])
    assert check_wire_dtypes(c, _exp(), "t") == []


def test_an_all_gather_in_a_halo_path_fires_rc201():
    c = _clean()
    c.collectives.append(CollectiveEvent("all_gather", "uint8", (1, 4)))
    assert _codes(c) == ["RC201"]


def test_a_collective_under_the_simulated_runtime_fires_rc201():
    c = Census(collectives=[CollectiveEvent("all_reduce", "float32", ())])
    assert [f.code for f in check_no_collectives(c, "t")] == ["RC201"]
    assert check_no_collectives(Census(), "t") == []


def test_shift_census_reads_the_splits():
    c = Census(collectives=[
        CollectiveEvent("all_to_all_single", "uint8", (9, 1),
                        in_splits=(2, 0, 3, 4)),
        CollectiveEvent("all_to_all_single", "uint8", (8, 1))])
    # rank 0: the self-split and the empty bucket never reach the wire,
    # and an even exchange has no splits
    assert shift_census(c, 0, 4) == collections.Counter({(2, 3): 1,
                                                         (3, 4): 1})


def test_the_census_restores_the_collectives():
    import torch.distributed as dist
    before = {n: getattr(dist, n) for n in ("all_to_all_single",
                                             "all_reduce", "all_gather")}
    with collectives([]):
        assert dist.all_reduce is not before["all_reduce"]
    assert all(getattr(dist, n) is f for n, f in before.items())


def test_a_census_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with census(device=None):
            pass
    with pytest.raises(RuntimeError):
        C.run_contracts(only=["quantize_payload"], device="cuda")


# ---------------------------------------------------------------------------
# contracts: clean runs and monkeypatched planted violations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", C.SIMULATED)
def test_simulated_contract_is_clean(name):
    assert C.CONTRACTS[name]("cpu") == []


def test_a_float32_payload_in_quantize_fires_rc206(monkeypatch):
    from repro_torch.core import quantization as qlib
    real, real_deq = qlib.quantize, qlib.dequantize

    def leaky(h, bits, *a, **kw):
        qt = real(h, bits, *a, **kw)
        if bits <= 8:           # ship dequantized fp32 instead of the payload
            return dataclasses.replace(qt, data=real_deq(qt))
        return qt

    monkeypatch.setattr(qlib, "quantize", leaky)
    monkeypatch.setattr(qlib, "dequantize", lambda qt: qt.data)
    findings = C.contract_quantize_payload("cpu")
    assert findings and {f.code for f in findings} == {"RC206"}


@pytest.mark.parametrize("name,code", [("recompile_budget/train", "RC204"),
                                       ("overlap_budget/train", "RC209")])
def test_a_step_cache_that_rebuilds_fires(monkeypatch, name, code):
    from repro_torch.train import trainer as trainer_mod

    def rebuild(self, decision):
        ts, ta, _ = trainer_mod.make_gnn_steps(
            self.model, self.cfg, self.opt, backend=self.runtime.backend,
            decision=decision)
        return ts, ta

    monkeypatch.setattr(trainer_mod.GNNTrainer, "_steps_for", rebuild)
    assert [f.code for f in C.CONTRACTS[name]("cpu")] == [code]


def test_a_sweep_whose_census_depends_on_the_mask_fires_rc207(monkeypatch):
    from repro_torch.serve.engine import ServeComm
    real = ServeComm.halo

    def leaky(self, h):
        aff = self.send_affected[self._site]
        if int(aff.sum()) < int(self.plan.send_mask.sum()):
            # a delta ships its mask a second time: a branch on the data
            self.backend.exchange_compact(aff[..., None],
                                          self.plan.bucket_sizes)
        return real(self, h)

    monkeypatch.setattr(ServeComm, "halo", leaky)
    findings = C.contract_serve_one_executable("cpu")
    assert [f.code for f in findings] == ["RC207"]


def test_a_faulty_backend_that_adds_an_op_fires_rc208(monkeypatch):
    from repro_torch.faults import FaultyBackend

    def leaky(self, qt, bucket_sizes, reverse=False):
        self.base.psum(qt.scale)           # an op the plain backend lacks
        return self.base.exchange_quantized_compact(qt, bucket_sizes,
                                                    reverse=reverse)

    monkeypatch.setattr(FaultyBackend, "exchange_quantized_compact", leaky)
    findings = C.contract_fault_transparency("cpu")
    assert {f.where for f in findings} == {
        "contract:fault_transparency/sync",
        "contract:fault_transparency/async"}
    assert {f.code for f in findings} == {"RC208"}


def test_instrumentation_that_adds_a_collective_fires_rc210(monkeypatch):
    from repro_torch import obs
    from repro_torch.dist import overlap as olap
    real = olap._issue

    def leaky(src, prep, bits, stochastic, scale_dtype, backend, *a, **kw):
        if obs.enabled():       # traced runs only: an all-reduce per issue
            backend.psum(torch.zeros(()))
        return real(src, prep, bits, stochastic, scale_dtype, backend, *a,
                    **kw)

    monkeypatch.setattr(olap, "_issue", leaky)
    findings = C.contract_obs_transparency("cpu")
    assert {f.code for f in findings} == {"RC210"}
    assert all("train" in f.where for f in findings)
    assert not obs.enabled()


def test_a_contract_that_raises_is_rc200(monkeypatch):
    monkeypatch.setitem(C.CONTRACTS, "boom",
                        lambda device: (_ for _ in ()).throw(
                            RuntimeError("nope")))
    findings, skipped = C.run_contracts(only=["boom"], device="cpu")
    assert [f.code for f in findings] == ["RC200"] and skipped == []
    assert "nope" in findings[0].message


def test_the_full_contract_suite_is_clean():
    findings, skipped = C.run_contracts(device="cpu")
    assert findings == [], "\n".join(f.render() for f in findings)
    assert skipped == []


# ---------------------------------------------------------------------------
# lint: planted fixtures, scope, noqa, the clean port
# ---------------------------------------------------------------------------
LINT_FIXTURES = {"RA104": "core/ra104_import_time",
                 "RA107": "core/ra107_unused_import",
                 "RA108": "serve/ra108_wallclock"}


def _fixture(code: str) -> str:
    return os.path.join(FIXTURES, "src", "repro_torch",
                        *LINT_FIXTURES[code].split("/")) + ".py"


@pytest.mark.parametrize("code", sorted(LINT_FIXTURES))
def test_planted_lint_fixture_fires_exactly_its_rule_once(code):
    findings = run_lint([_fixture(code)], root=FIXTURES)
    assert [f.code for f in findings] == [code], findings


def test_ra108_is_scoped_to_the_instrumented_paths(tmp_path):
    src = open(_fixture("RA108")).read()
    elsewhere = tmp_path / "src" / "repro_torch" / "launch"
    elsewhere.mkdir(parents=True)
    (elsewhere / "wallclock.py").write_text(src)
    assert run_lint([str(elsewhere / "wallclock.py")], root=str(tmp_path),
                    only=["RA108"]) == []
    store = tmp_path / "src" / "repro_torch" / "store" / "timing.py"
    store.parent.mkdir(parents=True)
    store.write_text("from time import perf_counter as pc\n\n\n"
                     "def read():\n    return pc()\n")
    assert [f.code for f in run_lint([str(store)], root=str(tmp_path))] \
        == ["RA108"]


@pytest.mark.parametrize("line", [
    "x = torch.zeros(3)  # noqa: RA104 - a CPU constant\n",
    "import os  # noqa: RA107 - kept for its side effect\n",
])
def test_noqa_suppresses(tmp_path, line):
    mod = tmp_path / "src" / "repro_torch" / "core" / "m.py"
    mod.parent.mkdir(parents=True)
    mod.write_text("import torch\n\n" + line + "\n\ndef f():\n"
                   "    return torch\n")
    assert run_lint([str(mod)], root=str(tmp_path)) == []


def test_ra104_allows_metadata_and_flags_device_work(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text(
        "import torch\n\nDEV = torch.device('cpu')\nDT = torch.float32\n"
        "EPS = torch.finfo(torch.float32).eps\nOK = torch.cuda.is_available()"
        "\n\n\nclass F(torch.autograd.Function):\n    @staticmethod\n"
        "    def forward(ctx, x):\n        return torch.zeros(1).cuda()\n\n\n"
        "A = torch.randn(2)\nB = torch.cuda.current_device()\n"
        "C = DEV.to('cpu')\ntorch.manual_seed(0)\n")
    findings = run_lint([str(mod)], root=str(tmp_path), only=["RA104"])
    assert [f.line for f in findings] == [15, 16, 17, 18]


def test_a_syntax_error_is_a_finding(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    assert [f.code for f in run_lint([str(bad)], root=str(tmp_path))] \
        == ["RA100"]


def test_the_port_lints_clean():
    findings = run_lint([os.path.join(ROOT, "src", "repro_torch")],
                        root=ROOT)
    assert findings == [], "\n".join(f.render() for f in findings)


# ---------------------------------------------------------------------------
# baseline, report, CLI
# ---------------------------------------------------------------------------
def test_baseline_round_trip(tmp_path):
    f1 = Finding(code="RA107", where="src/x.py", message="unused import 'os'",
                 line=3)
    f2 = Finding(code="RC202", where="contract:t", message="fp32 leak")
    base = tmp_path / "baseline.txt"
    base.write_text(f"# accepted: legacy debt\n{f1.fingerprint}\n")
    baseline = load_baseline(str(base))
    fresh, known = split_by_baseline([f1, f2], baseline)
    assert fresh == [f2] and known == [f1]
    moved = dataclasses.replace(f1, line=99)   # lines are not fingerprinted
    assert moved.fingerprint in baseline
    assert stale_baseline_entries([f2], baseline) == [f1.fingerprint]
    assert load_baseline(str(tmp_path / "missing.txt")) == set()


def test_report_schema(tmp_path):
    f1 = Finding(code="RA104", where="src/a.py", message="m", line=1)
    path = write_report(str(tmp_path / "r.json"), [f1], {f1.fingerprint},
                        meta={"lanes": ["lint"]})
    body = json.load(open(path))
    assert body == {"meta": {"lanes": ["lint"]},
                    "counts": {"fresh": 0, "baselined": 1}, "skipped": [],
                    "findings": [dict(code="RA104", where="src/a.py",
                                      message="m", line=1, baselined=True)],
                    "stale_baseline": []}


def test_the_ports_baseline_ships_empty():
    assert load_baseline(os.path.join(
        ROOT, "src", "repro_torch", "analysis", "baseline.txt")) == set()


def _cli(*args, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, env=CLI_ENV, cwd=cwd, timeout=180)


def test_cli_exits_nonzero_on_the_planted_fixtures():
    r = _cli("--lint-only", "--root", FIXTURES,
             os.path.join(FIXTURES, "src", "repro_torch"))
    assert r.returncode == 1, r.stdout + r.stderr
    for code in LINT_FIXTURES:
        assert code in r.stdout
    assert "3 finding(s), 0 baselined, 0 skipped" in r.stdout


def test_cli_exits_zero_with_a_baseline(tmp_path):
    fixtures = os.path.join(FIXTURES, "src", "repro_torch")
    findings = run_lint([fixtures], root=FIXTURES)
    base = tmp_path / "baseline.txt"
    base.write_text("# every planted fixture accepted\n" +
                    "".join(f.fingerprint + "\n" for f in findings))
    r = _cli("--lint-only", "--root", FIXTURES, "--baseline", str(base),
             fixtures)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s), 3 baselined" in r.stdout


def test_cli_without_a_card_raises_by_default(monkeypatch):
    monkeypatch.setitem(CLI_ENV, "CUDA_VISIBLE_DEVICES", "")
    r = _cli("--contracts-only", "--quiet")
    assert r.returncode == 1 and "device='cpu'" in r.stderr


def test_cli_on_the_cpu_is_clean(tmp_path):
    """The gate: lint and every contract (the sharded ones in four gloo
    processes), no finding, the report written."""
    os.makedirs(tmp_path / "src")
    os.symlink(os.path.join(ROOT, "src", "repro_torch"),
               tmp_path / "src" / "repro_torch")
    r = _cli("--device", "cpu", "--json", "--root", str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "analysis[lint+contracts]: 0 finding(s), 0 baselined, 0 skipped" \
        in r.stdout
    body = json.load(open(tmp_path / "artifacts" / "analysis"
                          / "torch_report.json"))
    assert body["counts"] == {"fresh": 0, "baselined": 0}
    assert body["meta"] == {"lanes": ["lint", "contracts"], "device": "cpu"}
