"""The port's spans inside the step, their device time on the host clock,
the set-up gauges, and the benchmark's readers of them, on the CPU.

* The tracer: a span given a device that the device clock times records a
  mark at enter and exit; the drain puts the marks on the host clock
  from the latest anchor before each: the one taken at the first such
  span (the one synchronize while spans run), then each ``obs.anchor``
  (the trainer's, after each loss's sync), so a device clock that runs at
  another rate drifts only until the next (``FakeDeviceClock``). A disabled
  tracer, or a device the clock does not time, makes no mark; importing
  ``repro_torch.obs`` imports no ``torch``; the exporter writes the device
  intervals on a track of their own.
* The instrumented step: GraphSAGE under Sylvie-A on
  ``Runtime.simulated(4, device="cpu")`` emits, in a sync and an async step,
  a ``halo`` span for every exchange that ran (site 0's backward in
  neither: its ``h`` is the input, so the async step wires it no ``gslot``),
  an ``agg`` span for every aggregation, and ``wait`` inside ``step``; each
  ``halo`` span's bytes are
  the plan's reckoning (``core.exchange.wire_bytes``) for its exchange.
* The set-up gauges ``setup.normalize_s``, ``setup.partition_s`` and
  ``setup.trainer_s`` are set with tracing off, and with it on are host
  spans too.
* Each new reader of ``bench/metrics/`` on a synthetic ``TracedRun``.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import datasets, obs
from repro_torch.core.exchange import halo_span, wire_bytes
from repro_torch.core.sylvie import SylvieConfig
from repro_torch.dist.runtime import Runtime
from repro_torch.graph import formats, partition
from repro_torch.models.gnn import blocks
from repro_torch.models.gnn.models import GraphSAGE
from repro_torch.obs import export
from repro_torch.policy import builtin as tpol
from repro_torch.train.trainer import GNNTrainer

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import run as R  # noqa: E402
from bench.lib import trace as T  # noqa: E402

CPU = Runtime.simulated(4, device="cpu")
D_HIDDEN = 16


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    obs.disable()
    monkeypatch.setattr(obs.metrics, "REGISTRY", obs.MetricsRegistry())
    yield
    obs.disable()


def test_device_spans_resolve_onto_the_host_clock():
    host = obs.FakeClock(start=10.0)
    rate = 1.0 + 2e-4                   # the device's clock runs fast
    dev = obs.FakeDeviceClock(host, offset=500.0, rate=rate)
    obs.enable(host, device_clock=dev)
    with obs.span("step"):
        host.advance(1.0)
        dev.lag = 0.25              # work queued ahead of the first span
        with obs.span("halo", {"site": 0}, device="cpu"):
            # the first anchor's synchronize waited the lag out
            assert host.t == pytest.approx(11.25)
            host.advance(2.0)
            dev.lag = 0.1
        host.advance(0.5)
        dev.lag = 0.0
        # the caller just waited for the device (a ``torch.device`` keys
        # the same device as the spans' string)
        obs.anchor(torch.device("cpu"))
        with obs.span("agg", None, device="cpu"):
            host.advance(1.0)
            dev.lag = 0.3
    assert dev.syncs == 1 and dev.marks == 6
    host.advance(4.0)
    ev = {e["name"]: e for e in obs.drain()}
    assert dev.syncs == 2
    halo, agg = ev["halo"], ev["agg"]
    assert (halo["ts"], halo["dur"]) == (11.0, 2.25)
    # each mark from its latest anchor: the device clock's drift since
    assert halo["dts"] == pytest.approx(11.25, abs=1e-9)
    assert halo["ddur"] == pytest.approx(2.1 * rate, abs=1e-9)
    assert agg["ts"] == 13.75 and agg["dur"] == 1.0
    assert agg["dts"] == pytest.approx(13.75, abs=1e-9)
    assert agg["ddur"] == pytest.approx(1.3 * rate, abs=1e-9)
    assert "dts" not in ev["step"] and "_marks" not in halo
    assert set(halo) == {"name", "ph", "ts", "dur", "tid", "args", "dts",
                         "ddur"}


def test_disabled_tracer_and_untimed_devices_make_no_marks():
    dev = obs.FakeDeviceClock(obs.FakeClock(), types=("cpu",))
    obs.enable(obs.FakeClock(), device_clock=dev)
    obs.disable()
    x = torch.zeros(3, 4)
    assert obs.span("halo", None, device="cpu") is obs.NULL_SPAN
    assert halo_span(0, "fwd", "quantized", x.device) is obs.NULL_SPAN
    assert blocks._agg_span("fwd", x) is obs.NULL_SPAN
    with obs.span("agg", None, device="cpu"):
        obs.add_arg("halo", "bytes", 8)
    obs.anchor("cpu")
    assert dev.marks == 0 and dev.syncs == 0 and obs.drain() == []
    # a device the clock does not time: a host span, no mark
    dev = obs.FakeDeviceClock(obs.FakeClock(), types=("cuda",))
    obs.enable(obs.FakeClock(tick=1.0), device_clock=dev)
    with obs.span("agg", None, device=x.device):
        pass
    [ev] = obs.drain()
    assert "dts" not in ev and dev.marks == 0 and dev.syncs == 0
    # without an injected clock a CPU span loads no device clock
    tr = obs.enable()
    with obs.span("agg", None, device=x.device):
        pass
    assert tr.device_clock is None and "dts" not in obs.drain()[0]


def test_bytes_go_to_the_innermost_open_halo_span():
    obs.enable(obs.FakeClock(tick=1.0))
    obs.add_arg("halo", "bytes", 1)             # none open: nothing
    with halo_span(0, "fwd", "fresh", "cpu"):
        obs.add_arg("halo", "bytes", 3)
        with halo_span(0, "fwd", "fresh", "cpu"):
            with obs.span("agg"):
                obs.add_arg("halo", "bytes", 5)
            obs.add_arg("halo", "bytes", 7)
    inner, outer = sorted((e for e in obs.drain() if e["name"] == "halo"),
                          key=lambda e: e["dur"])
    assert inner["args"]["bytes"] == 12 and outer["args"]["bytes"] == 3


def test_obs_imports_no_torch_until_a_cuda_span():
    code = ("import sys; import repro_torch.obs as o; o.enable()\n"
            "with o.span('agg', None, device='cpu'): pass\n"
            "print('torch' in sys.modules, "
            "'repro_torch.obs.device' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "False"]


def test_export_writes_the_device_track(tmp_path):
    host = obs.FakeClock(start=1.0)
    obs.enable(host, device_clock=obs.FakeDeviceClock(host))
    with obs.span("step"):
        host.advance(0.5)
        with obs.span("agg", {"dir": "fwd", "width": 8}, device="cpu"):
            host.advance(0.25)
    path = export.write_trace(tmp_path / "t.trace.json", obs.drain())
    events = export.load_trace(path)
    meta = [e for e in events if e["ph"] == "M"]
    assert meta == [{"name": "thread_name", "ph": "M", "pid": 0,
                     "tid": export.DEVICE_TID, "args": {"name": "device"}}]
    dev = [e for e in events if e.get("tid") == export.DEVICE_TID
           and e["ph"] == "X"]
    assert [(e["name"], e["ts"], e["dur"], e["args"]) for e in dev] == [
        ("agg:device", 1_500_000, 250_000, {"dir": "fwd", "width": 8})]
    text = export.render_timeline(path)
    assert "agg:device" in text and "\nagg " in text and "step" in text


@pytest.fixture(scope="module")
def pg(tmp_path_factory):
    pg, _ = datasets.load_partitioned(
        "yelp_like@smoke", n_parts=4,
        cache_dir=tmp_path_factory.mktemp("plans"))
    return pg


def _traced_epochs(pg, mode):
    """Epochs 2 and 3 (sync, then async under ``eps_s = 2``) of GraphSAGE,
    traced under fake host and device clocks."""
    d_in = pg.x.shape[-1]
    tr = GNNTrainer(GraphSAGE(d_in, D_HIDDEN, pg.n_classes), pg,
                    SylvieConfig(mode=mode, bits=1),
                    policy=tpol.BoundedStaleness(eps_s=2, bits=1)
                    if mode == "async" else None, runtime=CPU)
    tr.fit(2)
    host = obs.FakeClock(start=50.0, tick=1e-3)
    obs.enable(host, device_clock=obs.FakeDeviceClock(host))
    tr.fit(2)
    return tr, obs.drain()


def _steps(events):
    """Each ``step`` span with the spans inside it (by host time)."""
    out = []
    for st in (e for e in events if e["name"] == "step"):
        lo, hi = st["ts"], st["ts"] + st["dur"]
        out.append((st, [e for e in events if e is not st
                         and lo <= e["ts"] and e["ts"] + e["dur"] <= hi]))
    return out


def _plan_bytes(tr, site, bits):
    return sum(wire_bytes(tr.block.plan, tr.site_dims[site], bits))


def test_sage_steps_emit_their_exchanges_aggregations_and_wait(pg):
    tr, events = _traced_epochs(pg, "async")
    d = (pg.x.shape[-1], D_HIDDEN)
    assert d[0] != d[1]
    [(sync, s_in), (asy, a_in)] = _steps(events)
    assert (sync["args"], asy["args"]) == ({"mode": "sync"},
                                           {"mode": "async"})
    halos = {m: [(e["args"]["site"], e["args"]["dir"], e["args"]["kind"])
                 for e in inner if e["name"] == "halo"]
             for m, inner in (("sync", s_in), ("async", a_in))}
    assert halos["sync"] == [(0, "fwd", "quantized"), (1, "fwd", "quantized"),
                             (1, "bwd", "quantized")]
    assert halos["async"] == [(0, "fwd", "fresh"), (1, "fwd", "fresh"),
                              (1, "bwd", "stale")]
    aggs = {m: [(e["args"]["dir"], e["args"]["width"])
                for e in inner if e["name"] == "agg"]
            for m, inner in (("sync", s_in), ("async", a_in))}
    assert aggs["sync"] == [("fwd", d[0]), ("fwd", d[1]), ("bwd", d[1])]
    assert aggs["async"] == [("fwd", d[0]), ("fwd", d[1]), ("bwd", d[1])]
    for st, inner in ((sync, s_in), (asy, a_in)):
        [wait] = [e for e in inner if e["name"] == "wait"]
        assert wait["ts"] + wait["dur"] <= st["ts"] + st["dur"]
        assert "dts" not in wait
        for e in inner:
            if e["name"] in ("halo", "agg"):
                assert e["ddur"] >= 0.0 and st["ts"] <= e["dts"]
            if e["name"] == "halo":
                assert e["args"]["bytes"] == _plan_bytes(
                    tr, e["args"]["site"], 1)


def test_vanilla_skips_site_0s_backward_and_ships_float32(pg):
    tr, events = _traced_epochs(pg, "vanilla")
    for _, inner in _steps(events):
        got = [(e["args"]["site"], e["args"]["dir"], e["args"]["bytes"])
               for e in inner if e["name"] == "halo"]
        assert got == [(0, "fwd", _plan_bytes(tr, 0, 32)),
                       (1, "fwd", _plan_bytes(tr, 1, 32)),
                       (1, "bwd", _plan_bytes(tr, 1, 32))]


def test_setup_gauges_are_set_with_tracing_off_and_spans_with_it_on():
    rng = np.random.default_rng(0)
    n = 60
    g = formats.Graph(n, rng.integers(0, n, (2, 400)).astype(np.int32),
                      rng.normal(size=(n, 8)).astype(np.float32),
                      rng.integers(0, 3, n).astype(np.int32),
                      np.ones(n, bool), np.ones(n, bool), np.ones(n, bool),
                      n_classes=3)

    def setup():
        gg, ew = formats.gcn_normalize(g)
        p = partition.partition_graph(gg, 4, edge_weight=ew)
        GNNTrainer(GraphSAGE(8, D_HIDDEN, 3), p, runtime=CPU)

    names = ("setup.normalize_s", "setup.partition_s", "setup.trainer_s")
    setup()
    gauges = obs.snapshot()["gauges"]
    assert all(gauges[k] > 0.0 for k in names)
    obs.enable(obs.FakeClock(tick=1.0))
    setup()
    spans = [e for e in obs.drain() if e["name"].startswith("setup.")]
    assert [e["name"] for e in spans] == list(names)
    gauges = obs.snapshot()["gauges"]
    # with no clock read inside: the gauge's two reads, one tick apart, in
    # the span's four
    assert (gauges["setup.normalize_s"], spans[0]["dur"]) == (1.0, 3.0)


def _run(spans, n_epochs=2):
    return T.TracedRun(ops=[], spans=spans, t0=0.0, t1=1.0,
                       n_epochs=n_epochs, wire_bytes=[], calls=T.Calls(),
                       flops_per_epoch=0.0, peaks=None)


def _span(name, ts, dur, args=None, ddur=None):
    ev = {"name": name, "ph": "X", "ts": ts, "dur": dur, "tid": 1}
    if args:
        ev["args"] = args
    if ddur is not None:
        ev["dts"], ev["ddur"] = ts + 1e-4, ddur
    return ev


def _read(metric, spans):
    return R.load_reader(ROOT, metric)(_run(spans))


def test_exchange_readers_take_outermost_device_time_and_all_bytes():
    spans = [_span("halo", 0.0, 0.010, {"bytes": 0}, 0.004),
             _span("halo", 0.001, 0.002, {"bytes": 100}, 0.003),  # nested
             _span("agg", 0.012, 0.003, {"dir": "fwd"}, 0.002),
             _span("halo", 0.020, 0.001, {"bytes": 50}, 0.002)]
    assert _read("exchange.device_ms", spans) == pytest.approx(3.0)
    assert _read("exchange.moved_mb", spans) == pytest.approx(75e-6)
    assert _read("aggregation.device_ms", spans) == pytest.approx(1.0)
    host_only = [{k: v for k, v in e.items() if k not in ("dts", "ddur")}
                 for e in spans]
    assert _read("exchange.device_ms", host_only) is None
    assert _read("aggregation.device_ms", host_only) is None
    assert _read("exchange.moved_mb", host_only) == pytest.approx(75e-6)
    for metric in ("exchange.device_ms", "exchange.moved_mb",
                   "aggregation.device_ms"):
        assert _read(metric, [_span("step", 0.0, 1.0)]) is None


def test_dispatch_reader_takes_each_step_less_its_wait():
    spans = [_span("epoch", 0.0, 0.05), _span("step", 0.001, 0.040),
             _span("wait", 0.031, 0.010),
             _span("step", 0.100, 0.020), _span("wait", 0.110, 0.006)]
    assert _read("trainer.dispatch_ms", spans) == pytest.approx(
        (30.0 + 14.0) / 2)
    # a program without the wait span: nothing to read
    assert _read("trainer.dispatch_ms", spans[:2]) is None


@pytest.mark.parametrize("name", ["setup.normalize_s", "setup.partition_s",
                                  "setup.trainer_s"])
def test_setup_readers_read_the_gauges(name):
    assert _read(name, []) is None
    obs.gauge(name).set(12.5)
    assert _read(name, []) == 12.5


def test_the_new_metrics_are_listed_with_their_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in bench["workloads"]]
    got = {m["name"]: m for m in bench["per_layer"]}
    for name in ("exchange.device_ms", "exchange.moved_mb",
                 "aggregation.device_ms"):
        assert got[name]["workloads"] == cells
        assert got[name]["moves"] == "epoch_ms"
    for name in ("trainer.dispatch_ms", "setup.normalize_s",
                 "setup.partition_s", "setup.trainer_s"):
        assert "workloads" not in got[name]
        assert callable(R.load_reader(ROOT, name))


def test_span_table_places_kernels_in_their_spans_per_step():
    """``tools/torch_span_table.py``'s ``containment``: a profiler trace
    off the spans by a different offset in each step still places every
    kernel; a kernel past its span's end by more than the slack, or one in
    no span, is counted; a device interval that starts before its host
    start is measured."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import torch_span_table as ST
    finally:
        sys.path.remove(str(ROOT / "tools"))

    spans, ops = [], []
    for k, shift in enumerate((3e-4, -8e-4)):
        t = 1.0 * k
        spans.append(_span("step", t, 0.5, {"mode": "sync"}))
        spans.append(_span("halo", t + 0.01, 0.01,
                           {"site": 0, "dir": "fwd", "kind": "fresh"}, 0.010))
        spans.append(_span("agg", t + 0.03, 0.01,
                           {"dir": "fwd", "width": 8}, 0.020))
        for ev in spans[-2:]:
            ev["dts"] = ev["ts"] + 0.001
        ops += [("quantize_pack_rows", t + 0.0112 + shift, t + 0.0150 + shift),
                ("spmm_units_kernel", t + 0.0310 + shift, t + 0.0480 + shift),
                ("spmm_combine_kernel", t + 0.0480 + shift,
                 t + 0.0509 + shift),
                ("elementwise_kernel", t + 0.0115 + shift,
                 t + 0.0120 + shift)]
    got = ST.containment(ops, spans)
    assert (got["kernels"], got["outside"], got["unmatched"]) == (6, 0, 0)
    assert got["step_offset_us"] == pytest.approx([-800.0, 300.0])
    rows = ST.table(ops, spans)["sync"]
    assert rows["steps"] == 2
    agg, halo = rows["spans"]["agg fwd width 8"], \
        rows["spans"]["halo site 0 fwd fresh"]
    assert agg["spmm_ms"] == pytest.approx(19.9)
    assert (halo["lowbit_ms"], halo["other_ms"]) == pytest.approx((3.8, 0.5))
    ops.append(("spmm_combine_kernel", 1.0509 - 8e-4, 1.0515 - 8e-4))
    got = ST.containment(ops, spans)
    assert got["outside"] == 1 and got["outside_max_us"] == pytest.approx(
        500.0)
    assert got["early_max_us"] == pytest.approx(-1000.0)
    spans[-1]["dts"] = spans[-1]["ts"] - 5e-5
    assert ST.containment(ops, spans)["early_max_us"] == pytest.approx(50.0)
