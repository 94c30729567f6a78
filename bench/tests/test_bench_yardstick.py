"""The benchmark's frozen copies: the graph generator, the FLOP counter and
the trace arithmetic."""
from __future__ import annotations

import json

import pytest
import torch

from bench.conftest import ROOT
from bench.lib import flops, graphgen
from bench.lib import trace as T

CONFIGS = ["graphsage-reddit"]


def _cfg(name, **over):
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
def test_generator_gives_the_stated_graph(name):
    # the configuration's widths and degree on fewer nodes, as a CPU holds
    cfg = _cfg(name, n_nodes=3000)
    g = graphgen.generate(cfg, 2**31 + 7, "cpu")
    n = cfg["n_nodes"]
    assert g["x"].shape == (n, cfg["d_feat"]) and g["x"].dtype == torch.float32
    assert int(g["y"].min()) >= 0 and int(g["y"].max()) < cfg["n_classes"]
    assert len(torch.unique(g["y"])) == cfg["n_classes"]
    e = g["src"].numel()
    assert 0.97 * n * cfg["avg_degree"] <= e <= n * cfg["avg_degree"]
    assert bool((g["src"] != g["dst"]).all())
    assert int(g["src"].max()) < n and int(g["dst"].max()) < n
    masks = g["train_mask"].int() + g["val_mask"].int() + g["test_mask"].int()
    assert bool((masks == 1).all())
    assert int(g["train_mask"].sum()) == int(0.6 * n)


def test_generator_is_a_function_of_the_seed():
    cfg = _cfg("graphsage-reddit", n_nodes=500, avg_degree=16)
    a = graphgen.generate(cfg, 3_000_000_001, "cpu")
    b = graphgen.generate(cfg, 3_000_000_001, "cpu")
    c = graphgen.generate(cfg, 3_000_000_002, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["dst"], c["dst"])
    assert a["dst"].numel() == pytest.approx(c["dst"].numel(), rel=0.01)


def test_generator_keeps_the_communities():
    cfg = _cfg("graphsage-reddit", n_nodes=2000, avg_degree=16)
    g = graphgen.generate(cfg, 11, "cpu")
    same = (g["y"][g["src"]] == g["y"][g["dst"]]).float().mean()
    # p_in inside the class, plus chance hits of the rest
    assert float(same) >= cfg["p_in"] - 0.02


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_copy_equals_the_ports(name):
    from repro_torch import configs
    from repro_torch.launch.cells import _gnn_model_flops
    cfg = _cfg(name)
    with torch.device("meta"):
        model = configs.get(cfg["arch"]).config().make(cfg["d_feat"],
                                                       cfg["n_classes"])
    n, e = 1234, 56789
    want = _gnn_model_flops(cfg["arch"], model, n, e, cfg["d_feat"], True)
    got = flops.gnn_train_flops(cfg["family"], n, e, cfg["d_feat"],
                                cfg["d_hidden"], cfg["n_classes"],
                                cfg["n_layers"])
    assert got == want


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert T.union_seconds(iv, 0.0, 5.0) == pytest.approx(3.0)
    assert T.union_seconds(iv, 1.5, 3.5) == pytest.approx(1.0)
    assert T.idle_gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert T.idle_gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def _run(ops, spans=(), **kw):
    base = dict(ops=list(ops), spans=list(spans), t0=0.0, t1=1.0,
                n_epochs=10, wire_bytes=[2e6, 4e6], calls=T.Calls(),
                flops_per_epoch=1e12,
                peaks=T.peaks("NVIDIA H100 80GB HBM3"))
    base.update(kw)
    return T.TracedRun(**base)


def _reader(name):
    from bench import run as R
    return R.load_reader(ROOT, name)


def test_readers_on_a_made_up_trace():
    ops = [("void spmm_units_kernel<4>(...)", 0.0, 0.2),
           ("quantize_pack_staged_kernel", 0.2, 0.25),
           ("unpack_dequantize_kernel", 0.25, 0.3),
           ("sm90_xmma_gemm_f32f32_tn", 0.3, 0.5),
           ("Memcpy DtoD (Device -> Device)", 0.5, 0.6)]
    spans = [{"name": "epoch", "ph": "X", "ts": 0.0, "dur": 0.1},
             {"name": "step", "ph": "X", "ts": 0.01, "dur": 0.08,
              "args": {"mode": "sync"}}]
    run = _run(ops, spans)
    assert _reader("spmm.device_ms")(run) == pytest.approx(20.0)
    assert _reader("lowbit.device_ms")(run) == pytest.approx(10.0)
    assert _reader("gemm.device_ms")(run) == pytest.approx(20.0)
    assert _reader("device.idle_pct")(run) == pytest.approx(40.0)
    assert _reader("device.launches_per_epoch")(run) == pytest.approx(0.4)
    assert _reader("trainer.host_ms")(run) == pytest.approx(20.0)
    assert _reader("exchange.wire_mb")(run) == pytest.approx(3.0)
    assert _reader("mfu_pct")(run) == pytest.approx(100 * 1e13 / 67e12)
    assert _reader("spmm.roofline_pct")(run) is None      # no calls
    bd = T.breakdown(run)
    assert bd["device_ops"][0][0].startswith("void spmm_units_kernel")
    assert bd["idle_gaps"][0] == ["outside any span", pytest.approx(0.4)]
    assert T.span_path(spans, 0.05) == "epoch>step(sync)"


def test_roofline_readers_count_bytes():
    calls = T.Calls(quantize=[(100, 64, 1, True, 2)],
                    dequantize=[(100, 64, 1, 2)])
    run = _run([("quantize_pack_staged_kernel", 0.0, 1e-6)], calls=calls)
    want = 100 * 64 * 8 + 100 * (8 + 4) + 100 * (8 + 4) + 100 * 64 * 4
    got = _reader("lowbit.roofline_pct")(run)
    assert got == pytest.approx(100 * want / 3.35e12 / 1e-6)
    run = _run([], peaks=None)
    assert _reader("mfu_pct")(run) is None


def test_the_trace_is_put_on_the_host_clock_by_either_marker():
    M = T.MARKER
    evs = [(M, 1_000, 10), ("k", 2_000, 500), (M, 9_000, 10)]
    ops, problem = T.place(evs, 5.0, 6.0)
    assert problem is None
    assert ops == [("k", pytest.approx(5.0 + 1e-6),
                    pytest.approx(5.0 + 1.5e-6))]
    # the marker before the window lost: the one after it places the ops
    ops, problem = T.place(evs[1:], 5.0, 5.000007)
    assert problem is None
    assert ops == [("k", pytest.approx(5.0), pytest.approx(5.0 + 5e-7))]
    assert T.place(evs[1:2], 5.0, 6.0) == (
        [], "the device trace holds no marker kernel to put it on the "
        "host's clock")
    assert T.place([evs[0]], 5.0, 6.0) == (
        [], "the device trace holds no device operation")
