"""The harness finds its cells, configurations, traffic and readers by name,
and a cell or metric added as files is found without editing any."""
from __future__ import annotations

import ast
import json
import sys
from pathlib import Path

import pytest

from bench import run as R
from bench.conftest import ROOT, copy_bench

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = R.load_cell(ROOT, name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell["config"] == entry["config"]
    assert cell["traffic"] == entry["traffic"]
    assert cell["chips"] == entry["chips"]
    assert set(cell["limits"]) == {"loss", "grad", "delta"}
    cfg = cell["config_spec"]
    for key in ("source", "reduced", "assumed", "family", "arch"):
        assert key in cfg, key
    for key in ("mode", "bits", "eps_s", "n_parts", "warmup_epochs"):
        assert key in cell["traffic_spec"], key
    assert cell["traffic_spec"]["warmup_epochs"] >= 3
    R.load_reference(cfg["family"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry_matches_its_file(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert cfg[key] != cfg["published"][key]


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(R.load_reader(ROOT, metric["name"]))
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_cells_get_their_metrics():
    got = {c: [m["name"] for m in R.cell_metrics(ROOT, c)] for c in CELLS}
    assert "lowbit.device_ms" not in got["graphsage-reddit-vanilla"]
    assert "lowbit.device_ms" in got["graphsage-reddit-sylvie_a"]
    assert "spmm.device_ms" in got["graphsage-reddit-vanilla"]


def test_added_cell_and_metric_are_found(tmp_path):
    root = copy_bench(tmp_path)
    (root / "bench" / "traffic" / "sylvie_s.json").write_text(json.dumps(
        {"mode": "sync", "bits": 1, "stochastic": True, "eps_s": None,
         "n_parts": 4, "warmup_epochs": 3}))
    cell = root / "bench" / "workloads" / "graphsage-reddit-sylvie_s.json"
    cell.write_text(
        json.dumps({"config": "graphsage-reddit", "traffic": "sylvie_s",
                    "chips": 1, "limits": {"loss": 1, "grad": 1,
                                           "delta": 1}}))
    (root / "bench" / "metrics" / "device.epochs.py").write_text(
        "def read(run):\n    return run.n_epochs\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(
        {"name": "device.epochs", "unit": "1", "better": "higher",
         "source": "device_trace", "layer": "device", "moves": "epoch_ms",
         "workloads": ["graphsage-reddit-sylvie_s"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = R.load_cell(root, "graphsage-reddit-sylvie_s")
    assert cell["traffic_spec"]["mode"] == "sync"
    names = [m["name"] for m in R.cell_metrics(root, "graphsage-reddit-sylvie_s")]
    assert "device.epochs" in names and "lowbit.device_ms" not in names
    assert R.load_reader(root, "device.epochs")(
        type("Run", (), {"n_epochs": 7})()) == 7


def test_an_optimizer_other_than_adam_is_refused(tmp_path):
    # both sides implement Adam alone: another would run Adam on both
    root = copy_bench(tmp_path)
    path = root / "bench" / "configs" / "graphsage-reddit.json"
    cfg = json.loads(path.read_text())
    cfg["optimizer"] = "sgd"
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="adam"):
        R.load_cell(root, CELLS[0])


@pytest.mark.parametrize("bad", ["../configs/x", "a/b", "", "x y"])
def test_bad_names_are_refused(bad):
    with pytest.raises((ValueError, FileNotFoundError)):
        R.load_cell(ROOT, bad)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(node.args[0].value.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted((ROOT / "bench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    found = _imports(path)
    assert not found & {"jax", "jaxlib", "flax", "repro"}, found
    if "reference" in path.relative_to(ROOT / "bench").parts:
        assert "repro_torch" not in found, found


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert R.forbidden_modules() == ["repro"]


def test_main_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = R.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
