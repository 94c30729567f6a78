"""``correct`` on the CPU at a small size: the reference agrees with the
port, and a run whose timed path is broken underneath comes out not
correct, once for each fault a training cell can have."""
from __future__ import annotations

import json

import pytest

from bench import run as R
from bench.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 101


def _run(root, name, trace=False):
    return R.run(R.load_cell(root, name), SEED, 0.2, trace, "cpu", root)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(small_root, name):
    res = _run(small_root, name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    for c in res["checks"].values():
        assert c["value"] < 1e-5
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"epoch_ms", "peak_gb", "setup_s"}


def test_traced_run_reads_the_host_metrics(small_root):
    res = _run(small_root, "graphsage-reddit-sylvie_a", trace=True)
    assert res["correct"]
    assert res["metrics"]["trainer.host_ms"]["value"] > 0
    assert res["metrics"]["exchange.wire_mb"]["value"] > 0
    # a CPU run reads no device metric
    assert "spmm.device_ms" not in res["metrics"]


def _unchanged(mp):
    from repro_torch.train import optimizer
    mp.setattr(optimizer, "apply_updates", lambda params, updates: params)


def _half_batch(mp):
    import torch
    from repro_torch.train import gnn_step
    loss = gnn_step._masked_loss

    def half(logits, y, mask, backend):
        keep = torch.zeros_like(mask)
        idx = torch.nonzero(mask.reshape(-1)).squeeze(1)
        keep.reshape(-1)[idx[: idx.numel() // 2]] = True
        return loss(logits, y, keep, backend)
    mp.setattr(gnn_step, "_masked_loss", half)


def _no_exchange(mp):
    import torch
    from repro_torch.core import sylvie
    roundtrip = sylvie._q_roundtrip
    mp.setattr(sylvie, "_q_roundtrip",
               lambda buf, *a, **k: torch.zeros_like(roundtrip(buf, *a, **k)))


def _gradient_altered(mp):
    from repro_torch.train import optimizer
    adam = optimizer.adam

    def double_first(tree):
        out = dict(tree)
        key = next(iter(out))
        out[key] = double_first(out[key]) if isinstance(out[key], dict) \
            else 2 * out[key]
        return out

    def altered(*a, **k):
        opt = adam(*a, **k)
        return optimizer.Optimizer(
            opt.init, lambda grads, state, params=None: opt.update(
                double_first(grads), state, params))
    mp.setattr(optimizer, "adam", altered)


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "exchange_left_out": _no_exchange,
          "gradient_altered": _gradient_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["graphsage-reddit-sylvie_a",
                                  "graphsage-reddit-vanilla"])
def test_a_broken_step_is_not_correct(small_root, monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    res = _run(small_root, name)
    assert not res["correct"], res["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_in_tf32_is_not_correct(card, small_root, name):
    """The control: the reference in TF32, put in the program's place, at a
    size a test run holds (the full-size readings are
    ``bench/tools/control.py``'s)."""
    import torch
    from bench.reference import compare
    cell = R.load_cell(small_root, name)
    cfg = cell["config_spec"]
    from bench.lib import graphgen
    from bench.reference import common
    data = {k: v.cpu().numpy() for k, v in
            graphgen.generate(cfg, SEED, card).items()}
    model = R.load_reference(cfg["family"]).Model(cfg, data["x"].shape[1],
                                                  cfg["n_classes"])
    w = common.glorot_params(model.param_shapes(), SEED, card)
    ref = R.reference_epochs(cell, data, w, SEED, card)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low = R.reference_epochs(cell, data, w, SEED, card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ok, _ = compare.judge(compare.training_gaps(low, ref, w), cell["limits"])
    assert not ok


def test_a_reader_that_fails_is_reported_and_left_out(small_root):
    (small_root / "bench" / "metrics" / "trainer.host_ms.py").write_text(
        "def read(run):\n    raise ValueError('broken reader')\n")
    res = _run(small_root, "graphsage-reddit-sylvie_a", trace=True)
    assert res["correct"]
    assert "trainer.host_ms" not in res["metrics"]
    assert "exchange.wire_mb" in res["metrics"]
    assert any("trainer.host_ms" in n and "broken reader" in n
               for n in res["trace_notes"])
