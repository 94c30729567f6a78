"""Test settings of the benchmark: its tests import ``bench`` and the port
from this checkout, and those that need a CUDA card carry the ``chip``
marker and skip elsewhere (decided in the ``card`` fixture, never at
import). Run them with ``python -m pytest bench/tests``."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# CPU sizes of the configurations, on graphs a test run can hold; the
# program's model then comes from the registry's reduced entry
SMALL = {
    "graphsage-reddit": dict(n_nodes=400, avg_degree=8, d_feat=24,
                             n_classes=5, d_hidden=16),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def copy_bench(dest: Path) -> Path:
    """A checkout of the benchmark alone at ``dest`` (its ``src`` a link to
    this checkout's), to add files to or resize."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    (dest / "src").symlink_to(ROOT / "src")
    return dest


@pytest.fixture
def small_root(tmp_path, monkeypatch):
    """A copy of the benchmark whose configurations are cut to CPU size, the
    program's registry answering with its reduced entries."""
    from repro_torch import configs
    get = configs.get

    class Reduced:
        def __init__(self, arch):
            self.spec = get(arch)

        def config(self):
            return self.spec.reduced()

    monkeypatch.setattr(configs, "get", Reduced)
    root = copy_bench(tmp_path)
    for name, over in SMALL.items():
        path = root / "bench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(over)
        path.write_text(json.dumps(cfg))
    return root
