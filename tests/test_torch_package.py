"""Package boundaries and the device seam of the PyTorch port.

* No module under ``src/repro_torch/`` and no line of ``chip_smoke.py``
  imports ``jax`` or the JAX package ``repro`` (``repro_torch`` is fine).
* The device is fixed by ``resolve_device`` (``Runtime.simulated`` and the
  LM entry point use it): CUDA by default, and without a card that raises
  unless the caller asks for the CPU; on CUDA, TF32 is off.
* No module of the port calls a library attention
  (``scaled_dot_product_attention``): the flash kernel is the port's own.
* A kernel wrapper runs the plain version only for a CPU tensor; any other
  device that is not CUDA is refused, never served by a fallback.
* ``Kernel`` counts a launch only when the C side reports success.
* The launchers that start or name modules (``launch/chaos.py``, whose
  worker is ``-m repro_torch.launch.chaos``, and ``launch/scenarios.py``)
  name only ``repro_torch`` modules, never the JAX package's.
"""
import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.dist.runtime import Runtime, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.quant import ops as qops
from repro_torch.kernels.spmm import ops as sops
from repro_torch.kernels.spmm.ref import csr_from_edges

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    port = ROOT / "src" / "repro_torch"
    gat = port / "kernels" / "gat"
    assert {gat / "ops.py", gat / "ref.py"} <= set(files)
    front = {port / "obs" / f for f in ("__init__.py", "__main__.py",
                                          "spans.py", "metrics.py",
                                          "export.py")}
    front |= {port / "store" / f for f in ("__init__.py", "backend.py",
                                            "cache.py", "stream.py")}
    front |= {port / "serve" / "server.py", port / "serve" / "loadgen.py",
              port / "launch" / "serve.py"}
    assert front <= set(files)
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for line, mod in _imported_roots(f)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_runtime_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runtime.simulated(4)
    with pytest.raises(RuntimeError):
        Runtime.simulated(4, device="cuda")
    rt = Runtime.simulated(4, device="cpu")
    assert rt.device == torch.device("cpu") and rt.n_parts == 4
    with pytest.raises(ValueError):
        Runtime.simulated(4, device="meta")


def test_resolve_device_is_the_one_device_seam(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for asked in (None, "cuda", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(asked)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device() == torch.device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_port_calls_no_library_attention():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    bad = [str(f.relative_to(ROOT)) for f in files
           if "scaled_dot_product_attention" in f.read_text()]
    assert not bad, bad


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    h = torch.empty(8, 16, device="meta")
    with pytest.raises(ValueError):
        qops.quantize_pack_rows(h, None, 1)
    with pytest.raises(ValueError):
        qops.dequantize_rows(torch.empty(8, 2, dtype=torch.uint8,
                                         device="meta"),
                             torch.empty(8, device="meta"),
                             torch.empty(8, device="meta"), 1, 16)
    csr = csr_from_edges(np.array([0]), np.array([0]), np.ones(1), 1, 8)
    with pytest.raises(ValueError):
        sops.spmm(h, csr)


def test_kernel_counts_only_successful_launches(monkeypatch):
    calls = []

    def fn(*args):
        calls.append(args)
        return rc[0]

    class Lib:
        fake_kernel = fn

        @staticmethod
        def repro_error_string(err):
            return b"invalid argument"

    rc = [0]
    monkeypatch.setattr(build, "load", lambda source: Lib)
    k = build.Kernel("fake_kernel", "quant.cu", [])
    k(1, 2)
    k(3)
    assert k.launches == 2 and calls == [(1, 2), (3,)]
    rc[0] = 1
    with pytest.raises(RuntimeError, match="invalid argument"):
        k(4)
    assert k.launches == 2


def test_build_needs_nvcc_and_hashes_sources(monkeypatch):
    path = build.library_path("quant.cu")
    assert path.parent == build.BUILD_DIR and path.name.startswith("quant-")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("quant.cu") != path
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


def test_nvcc_flags_differ_only_where_the_docstring_says():
    """Every source: sm_90a, -O3, no fast math. The bit-exact sources (quant,
    spmm, gat) add -fmad=false and nothing else; flash has exactly the
    common flags. Each source's flags go into its library hash."""
    common = build.nvcc_flags("flash.cu")
    assert common == build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in common and "-O3" in common
    for src in build.SOURCES:
        flags = build.nvcc_flags(src)
        assert "--use_fast_math" not in flags
        extra = [f for f in flags if f not in common]
        assert extra == (["-fmad=false"] if src in ("quant.cu", "spmm.cu",
                                                    "gat.cu")
                         else []), src
        assert set(common) <= set(flags)
    assert set(build.BIT_EXACT) == {"quant.cu", "spmm.cu", "gat.cu"}
    doc = build.__doc__
    assert "-fmad=false" in doc and "flash.cu" in doc and "gat.cu" in doc


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    assert chip_smoke.main() != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_chip_smoke_fails_without_the_repo(tmp_path):
    """Alone in a directory it cannot import the port: it must fail."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _code_strings(path: Path):
    """String constants of ``path`` that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_launchers_spawn_and_name_only_port_modules():
    from repro_torch.launch import chaos
    launch = ROOT / "src" / "repro_torch" / "launch"
    for name in ("chaos.py", "scenarios.py"):
        strings = _code_strings(launch / name)
        bad = [v for v in strings if re.search(r"\brepro\.", v)]
        assert not bad, (name, bad)
    assert chaos.WORKER == "repro_torch.launch.chaos"
    args = chaos.build_parser().parse_args(["--kill-resume", "--device",
                                            "cpu"])
    cmd = chaos._worker_cmd(args, "ckpt", [])
    assert cmd[:4] == [sys.executable, "-m", "repro_torch.launch.chaos",
                       "--worker"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    # the worker runs from this checkout's src/, whatever the caller's path
    assert chaos.SRC == ROOT / "src"
