#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``[sharded]`` phase alone on one CUDA card: build
the kernels, then four ranks on ``cuda:0`` over ``gloo`` (see
``chip_smoke.sharded_phase``).

    python3 tools/torch_sharded_phase.py

The ranks import ``chip_smoke`` again (``torch.multiprocessing``'s spawn),
so this runs under a ``__main__`` guard.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

if __name__ == "__main__":
    t0 = time.perf_counter()
    print(f"[build] {build.build_all():.1f} s", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    chip_smoke.sharded_phase(card.splitlines()[0])
    print(f"total {time.perf_counter() - t0:.1f} s")
