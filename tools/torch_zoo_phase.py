#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``[zoo]`` phase alone on one CUDA card: build the
kernels, print the card line, then ``chip_smoke.zoo_phase`` (PNA 4x75,
MeshGraphNet 15x128, SchNet 3x64 and NequIP 5 x 32 trained full-graph at P
= 4, exact launches per step, the seg kernels against their plain versions,
NequIP on ``yelp_like@paper``, card against the CPU on the reduced
configs), or with ``parity`` only the last (``chip_smoke.zoo_parity``).

    python3 tools/torch_zoo_phase.py [parity]
"""
import json
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
    print(f"[card] {card.splitlines()[0]}", flush=True)
    if sys.argv[1:] == ["parity"]:
        print(json.dumps(chip_smoke.zoo_parity()), flush=True)
    else:
        chip_smoke.zoo_phase(chip_smoke.kernel_table())
    print(f"total {time.perf_counter() - t0:.1f} s")
