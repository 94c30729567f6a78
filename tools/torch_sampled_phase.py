#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``[sampled]`` and ``[cells]`` phases and the zoo
of ``[sharded]`` ((g): PNA, MeshGraphNet, SchNet and NequIP over four
``gloo`` ranks against ``Runtime.simulated(4)``) alone on one CUDA card:
build the kernels, print the card line, then the phases asked for (all
three by default).

    python3 tools/torch_sampled_phase.py [sampled] [cells] [zoo]
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

PHASES = ("sampled", "cells", "zoo")

if __name__ == "__main__":
    asked = sys.argv[1:] or list(PHASES)
    unknown = [a for a in asked if a not in PHASES]
    if unknown:
        sys.exit(f"unknown phase(s) {unknown}; pick from {PHASES}")
    t0 = time.perf_counter()
    print(f"[build] {build.build_all():.1f} s", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(f"[card] {card}", flush=True)
    if "sampled" in asked:
        chip_smoke.sampled_phase(chip_smoke.kernel_table())
    if "cells" in asked:
        chip_smoke.cells_phase()
    if "zoo" in asked:
        chip_smoke.sharded_zoo_phase(card)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
