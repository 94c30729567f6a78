#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s DLRM phases alone on one CUDA card: build the
kernels, then ``[dlrm]`` (one process, ``chip_smoke.dlrm_phase``) and
``[dlrm-sharded]`` (four ranks on ``cuda:0`` over ``gloo``,
``chip_smoke.dlrm_sharded_phase``), or the one named.

    python3 tools/torch_dlrm_phase.py               # both
    python3 tools/torch_dlrm_phase.py sharded       # [dlrm-sharded] only

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

PHASES = {"single": lambda card: chip_smoke.dlrm_phase(
              chip_smoke.kernel_table()),
          "sharded": chip_smoke.dlrm_sharded_phase}

if __name__ == "__main__":
    names = sys.argv[1:] or list(PHASES)
    unknown = set(names) - set(PHASES)
    if unknown:
        sys.exit(f"unknown phase(s) {sorted(unknown)}; known: "
                 f"{sorted(PHASES)}")
    t0 = time.perf_counter()
    print(f"[build] {build.build_all():.1f} s", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(card, flush=True)
    for name in names:
        PHASES[name](card)
    print(f"total {time.perf_counter() - t0:.1f} s")
