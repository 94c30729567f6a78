#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s LM checks of the MoE, MLA and softcapped models,
and of LM training, alone on one CUDA card: build the kernels, print the
card line, then any of

* ``flash`` — ``chip_smoke.flash_lm_shapes``: the flash kernel at gemma2's
  and deepseek-v2's layer shapes against its plain version, timed;
* ``small`` — ``chip_smoke.lm_small_phase``: every LM's reduced config on
  the card against the CPU;
* ``moe`` — ``chip_smoke.lm_moe_phase``: olmoe-1b-7b, deepseek-v2-236b and
  gemma2-27b served at published widths (``LM_MOE_RUNS``);
* ``flash-bwd`` — ``chip_smoke.flash_bwd_phase``: the flash backward
  kernels at ``FLASH_BWD_SHAPES`` against their plain version, timed;
* ``train`` — ``chip_smoke.lm_train_phase``: granite-3-2b, olmoe-1b-7b,
  gemma2-27b and deepseek-v2-236b trained at published widths
  (``LM_TRAIN_RUNS``);

all five by default, in that order.

    python3 tools/torch_lm_phase.py [flash] [small] [moe] [flash-bwd] [train]
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

PARTS = ("flash", "small", "moe", "flash-bwd", "train")

if __name__ == "__main__":
    parts = sys.argv[1:] or list(PARTS)
    if not set(parts) <= set(PARTS):
        raise SystemExit(f"parts must be among {PARTS}, got {parts}")
    t0 = time.perf_counter()
    print(f"[build] {build.build_all():.1f} s", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"[card] {card.splitlines()[0]}", flush=True)
    if "flash" in parts:
        chip_smoke.flash_lm_shapes()
    if "small" in parts:
        chip_smoke.lm_small_phase()
    if "moe" in parts:
        res = chip_smoke.lm_moe_phase(chip_smoke.kernel_table())
        print(json.dumps(res), flush=True)
    if "flash-bwd" in parts:
        chip_smoke.flash_bwd_phase()
    if "train" in parts:
        res = chip_smoke.lm_train_phase(chip_smoke.kernel_table())
        print(json.dumps(res), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s")
