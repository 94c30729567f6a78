#!/usr/bin/env python3
"""The port's Low-bit Module kernels (``quant.cu``) of one tree, on one CUDA card.

    python3 tools/torch_quant_compare.py [--tree DIR] [--out FILE]

``DIR`` is a checkout of this repository (default: the one holding this
script), for instance an earlier commit unpacked with ``git archive``, so that
two designs of the kernels are compared in one run on one card: run it for
each tree in turns (old, new, new, old). For that tree it

1. compiles ``DIR``'s ``quant.cu`` to a cubin with its own flags and
   ``-Xptxas -v``: registers and spill bytes of each kernel; and, from
   ``cuobjdump -sass``, the SASS instructions of each 1-bit kernel and of each
   loop in it (a backward branch and the instructions it jumps over);
2. builds ``DIR``'s quant and SpMM kernels, serves ``reddit_like@paper`` as
   ``chip_smoke.py`` does (GCN 256x2, 4 partitions, 1-bit deterministic
   halos, seed 0) and profiles one full sweep after a warm one: device
   launches, device-busy milliseconds, launches by kernel;
3. times quantize (deterministic and stochastic) and dequantize at both of
   the sweep's exchange sites, on the sweep's own boundary rows, as device
   milliseconds per launch from ``torch.profiler`` (``chip_smoke.device_ms``),
   with scale/zero in float32 (every design) and bfloat16 (where the tree's
   wrappers take it).

Prints one JSON line (also written to ``FILE`` when given, with the 1-bit
kernels' SASS beside it as ``FILE`` with the suffix ``.sass``). Needs a card and
the CUDA toolkit (``nvcc``, ``cuobjdump``).
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def _tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(found).exists():
        raise RuntimeError(f"{name} not found")
    return found


def _demangle(names: list[str]) -> dict[str, str]:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True).stdout
        return dict(zip(names, out.splitlines()))
    except (OSError, subprocess.CalledProcessError):
        return {n: n for n in names}


def ptxas_and_sass(build, sass_out=None) -> dict:
    """Registers / spills of every kernel of the tree's quant.cu, and SASS
    instruction counts of its 1-bit kernels, whose SASS listing goes to
    ``sass_out`` when given."""
    flags = [f for f in build.nvcc_flags("quant.cu")
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "quant.cubin"
        res = subprocess.run([_tool("nvcc"), *flags, "-cubin", "-Xptxas", "-v",
                              "-o", str(cubin), str(build.CSRC / "quant.cu")],
                             capture_output=True, text=True, check=True)
        sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
    regs, name = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            regs[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            regs[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name]["registers"] = int(m.group(1))

    funcs, listing, name = {}, [], None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        if name and "ILi1E" in name:      # the 1-bit instances only
            listing.append(line)
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(2).strip()))
    if sass_out:
        sass_out.parent.mkdir(parents=True, exist_ok=True)
        sass_out.write_text("\n".join(listing) + "\n")
    counts = {}
    for fname, insts in funcs.items():
        if "ILi1E" not in fname:
            continue
        real = [(a, t) for a, t in insts if not t.startswith("NOP")]
        loops = []
        for addr, text in real:
            m = re.search(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                start = int(m.group(1), 16)
                if start != addr:
                    loops.append(sum(start <= a <= addr for a, _ in real))
        counts[fname] = {"instructions": len(real), "loops": loops}
    names = _demangle(sorted(set(regs) | set(counts)))
    return {"ptxas": {names[k]: v for k, v in regs.items()},
            "sass_1bit": {names[k]: v for k, v in counts.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_quant_compare: no CUDA device available", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(tree / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_ms
    from repro_torch import datasets
    from repro_torch.core.exchange import gather_boundary
    from repro_torch.dist.runtime import Runtime
    from repro_torch.kernels import build
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.models.gnn.models import GCN
    from repro_torch.serve import InferenceEngine, ServeConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = {"tree": str(tree), "card": card, **ptxas_and_sass(
        build, args.out.with_suffix(".sass") if args.out else None)}
    build.build_all(("quant.cu", "spmm.cu"))

    pg = datasets.load_partitioned("reddit_like@paper", n_parts=4)
    model = GCN(pg.x.shape[-1], 256, pg.n_classes, n_layers=2,
                generator=torch.Generator().manual_seed(0))
    eng = InferenceEngine(model, pg, config=ServeConfig(bits=1),
                          runtime=Runtime.simulated(4), seed=0)
    eng.full_sweep()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.full_sweep()
    on_dev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    out["sweep"] = {
        "device_launches": sum(e.count for e in on_dev),
        "device_busy_ms": sum(e.self_device_time_total for e in on_dev) / 1e3,
        "launches_by_kernel": {e.key[:90]: e.count for e in sorted(
            on_dev, key=lambda e: -e.count)}}

    dtypes = [torch.float32]
    if hasattr(qops, "SCALE_DTYPES"):
        dtypes.append(torch.bfloat16)
    for site, h in enumerate(eng._layers):
        buf = gather_boundary(h, eng.block.plan).reshape(-1, h.shape[-1])
        buf = buf.contiguous()
        u = torch.rand(buf.shape, device=buf.device,
                       generator=torch.Generator("cuda").manual_seed(site))
        rows, d = buf.shape
        times = {"shape": [rows, d]}
        for dt in dtypes:
            extra = () if dt == torch.float32 else (dt,)
            tag = str(dt).split(".")[-1]
            pk, sk, zk = qops.quantize_pack_rows(buf, None, 1, *extra)
            times[f"quantize_{tag}_ms"] = device_ms(
                lambda: qops.quantize_pack_rows(buf, None, 1, *extra),
                "quantize_pack", iters=50)
            times[f"quantize_stochastic_{tag}_ms"] = device_ms(
                lambda: qops.quantize_pack_rows(buf, u, 1, *extra),
                "quantize_pack", iters=50)
            times[f"dequantize_{tag}_ms"] = device_ms(
                lambda: qops.dequantize_rows(pk, sk, zk, 1, d),
                "unpack_dequantize_kernel", iters=50)
        out[f"site{site}"] = times
    line = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
