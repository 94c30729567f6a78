#!/usr/bin/env python3
"""Time the flash kernel of several source trees in turns in one process on
one CUDA card.

    python3 tools/torch_flash_ab.py TAG=DIR [TAG=DIR ...] [--rounds 4]
                                    [--out FILE]

Each ``DIR`` is the root of a checkout of this repository (this one, ``.``,
or an earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Its ``src/repro_torch/kernels/csrc/flash.cu`` is
compiled with the flags ``repro_torch.kernels.build`` gives ``flash.cu``,
plus ``-Xptxas -v``, into ``build/flash_ab/TAG.so``, every tree at once; the
registers and spills of each float32 instance are printed. The C entry
point is bound by the signature its source declares (with or without the
value width and the softcap).

Cases, float32 from a seeded generator:

* ``granite raw`` — ``flash_fwd``'s raw (acc, m, l) over granite-3-2b's
  prefill heads, (8 * 32, 2,048, 64), causal, scale 1/8: the call
  ``chip_smoke.py``'s ``[flash]`` times as the kernel's ``ms``;
* ``granite bshd`` — the model's call, (8, 2,048, 32 / 8 heads, 64),
  normalised;
* ``gemma2 local`` — gemma2-27b's local layer, (2, 6,144, 32 / 16 heads,
  128), window 4,096, softcap 50, normalised (trees whose kernel takes a
  softcap only).

In each of ``--rounds`` rounds every tree runs every case, in the order of
the arguments and then reversed (A B B A), 20 back-to-back calls timed by
CUDA events. Prints the median, least and largest ms per tree and case,
each output's largest difference from the first tree's, the card line, and
one JSON line (also written to ``FILE`` when given).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
from repro_torch.kernels import build  # noqa: E402
from torch_timing import cuda_ms  # noqa: E402

SEED = 0
_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
# flash_fwd's arguments, without and with (dv, softcap)
ARGS_OLD = [_P] * 6 + [_I, _I64, _I, _I, _I64, _I64, _I, _P, _F, _I, _I64,
                       _I64, _I, _P]
ARGS_NEW = [_P] * 6 + [_I, _I64, _I, _I, _I64, _I64, _I, _I, _P, _F, _F, _I,
                       _I64, _I64, _I, _P]
# (tag, batch, seq, heads, kv heads, d, window, softcap, raw)
CASES = (("granite raw", 256, 2048, 1, 1, 64, None, None, True),
         ("granite bshd", 8, 2048, 32, 8, 64, None, None, False),
         ("gemma2 local", 2, 6144, 32, 16, 128, 4096, 50.0, False))


def compile_trees(trees: dict) -> dict:
    """{tag: (library, takes a softcap)}; prints ptxas's float32 lines."""
    out_dir = ROOT / "build" / "flash_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, root in trees.items():
        src = root / "src/repro_torch/kernels/csrc/flash.cu"
        procs[tag] = (src, subprocess.Popen(
            [build.nvcc_path(), *build.nvcc_flags("flash.cu"), "-Xptxas",
             "-v", "-o", str(out_dir / f"{tag}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log)
            raise SystemExit(f"{tag}: nvcc failed")
        name = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\w*flash_fwd_kernelI(f\w*)"
                          r"EEvNS_6ParamsE'", line)
            if "Compiling entry" in line:
                name = m.group(1) if m else None
            elif name and ("registers" in line or "spill" in line):
                print(f"[ptxas {tag}] {name}: "
                      f"{line.split(':', 1)[-1].strip()}")
        new = "float softcap" in src.read_text()
        lib = ctypes.CDLL(str(out_dir / f"{tag}.so"))
        lib.flash_fwd.argtypes = ARGS_NEW if new else ARGS_OLD
        lib.flash_fwd.restype = ctypes.c_int
        libs[tag] = (lib, new)
    return libs


def make_case(b, s, h, hkv, d, raw):
    gen = torch.Generator("cuda").manual_seed(SEED)
    shape = (b, s, d) if raw else None
    q = torch.randn(shape or (b, s, h, d), generator=gen, device="cuda")
    k = torch.randn(shape or (b, s, hkv, d), generator=gen, device="cuda")
    v = torch.randn(shape or (b, s, hkv, d), generator=gen, device="cuda")
    return q, k, v


def caller(lib, new, case, tensors):
    """A zero-argument call of one tree's kernel on ``tensors``; its
    output."""
    _, b, s, h, hkv, d, window, cap, raw = case
    q, k, v = tensors
    out = torch.empty_like(q)
    if raw:
        m = torch.empty((b, s), device="cuda")
        l = torch.empty((b, s), device="cuda")
        strides = [q.stride(0), q.stride(1), 0, k.stride(0), k.stride(1), 0,
                   v.stride(0), v.stride(1), 0, s * d, d, 0]
        ptr_m, ptr_l, heads, kv_heads = m.data_ptr(), l.data_ptr(), 1, 1
    else:
        strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                   *out.stride()[:3]]
        ptr_m = ptr_l = None
        heads, kv_heads = h, hkv
    arr = (ctypes.c_int64 * 12)(*strides)
    stream = torch.cuda.current_stream().cuda_stream
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ptr_m,
            ptr_l, 0, b, heads, kv_heads, s, s, d]
    tail = [int(not raw), stream]
    win = 0 if window is None else window
    if new:
        args = head + [d, arr, d ** -0.5, float(cap or 0.0), 1, win, s] + tail
    else:
        args = head + [arr, d ** -0.5, 1, win, s] + tail

    def run():
        err = lib.flash_fwd(*args)
        if err:
            raise RuntimeError(f"flash_fwd returned CUDA error {err}")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="TAG=DIR")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args()
    trees = {}
    for spec in args.trees:
        tag, _, path = spec.partition("=")
        trees[tag] = (ROOT / path).resolve()
    libs = compile_trees(trees)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"[card] {card.splitlines()[0]}", flush=True)
    res = {}
    for case in CASES:
        tag_c = case[0]
        tensors = make_case(*case[1:6], case[8])
        runs = {t: caller(*libs[t], case, tensors) for t in libs
                if libs[t][1] or case[7] is None}
        first = None
        diff = {}
        for t, run in runs.items():
            o = run().clone()
            torch.cuda.synchronize()
            if first is None:
                first = o
            diff[t] = float((o - first).abs().max())
        times = {t: [] for t in runs}
        order = list(runs)
        for _ in range(args.rounds):
            for t in order + order[::-1]:
                times[t].append(cuda_ms(runs[t], iters=20, warmup=3))
        res[tag_c] = {t: dict(median_ms=float(np.median(ts)),
                              min_ms=min(ts), max_ms=max(ts),
                              max_abs_diff=diff[t], ms=ts)
                      for t, ts in times.items()}
        for t, r in res[tag_c].items():
            print(f"[flash-ab] {tag_c} {t}: median {r['median_ms']:.4f} ms "
                  f"(min {r['min_ms']:.4f}, max {r['max_ms']:.4f}; "
                  f"{len(r['ms'])} turns), max abs diff from "
                  f"{order[0]} {r['max_abs_diff']:.3g}", flush=True)
        del tensors, runs
        torch.cuda.empty_cache()
    line = json.dumps(dict(card=card.splitlines()[0], cases=res))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
