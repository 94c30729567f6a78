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

Backward cases, the pair ``flash_bwd_dq`` then ``flash_bwd_dkdv`` of each
tree's ``csrc/flash_bwd.cu`` (compiled the same way; trees without one are
left out of them) on the same inputs and the same forward output and lse
(this checkout's ``flash_fwd``), causal, float32:

* ``bwd granite`` — granite-3-2b's training call, (4, 2,048, 32 / 8 heads,
  64), scale 1/8;
* ``bwd d 128`` — (4, 2,048, 32 / 32 heads, 128);
* ``bwd MLA`` — deepseek-v2's MLA, (8, 2,048, 128 / 128 heads, q/k 192, v
  128, v a column slice of kv);
* ``bwd gemma2 local`` — gemma2-27b's local layer, (2, 6,144, 32 / 16
  heads, 128), window 4,096, softcap 50.

Each tree's dq, dk and dv must agree with the first tree's within
``chip_smoke.FLASH_BWD_TOL`` x the largest magnitude, or the script exits 1.

In each of ``--rounds`` rounds every tree runs every case, in the order of
the arguments and then reversed (A B B A), back-to-back calls timed by CUDA
events (20 a turn for the forward; for the backward as many as take about
a second, 3 to 20). ``--only fwd`` or ``--only bwd`` runs one kind. Prints
the median, least and largest ms per tree and case, each output's largest
difference from the first tree's, the card line, and one JSON line (also
written to ``FILE`` when given).
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
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
from chip_smoke import FLASH_BWD_TOL  # noqa: E402
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
# flash_bwd_dq / flash_bwd_dkdv's arguments (kernels/flash/ops.py)
ARGS_BWD = [_P] * 10 + [_I64, _I, _I, _I64, _I64, _I, _I, _P, _F, _F, _I,
                        _I64, _I64, _P]
# (tag, batch, seq, heads, kv heads, d, dv, window, softcap)
BWD_CASES = (("bwd granite", 4, 2048, 32, 8, 64, 64, None, None),
             ("bwd d 128", 4, 2048, 32, 32, 128, 128, None, None),
             ("bwd MLA", 8, 2048, 128, 128, 192, 128, None, None),
             ("bwd gemma2 local", 2, 6144, 32, 16, 128, 128, 4096, 50.0))


def ptxas_lines(tag: str, log: str, kernel: str) -> None:
    """Print ptxas's registers and spills of each kernel whose mangled name
    matches the pattern ``kernel`` in ``log``."""
    name = None
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(rf"Compiling entry function '\w*({kernel}\w*)'",
                          line)
            name = m.group(1) if m else None
        elif name and ("registers" in line or "spill" in line):
            print(f"[ptxas {tag}] {name}: "
                  f"{line.split(':', 1)[-1].strip()}", flush=True)


def compile_bwd(trees: dict) -> dict:
    """{tag: library} of each tree's flash_bwd.cu; prints ptxas's lines."""
    out_dir = ROOT / "build" / "flash_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, root in trees.items():
        src = root / "src/repro_torch/kernels/csrc/flash_bwd.cu"
        if not src.exists():
            continue
        procs[tag] = subprocess.Popen(
            [build.nvcc_path(), *build.nvcc_flags("flash_bwd.cu"), "-Xptxas",
             "-v", "-o", str(out_dir / f"{tag}_bwd.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for tag, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log)
            raise SystemExit(f"{tag}: nvcc failed on flash_bwd.cu")
        ptxas_lines(tag, log, r"flash_bwd_\w+_kernel")
        lib = ctypes.CDLL(str(out_dir / f"{tag}_bwd.so"))
        for fn in (lib.flash_bwd_dq, lib.flash_bwd_dkdv):
            fn.argtypes = ARGS_BWD
            fn.restype = ctypes.c_int
        libs[tag] = lib
    return libs


def bwd_caller(lib, inputs, case):
    """A zero-argument call of one tree's backward pair; its (dq, dk, dv)."""
    from repro_torch.kernels.flash import ops as fops
    _, b, s, h, hkv, d, dv, window, cap = case
    q, k, v, o, lse, d_out = inputs
    args, keep = fops.bwd_launch_args(q, k, v, o, lse, d_out, causal=True,
                                      window=window, softcap=cap, kv_len=s,
                                      scale=d ** -0.5)

    def run():
        for fn in (lib.flash_bwd_dq, lib.flash_bwd_dkdv):
            err = fn(*args)
            if err:
                raise RuntimeError(f"{fn.__name__} returned CUDA error {err}")
        return keep[:3]
    return run


def make_bwd_case(b, s, h, hkv, d, dv, window, cap):
    """Seeded inputs and this checkout's forward output and lse."""
    from repro_torch.kernels.flash import ops as fops
    gen = torch.Generator("cuda").manual_seed(SEED)
    q = torch.randn(b, s, h, d, generator=gen, device="cuda")
    k = torch.randn(b, s, hkv, d, generator=gen, device="cuda")
    if dv < d:      # MLA: v a column slice of kv, as the model's
        v = torch.randn(b, s, hkv, 2 * dv, generator=gen,
                        device="cuda")[..., dv:]
    else:
        v = torch.randn(b, s, hkv, dv, generator=gen, device="cuda")
    d_out = torch.randn(b, s, h, dv, generator=gen, device="cuda")
    o, lse = fops._bshd_fwd(q, k, v, causal=True, window=window,
                            softcap=cap, q_offset=0, kv_len=s, block=1024,
                            scale=d ** -0.5, with_lse=True)
    return q, k, v, o, lse, d_out


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
        ptxas_lines(tag, log, "flash_fwd_kernelIf")
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


def time_in_turns(runs: dict, rounds: int, iters: int) -> dict:
    """{tree: [ms of each turn]}: every tree in the order given, then
    reversed (A B B A), ``rounds`` times."""
    times = {t: [] for t in runs}
    order = list(runs)
    for _ in range(rounds):
        for t in order + order[::-1]:
            times[t].append(cuda_ms(runs[t], iters=iters, warmup=3))
    return times


def report(tag_c: str, times: dict, diff: dict) -> dict:
    order = list(times)
    res = {t: dict(median_ms=float(np.median(ts)), min_ms=min(ts),
                   max_ms=max(ts), max_abs_diff=diff[t], ms=ts)
           for t, ts in times.items()}
    for t, r in res.items():
        print(f"[flash-ab] {tag_c} {t}: median {r['median_ms']:.4f} ms "
              f"(min {r['min_ms']:.4f}, max {r['max_ms']:.4f}; "
              f"{len(r['ms'])} turns), max abs diff from "
              f"{order[0]} {r['max_abs_diff']:.3g}", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="TAG=DIR")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--only", choices=("fwd", "bwd"))
    ap.add_argument("--out")
    args = ap.parse_args()
    trees = {}
    for spec in args.trees:
        tag, _, path = spec.partition("=")
        trees[tag] = (ROOT / path).resolve()
    libs = compile_trees(trees) if args.only != "bwd" else {}
    bwd_libs = compile_bwd(trees) if args.only != "fwd" else {}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"[card] {card.splitlines()[0]}", flush=True)
    res = {}
    agree = True
    for case in CASES if libs else ():
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
        res[tag_c] = report(tag_c, time_in_turns(runs, args.rounds, 20),
                            diff)
        del tensors, runs
        torch.cuda.empty_cache()
    for case in BWD_CASES if bwd_libs else ():
        tag_c = case[0]
        inputs = make_bwd_case(*case[1:])
        runs = {t: bwd_caller(lib, inputs, case) for t, lib in bwd_libs.items()}
        first = None
        diff = {}
        for t, run in runs.items():
            got = [x.clone() for x in run()]
            torch.cuda.synchronize()
            if first is None:
                first = got
            diff[t] = max(float((a - w).abs().max() / w.abs().max())
                          for a, w in zip(got, first))
            if diff[t] > FLASH_BWD_TOL:
                print(f"[flash-ab] {tag_c} {t}: dq, dk or dv "
                      f"{diff[t]:.3g} x the largest from {list(runs)[0]}'s, "
                      f"beyond {FLASH_BWD_TOL}", flush=True)
                agree = False
        once = min(cuda_ms(run, iters=1, warmup=1) for run in runs.values())
        iters = max(3, min(20, round(1000 / max(once, 1e-3))))
        res[tag_c] = report(tag_c, time_in_turns(runs, args.rounds, iters),
                            diff)
        del inputs, runs, first, got
        torch.cuda.empty_cache()
    line = json.dumps(dict(card=card.splitlines()[0], cases=res,
                           bwd_agree=agree))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
