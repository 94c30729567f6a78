#!/usr/bin/env python3
"""Time PNA's max / min aggregation of several source trees in turns on one
CUDA card.

    python3 tools/torch_seg_ab.py TAG=DIR [TAG=DIR ...] [--rounds 4]
                                  [--epochs 10] [--out FILE]

Each ``DIR`` is the root of a checkout of this repository (this one, ``.``,
or an earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Its ``src/repro_torch/kernels/csrc/seg.cu`` is
compiled with the flags ``repro_torch.kernels.build`` gives ``seg.cu``, plus
``-Xptxas -v``, into ``build/seg_ab/TAG.so``, every tree at once; the
registers and spills of each kernel are printed. A tree's source declares
one of two C interfaces, and its path is the one the port ran with it:

* ``seg_max_csr`` (before the fused kernels): the max is ``seg_max(msgs)``,
  the min ``-seg_max(-msgs)`` (the negation forward); the gradient the
  elementwise PyTorch pass of each (the min's through the negation), added;
* ``seg_max_min_csr`` and ``seg_max_min_bwd_csr``: the two kernels, through
  this checkout's wrappers (``kernels/seg/ops.py``) bound to the tree's
  library.

Inputs: PNA 4 x 75 on ``reddit_like@paper`` (``launch.train.gnn_graph``,
P = 4, seed 0): its edge CSR, ReLU'd normal messages (P * E_pad, 75) and the
gradients of max and min as column slices of one (n_rows, 4 * 75) tensor,
as the model hands them, from seeded generators. Every tree's max, min,
counts and gradient must equal the first tree's bit for bit, and a fused
tree's must equal the plain versions (``kernels/seg/ref.py``), also over
``chip_smoke.seg_max_shapes``; otherwise the script exits 1.

In each of ``--rounds`` rounds every tree runs its forward, then its
backward, in the order of the arguments and then reversed (A B B A), 20
calls a turn timed by CUDA events. Then, with ``--epochs N`` (N > 0), each
tree trains PNA 4 x 75 Sylvie-A (``BoundedStaleness(eps_s=4)``, 1 bit, Adam
1e-3) on ``reddit_like@paper`` for N epochs in a process of its own that
imports that tree's package (this script with ``--child``), in turns (A B B
A), and reports its median sync and async epoch ms (host clock ending in
``float(loss)``, epochs 1 to N - 1), its losses, peak GB, and one profiled
sync epoch's device time by group (``chip_smoke.profile_device``). Prints
the card line and one JSON line (also written to ``FILE``).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
_P, _I = ctypes.c_void_p, ctypes.c_int
# seg_max_csr's arguments (the kernel before the fused ones)
ARGS_OLD = [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P]


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def compile_trees(trees: dict) -> dict:
    """{tag: (library, fused)} of each tree's seg.cu; prints ptxas's
    registers and spills."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "seg_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, root in trees.items():
        src = root / "src/repro_torch/kernels/csrc/seg.cu"
        procs[tag] = (src, subprocess.Popen(
            [build.nvcc_path(), *build.nvcc_flags("seg.cu"), "-Xptxas", "-v",
             "-o", str(out_dir / f"{tag}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log)
            raise SystemExit(f"{tag}: nvcc failed on seg.cu")
        name = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\w*?(seg_\w+_kernel)",
                          line)
            if m:
                name = m.group(1)
            elif name and ("registers" in line or "spill" in line):
                print(f"[ptxas {tag}] {name}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"{tag}.so"))
        fused = "seg_max_min_csr" in src.read_text()
        if not fused:
            lib.seg_max_csr.argtypes = ARGS_OLD
            lib.seg_max_csr.restype = ctypes.c_int
        libs[tag] = (lib, fused)
    return libs


@contextlib.contextmanager
def bound_to(lib):
    """This checkout's seg wrappers launching ``lib``'s entry points."""
    from repro_torch.kernels.seg import ops as segops
    kernels = (segops.SEG_MAX_MIN, segops.SEG_MAX_MIN_BWD)
    saved = [k._fn for k in kernels]
    for k in kernels:
        fn = getattr(lib, k.name)
        fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
        k._fn = fn
    try:
        yield segops
    finally:
        for k, fn in zip(kernels, saved):
            k._fn = fn


def old_path(lib, msgs, blk, g_max, g_min):
    """(forward, backward) of the path before the fused kernels: two
    ``seg_max_csr`` calls around the negation; the elementwise gradients."""
    csr = blk.ecsr
    n_rows, d = csr.n_rows, msgs.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    mask = blk.edge_mask.reshape(-1, 1)
    dst = blk.dst_flat

    def seg_max(x):
        out = torch.empty((n_rows, d), device=x.device)
        cnt = torch.empty((n_rows, d), dtype=torch.int32, device=x.device)
        part = torch.empty((csr.n_partials, d), device=x.device)
        part_cnt = torch.empty_like(part, dtype=torch.int32)
        err = lib.seg_max_csr(
            x.data_ptr(), csr.col.data_ptr(), csr.units.data_ptr(),
            csr.units.shape[0], csr.long_rows.data_ptr(),
            csr.long_ptr.data_ptr(), csr.long_rows.shape[0],
            part.data_ptr(), part_cnt.data_ptr(), out.data_ptr(),
            cnt.data_ptr(), n_rows, d, stream)
        if err:
            raise RuntimeError(f"seg_max_csr returned CUDA error {err}")
        return out, cnt

    saved = {}

    def fwd():
        mx, cmx = seg_max(msgs)
        neg = -msgs
        nmx, cmn = seg_max(neg)
        saved.update(mx=mx, cmx=cmx, neg=neg, nmx=nmx, cmn=cmn)
        return mx, cmx, -nmx, cmn

    def vjp(x, out, count, g):
        share = g * torch.reciprocal(count.to(g.dtype))
        hit = mask & (x == out.index_select(0, dst))
        return torch.where(hit, share.index_select(0, dst), 0.0)

    def bwd():
        s = saved
        return vjp(msgs, s["mx"], s["cmx"], g_max) \
            + -vjp(s["neg"], s["nmx"], s["cmn"], -g_min)
    return fwd, bwd


def fused_path(lib, msgs, blk, g_max, g_min):
    """(forward, backward) of the fused kernels of ``lib``."""
    csr = blk.ecsr
    saved = {}

    def fwd():
        with bound_to(lib) as segops:
            outs = segops.seg_max_min(msgs, csr)
        saved["outs"] = outs
        return outs

    def bwd():
        with bound_to(lib) as segops:
            return segops.seg_max_min_bwd(msgs, csr, *saved["outs"], g_max,
                                          g_min, blk.epad)
    return fwd, bwd


def kernel_turns(libs: dict, rounds: int) -> tuple[dict, bool]:
    """Each tree's forward and backward at PNA's shape, checked and timed
    in turns."""
    import chip_smoke
    from repro_torch import configs
    from repro_torch.kernels.seg import ref as segref
    from repro_torch.launch.train import gnn_graph
    from repro_torch.models.gnn import blocks as B
    from torch_timing import cuda_ms

    spec = configs.get("pna").config()
    pg = gnn_graph(spec, "reddit_like@paper", 4, SEED)
    width = spec.make(pg.x.shape[-1], pg.n_classes).d_hidden
    blk = B.build_block(pg, "cuda")
    csr = blk.ecsr
    gen = torch.Generator("cuda").manual_seed(SEED)
    msgs = torch.relu(torch.randn((csr.n_cols, width), generator=gen,
                                  device="cuda"))
    g_max, g_min = chip_smoke.seg_inputs(msgs, csr, SEED + 1)
    print(f"[seg-ab] PNA messages {tuple(msgs.shape)}, {csr.n_rows} rows, "
          f"{csr.nnz} edges, {int(csr.long_rows.numel())} split rows",
          flush=True)
    paths = {tag: (fused_path if fused else old_path)(lib, msgs, blk, g_max,
                                                      g_min)
             for tag, (lib, fused) in libs.items()}
    agree = True
    first = None
    ref = None
    for tag, (fwd, bwd) in paths.items():
        outs = [t.clone() for t in fwd()]
        grad = bwd().clone()
        if first is None:
            first = (outs, grad)
        same = all(chip_smoke.same_bits(a, b) for a, b in zip(
            outs + [grad], first[0] + [first[1]]))
        print(f"[seg-ab] {tag}: max, min, counts and gradient bit-equal to "
              f"{next(iter(paths))}'s: {same}", flush=True)
        agree &= same
        if libs[tag][1]:
            if ref is None:
                outs_ref = segref.seg_max_min_ref(msgs, csr)
                ref = (outs_ref, segref.seg_max_min_vjp_ref(
                    msgs, csr, *outs_ref, g_max, g_min, blk.epad))
            plain = all(chip_smoke.same_bits(a, b) for a, b in zip(
                outs + [grad], list(ref[0]) + [ref[1]]))
            try:
                with bound_to(libs[tag][0]):
                    chip_smoke.seg_max_shapes("cuda")
                shapes = "passed"
            except RuntimeError as e:      # chip_smoke.check's failure
                shapes = str(e)
            print(f"[seg-ab] {tag}: bit-equal to the plain versions: "
                  f"{plain}; over seg_max_shapes: {shapes}", flush=True)
            agree &= plain and shapes == "passed"
    del first, ref
    res = {}
    order = list(paths)
    for kind, k in (("forward", 0), ("backward", 1)):
        times = {t: [] for t in order}
        for _ in range(rounds):
            for t in order + order[::-1]:
                paths[t][0]()          # the backward reads the forward's
                times[t].append(cuda_ms(paths[t][k], iters=20, warmup=3))
        for t, ts in times.items():
            res.setdefault(t, {})[kind] = dict(
                median_ms=float(np.median(ts)), min_ms=min(ts),
                max_ms=max(ts), ms=ts)
            print(f"[seg-ab] {kind} {t}: median {np.median(ts):.4f} ms "
                  f"(min {min(ts):.4f}, max {max(ts):.4f}; {len(ts)} turns)",
                  flush=True)
    return res, agree


def child(tree: Path, epochs: int) -> dict:
    """PNA Sylvie-A on reddit_like@paper with ``tree``'s package."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {repro_torch.__file__}, not {tree}'s")
    from repro_torch.kernels import build
    build.build_all()
    if epochs <= 0:
        return {}
    import chip_smoke
    from repro_torch import configs
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.launch.train import gnn_graph
    from repro_torch.policy import BoundedStaleness
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.trainer import GNNTrainer

    spec = configs.get("pna").config()
    pg = gnn_graph(spec, "reddit_like@paper", 4, SEED)
    torch.manual_seed(SEED)
    model = spec.make(pg.x.shape[-1], pg.n_classes)
    tr = GNNTrainer(model, pg, SylvieConfig(mode="async", bits=1),
                    opt=optlib.adam(1e-3),
                    policy=BoundedStaleness(eps_s=4, bits=1), seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    hist = [tr.train_epoch() for _ in range(epochs)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = {mode: sorted(m.seconds * 1e3 for m in hist[1:] if m.mode == mode)
          for mode in ("sync", "async")}
    prof = None
    for _ in range(6):
        m, wall, busy, groups, _ = chip_smoke.profile_device(
            tr.train_epoch, f"one epoch of PNA Sylvie-A ({tree.name})")
        if m.mode == "sync":
            prof = dict(host_ms=wall, busy_ms=busy, by_group=groups)
            break
    return dict(median_epoch_ms={k: v[len(v) // 2] if v else None
                                 for k, v in ms.items()},
                losses=[m.loss for m in hist],
                modes="".join(m.mode[0] for m in hist), peak_gb=peak,
                profile_sync=prof)


def run_child(root: Path, epochs: int) -> dict:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--child",
         str(root), "--epochs", str(epochs)], capture_output=True,
        text=True, cwd=str(ROOT), timeout=900)
    sys.stdout.write(proc.stdout[-4000:])
    if proc.returncode:
        sys.stdout.write(proc.stderr[-4000:])
        raise SystemExit(f"the epoch run of {root} failed")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", help="TAG=DIR")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--child")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.child).resolve(), args.epochs)))
        return 0
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    trees = {}
    for spec in args.trees:
        tag, _, path = spec.partition("=")
        trees[tag] = (ROOT / path).resolve()
    # each tree's own kernels for its epochs, built beside seg.cu's A/B
    builds = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                "--child", str(root), "--epochs", "0"],
                               cwd=str(ROOT))
              for root in trees.values()] if args.epochs > 0 else []
    libs = compile_trees(trees)
    card = card_line()
    print(f"[card] {card}", flush=True)
    res, agree = kernel_turns(libs, args.rounds)
    for p in builds:
        if p.wait():
            raise SystemExit("a tree's kernels did not build")
    epochs = {t: [] for t in trees}
    if args.epochs > 0:
        torch.cuda.empty_cache()
        order = list(trees)
        for t in order + order[::-1]:
            epochs[t].append(run_child(trees[t], args.epochs))
            print(f"[seg-ab] epochs {t}: {json.dumps(epochs[t][-1])}",
                  flush=True)
    line = json.dumps(dict(card=card, kernels=res, epochs=epochs,
                           agree=agree))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
