#!/usr/bin/env python3
"""Build GAT's CUDA kernels and hold them to their plain versions, on one
CUDA card; or time those of two checkouts against each other.

    python3 tools/torch_gat_check.py [--tree DIR] [--out FILE]
                                     [--graph reddit_like@paper] [--heads 4]
                                     [--dh 64] [--fold N]

``DIR`` is a checkout of this repository (default: the one holding this
script), for instance an earlier commit unpacked with ``git archive``. Run
the script for each tree in turns in one session (old, new, new, old) to
compare two designs on one card. For that tree it compiles every kernel
source not built yet, ``spmm.cu`` and ``gat.cu`` with ``-Xptxas -v``
(registers, shared memory and spills of every kernel are printed), builds
the stacked block of ``--graph`` partitioned 4 ways on the card, and runs
each kernel of GAT's aggregation on random inputs from seed 0:
``gat_softmax``, ``spmm_csr_heads`` over the CSR and over its transpose
(and at one head against ``spmm_csr``), ``sddmm_heads`` (also on copies
whose pointers are not 16-byte aligned), and ``gat_softmax_bwd`` in both
modes. Each result is compared with its plain PyTorch version run on the
card (bit for bit, or for the softmax within rtol 1e-6, atol 1e-7: ``expf``
may differ from ``torch.exp`` by an ulp) and with a second run of the kernel
(same bits). The per-head SpMM over the transposed CSR runs the way GAT's
backward calls it in that tree: with ``w_idx = perm_t`` where the tree's
``spmm_heads`` takes it, and always also as ``index_select(alpha, 0,
perm_t)`` followed by the kernel (the older backward), both bit-equal to
the plain version over ``alpha[perm_t]``.

``--fold N`` replaces the forward CSR's columns by ``col % N`` (the
transposed CSR stays as it is), so the rows the forward kernels gather fit
in L2: their times then show what the kernels cost apart from misses.

Prints CUDA-event milliseconds of each wrapper call (50 calls after a
warm-up: the call's wall time on the card, gaps between its launches
included) and one JSON line of them (also written to ``FILE`` when given).
For the softmax and both modes of its backward it also prints the device
time of each CUDA kernel the call launches, its phases (``torch.profiler``
over 20 calls, ``torch_timing.kernel_times``: whole rows and segments,
hub segments, combines; the parent's hub-row blocks) and their sum, the
call's device time, and times ``torch.sparse.softmax``, its backward and
``index_add_`` (mode 1) on the same inputs
(``torch_timing.softmax_library_ms``). Exits non-zero on the first
disagreement."""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch_timing import cuda_ms, kernel_times, softmax_library_ms

HERE = Path(__file__).resolve().parents[1]
ITERS = 50


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--graph", default="reddit_like@paper")
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--dh", type=int, default=64)
    ap.add_argument("--fold", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_gat_check: no CUDA device", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch import datasets
    from repro_torch.kernels import build
    from repro_torch.kernels.gat import ops as gops
    from repro_torch.kernels.gat import ref as gref
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref
    from repro_torch.models.gnn import blocks as B

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[card] {card}; tree {tree}")
    # every source at once, so that the first launch builds nothing more
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    verbose = ("spmm.cu", "gat.cu")
    procs = {src: subprocess.Popen(
        [build.nvcc_path(), *build.nvcc_flags(src),
         *(("-Xptxas", "-v") if src in verbose else ()), "-o",
         str(build.library_path(src)), str(build.CSRC / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in build.SOURCES if not build.library_path(src).exists()}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if src in verbose and ("Compiling entry" in line
                                   or "registers" in line
                                   or "spill" in line):
                print(f"[ptxas {src}] {line.strip()}")
        if proc.returncode:
            print(log)
            return 1

    pg = datasets.load_partitioned(args.graph, n_parts=4)
    blk = B.build_block(pg, "cuda")
    csr, csr_t, perm = blk.csr, blk.csr_t, blk.perm_t
    if args.fold:
        csr = dataclasses.replace(csr, col=(csr.col % args.fold).contiguous())
    h, d = args.heads, args.heads * args.dh
    gen = torch.Generator("cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, device="cuda", generator=gen)
    s_src, s_dst = rand(csr.n_cols, h), rand(csr.n_rows, h)
    table, g = rand(csr.n_cols, d), rand(csr.n_rows, d)
    print(f"[graph] {args.graph}: rows {csr.n_rows}, table rows {csr.n_cols},"
          f" nnz {csr.nnz}, split rows {csr.long_rows.numel()} / "
          f"{csr_t.long_rows.numel()} (transposed), H {h}, dh {args.dh}")

    ok = True
    times = {}

    def compare(name, kernel, plain, exact=True):
        nonlocal ok
        got, again, want = kernel(), kernel(), plain()
        got, again, want = ((t,) if torch.is_tensor(t) else t
                            for t in (got, again, want))
        for a, b, w in zip(got, again, want):
            err = float((a - w).abs().max()) if a.numel() else 0.0
            same = torch.equal(a, w)
            close = same or (not exact and torch.allclose(
                a, w, rtol=1e-6, atol=1e-7))
            twice = torch.equal(a, b)
            print(f"[check] {name} {tuple(a.shape)}: max abs err {err:.3g}, "
                  f"bit-equal {same}, same bits twice {twice}")
            ok = ok and close and twice
        times[name] = cuda_ms(kernel, ITERS, warmup=1)
        print(f"[time] {name}: {times[name]:.4f} ms")

    alpha = gops.softmax(s_src, s_dst, csr)
    compare("gat_softmax", lambda: gops.softmax(s_src, s_dst, csr),
            lambda: gref.gat_softmax_ref(s_src, s_dst, csr), exact=False)
    compare("spmm_csr_heads", lambda: sops.spmm_heads(table, csr, alpha),
            lambda: sref.spmm_heads_ref(table, csr, alpha))
    alpha_t = torch.index_select(alpha, 0, perm)
    compare("index_select + spmm_csr_heads (transposed)",
            lambda: sops.spmm_heads(g, csr_t,
                                    torch.index_select(alpha, 0, perm)),
            lambda: sref.spmm_heads_ref(g, csr_t, alpha_t))
    if "w_idx" in inspect.signature(sops.spmm_heads).parameters:
        compare("spmm_csr_heads (transposed, w_idx = perm_t)",
                lambda: sops.spmm_heads(g, csr_t, alpha, w_idx=perm),
                lambda: sref.spmm_heads_ref(g, csr_t, alpha_t))
    times["index_select"] = cuda_ms(lambda: torch.index_select(alpha, 0,
                                                               perm),
                                    ITERS, warmup=1)
    w0 = alpha[:, :1].contiguous()
    compare("spmm_csr_heads at H = 1 vs spmm_csr",
            lambda: sops.spmm_heads(table, csr, w0),
            lambda: sops.spmm(table, dataclasses.replace(
                csr, w=alpha[:, 0].contiguous())))
    compare("sddmm_heads", lambda: gops.sddmm_heads(g, table, csr, h),
            lambda: gref.sddmm_heads_ref(g, table, csr, h))
    # copies one float into their buffers: pointers not 16-byte aligned
    g_off, t_off = (torch.empty(x.numel() + 1, device="cuda")[1:].view(
        x.shape).copy_(x) for x in (g, table))
    compare("sddmm_heads (offset view)",
            lambda: gops.sddmm_heads(g_off, t_off, csr, h),
            lambda: gref.sddmm_heads_ref(g_off, t_off, csr, h))
    dalpha = gops.sddmm_heads(g, table, csr, h)
    compare("gat_softmax_bwd (mode 0)",
            lambda: gops.softmax_bwd(alpha, dalpha, s_src, s_dst, csr),
            lambda: gref.gat_softmax_bwd_ref(alpha, dalpha, s_src, s_dst,
                                             csr))
    dx, _ = gops.softmax_bwd(alpha, dalpha, s_src, s_dst, csr)
    compare("gat_softmax_bwd (mode 1)", lambda: gops.row_sums_t(dx, csr_t,
                                                                perm),
            lambda: gref.row_sums_t_ref(dx, csr_t, perm))
    phases = {}
    for name, fn in (
            ("gat_softmax", lambda: gops.softmax(s_src, s_dst, csr)),
            ("gat_softmax_bwd (mode 0)",
             lambda: gops.softmax_bwd(alpha, dalpha, s_src, s_dst, csr)),
            ("gat_softmax_bwd (mode 1)",
             lambda: gops.row_sums_t(dx, csr_t, perm))):
        phases[name] = kernel_times(fn)
        times[f"{name} device"] = sum(v[0] for v in phases[name].values())
        print(f"[phases] {name}: call {times[name]:.4f} ms, device "
              f"{times[name + ' device']:.4f} ms; " + "; ".join(
                  f"{k} {v[0]:.4f} ms x {v[1]:g}"
                  for k, v in phases[name].items()))
    lib = softmax_library_ms(csr, s_src, s_dst, alpha, alpha, dalpha, s_src,
                             s_dst, dx, gops.row_sums_t(dx, csr_t, perm))
    for call, r in lib.items():
        times[f"library {call}"] = r["ms"]
    print(f"[library] torch.sparse.softmax, its backward, index_add_ (mode "
          f"1): {json.dumps(lib)}")
    line = json.dumps({"tree": str(tree), "card": card, "ok": ok,
                       "fold": args.fold, "ms": times, "phases": phases})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    print(f"[result] {'all kernels agree' if ok else 'DISAGREEMENT'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
