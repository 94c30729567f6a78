#!/usr/bin/env python3
"""Build GAT's CUDA kernels and hold them to their plain versions, on one
CUDA card.

    python3 tools/torch_gat_check.py [--graph reddit_like@paper] [--heads 4]
                                     [--dh 64]

Compiles ``spmm.cu`` and ``gat.cu`` with ``-Xptxas -v`` (registers, shared
memory and spills of every kernel are printed), builds the stacked block of
``--graph`` partitioned 4 ways on the card, and runs each kernel of GAT's
aggregation on random inputs from seed 0: ``gat_softmax``,
``spmm_csr_heads`` over the CSR and over its transpose (and at one head
against ``spmm_csr``), ``sddmm_heads``, and ``gat_softmax_bwd`` in both
modes. Each result is compared with its plain PyTorch version run on the
card (bit for bit, or for the softmax within rtol 1e-6, atol 1e-7: ``expf``
may differ from ``torch.exp`` by an ulp) and with a second run of the kernel
(same bits). Prints CUDA-event milliseconds of each kernel. Exits non-zero
on the first disagreement.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def cuda_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="reddit_like@paper")
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--dh", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_gat_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import datasets
    from repro_torch.kernels import build
    from repro_torch.kernels.gat import ops as gops
    from repro_torch.kernels.gat import ref as gref
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref
    from repro_torch.models.gnn import blocks as B

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {src: subprocess.Popen(
        [build.nvcc_path(), *build.nvcc_flags(src), "-Xptxas", "-v", "-o",
         str(build.library_path(src)), str(build.CSRC / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("spmm.cu", "gat.cu")}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"[ptxas {src}] {line.strip()}")
        if proc.returncode:
            print(log)
            return 1

    pg = datasets.load_partitioned(args.graph, n_parts=4)
    blk = B.build_block(pg, "cuda")
    csr, csr_t, perm = blk.csr, blk.csr_t, blk.perm_t
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
        print(f"[time] {name}: {cuda_ms(kernel):.4f} ms")

    alpha = gops.softmax(s_src, s_dst, csr)
    compare("gat_softmax", lambda: gops.softmax(s_src, s_dst, csr),
            lambda: gref.gat_softmax_ref(s_src, s_dst, csr), exact=False)
    alpha_t = torch.index_select(alpha, 0, perm)
    compare("spmm_csr_heads", lambda: sops.spmm_heads(table, csr, alpha),
            lambda: sref.spmm_heads_ref(table, csr, alpha))
    compare("spmm_csr_heads (transposed)",
            lambda: sops.spmm_heads(g, csr_t, alpha_t),
            lambda: sref.spmm_heads_ref(g, csr_t, alpha_t))
    w0 = alpha[:, :1].contiguous()
    compare("spmm_csr_heads at H = 1 vs spmm_csr",
            lambda: sops.spmm_heads(table, csr, w0),
            lambda: sops.spmm(table, dataclasses.replace(
                csr, w=alpha[:, 0].contiguous())))
    compare("sddmm_heads", lambda: gops.sddmm_heads(g, table, csr, h),
            lambda: gref.sddmm_heads_ref(g, table, csr, h))
    dalpha = gops.sddmm_heads(g, table, csr, h)
    compare("gat_softmax_bwd (mode 0)",
            lambda: gops.softmax_bwd(alpha, dalpha, s_src, s_dst, csr),
            lambda: gref.gat_softmax_bwd_ref(alpha, dalpha, s_src, s_dst,
                                             csr))
    dx, _ = gops.softmax_bwd(alpha, dalpha, s_src, s_dst, csr)
    compare("gat_softmax_bwd (mode 1)", lambda: gops.row_sums_t(dx, csr_t,
                                                                perm),
            lambda: gref.row_sums_t_ref(dx, csr_t, perm))
    print(f"[result] {'all kernels agree' if ok else 'DISAGREEMENT'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
