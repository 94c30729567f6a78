#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each of which raises (and exits non-zero) on failure:

1. card   — needs ``torch.cuda.is_available()``; prints ``nvidia-smi``'s name
            and power limit.
2. build  — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
            into ``build/kernels/`` (cached by a hash of the sources).
3. slice  — serves GCN (d_hidden 256, 2 layers, the paper configuration) on
            ``reddit_like@paper`` (25,000 nodes, 602 features, 41 classes) in
            4 partitions stacked on the card, 1-bit deterministic halos, random
            weights from a seeded generator: ``full_sweep()``, three
            ``query()`` batches, a 64-node ``refresh()`` that must equal a fresh
            ``full_sweep()`` bit for bit, and one stochastic sweep. Kernel
            launch counts are zeroed just before the first sweep and read just
            after it; every kernel must have launched.
4. small  — the same engine on ``yelp_like@smoke`` on the card and on the CPU
            (the plain PyTorch versions, which the CPU tests hold to the JAX
            reference): logits agree at 32 bits, site-0 halos agree exactly
            at 1 bit.
5. kernels — each kernel against its plain PyTorch version on the tensors the
            slice's sweep produced: quantize (bits 1/2/4/8, stochastic and
            deterministic) bit-equal, dequantize equal, SpMM within rtol/atol
            1e-5 (both sum in CSR order, so in practice bit-equal). CUDA-event
            times beside the
            bytes-or-operations bound and, for SpMM, ``torch.sparse.mm``.
6. summary — a ``{"kernels": [...]}`` line, the card line, and the last
            line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
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


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms, "bytes" | "operations") on the card for the same work."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    # -- 1. card -------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {card_line}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import datasets
    from repro_torch.core.exchange import gather_boundary
    from repro_torch.dist.runtime import Runtime
    from repro_torch.kernels import build
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.models.gnn import blocks as B
    from repro_torch.models.gnn.models import GCN
    from repro_torch.serve import InferenceEngine, ServeConfig

    kernels = {
        qops.QUANTIZE_PACK.name: dict(
            k=qops.QUANTIZE_PACK, source="src/repro_torch/kernels/csrc/quant.cu",
            replaces="src/repro/kernels/quant/quant.py:38"),
        qops.UNPACK_DEQUANTIZE.name: dict(
            k=qops.UNPACK_DEQUANTIZE,
            source="src/repro_torch/kernels/csrc/quant.cu",
            replaces="src/repro/kernels/quant/quant.py:65"),
        sops.SPMM.name: dict(
            k=sops.SPMM, source="src/repro_torch/kernels/csrc/spmm.cu",
            replaces="src/repro/kernels/spmm/spmm.py:37"),
    }

    # -- 2. build ------------------------------------------------------------
    secs = build.build_all()
    log(f"[build] {len(build.SOURCES)} sources -> {build.BUILD_DIR} in "
        f"{secs:.1f} s")

    # -- 3. the slice: GCN 256x2 serving reddit_like@paper, P=4, 1 bit --------
    t0 = time.perf_counter()
    pg = datasets.load_partitioned("reddit_like@paper", n_parts=4)
    d_in, n_cls = pg.x.shape[-1], pg.n_classes
    log(f"[slice] reddit_like@paper: {pg.part_of.size} nodes, d_feat {d_in}, "
        f"{n_cls} classes, n_local {pg.plan.n_local}, halo rows "
        f"{pg.plan.halo_rows}, buckets {pg.plan.bucket_sizes.tolist()}, "
        f"{int(pg.edge_mask.sum())} edges ({time.perf_counter() - t0:.1f} s)")
    model = GCN(d_in, 256, n_cls, n_layers=2,
                generator=torch.Generator().manual_seed(SEED))
    runtime = Runtime.simulated(4)
    eng = InferenceEngine(model, pg, config=ServeConfig(bits=1),
                          runtime=runtime, seed=SEED)
    log(f"[slice] engine ready: csr nnz {eng.block.csr.nnz}, max in-degree "
        f"{int(torch.diff(eng.block.csr.row_ptr).max())}")

    for meta in kernels.values():
        meta["k"].launches = 0
    rep = eng.full_sweep()
    torch.cuda.synchronize()
    launches = {name: meta["k"].launches for name, meta in kernels.items()}
    log(f"[slice] full sweep {rep.seconds * 1e3:.3f} ms (first, host clock), "
        f"launches {launches}, wire bytes {rep.wire_bytes}")
    for name, n in launches.items():
        check(n >= eng.n_sites, f"{name} launched {n} times in one sweep, "
              f"expected at least {eng.n_sites}")
    logits = eng.logits
    check(logits.shape == (pg.part_of.size, n_cls), "logits shape")
    check(bool(np.isfinite(logits).all()), "logits finite")

    rng = np.random.default_rng(SEED)
    for b in range(3):
        ids = np.concatenate([rng.choice(pg.global_ids[p][pg.node_mask[p]],
                                         size=64, replace=False)
                              for p in range(4)])
        out = eng.query(ids)
        check(out.logits.shape == (256, n_cls)
              and np.array_equal(out.logits, logits[ids]),
              f"query batch {b} == cached logits")
    log("[slice] 3 query batches of 256 ids over 4 partitions answered")

    changed = np.concatenate([rng.choice(pg.global_ids[p][pg.node_mask[p]],
                                         size=16, replace=False)
                              for p in range(4)])
    rows = rng.normal(0, 1, (changed.size, d_in)).astype(np.float32)
    drep = eng.refresh(changed, rows)
    check(drep.kind == "delta", f"refresh ran as {drep.kind}")
    d_logits = eng._logits_host.copy()
    d_layers, d_halos = eng._layers, eng._halos
    frep = eng.full_sweep()
    check(np.array_equal(d_logits, eng._logits_host),
          "delta refresh logits == full sweep logits, bit for bit")
    for a, b in zip(d_layers + d_halos, eng._layers + eng._halos):
        check(torch.equal(a, b), "delta refresh caches == full sweep caches")
    log(f"[slice] delta refresh of {changed.size} nodes: {drep.seconds * 1e3:.3f}"
        f" ms, rows/site {drep.affected_rows} vs {frep.affected_rows}, wire "
        f"bytes {drep.wire_bytes} vs {frep.wire_bytes}; equals the full sweep "
        f"bit for bit")

    sweep_ms = sorted(eng.full_sweep().seconds * 1e3 for _ in range(5))
    log(f"[slice] full sweep (host clock, 5 runs): median {sweep_ms[2]:.3f} ms,"
        f" min {sweep_ms[0]:.3f} ms")

    # where one full sweep's device time goes (CUDA kernels by name)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = eng.full_sweep().seconds * 1e3
    on_dev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_dev) / 1e3
    log(f"[profile] one full sweep: host {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}% of the host time)")
    for e in sorted(on_dev, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:100]}")

    eng_s = InferenceEngine(model, pg, config=ServeConfig(bits=1,
                                                          stochastic=True),
                            runtime=runtime, seed=SEED)
    srep = eng_s.full_sweep()
    check(bool(np.isfinite(eng_s.logits).all()), "stochastic logits finite")
    log(f"[slice] stochastic 1-bit sweep {srep.seconds * 1e3:.3f} ms (first)")

    # -- 4. small input: card vs the CPU's plain versions ----------------------
    spg = datasets.load_partitioned("yelp_like@smoke", n_parts=4)
    small = GCN(spg.x.shape[-1], 16, spg.n_classes, n_layers=2,
                generator=torch.Generator().manual_seed(SEED))
    params = params_to_numpy(small)
    for bits in (32, 1):
        out = {}
        for dev in ("cuda", "cpu"):
            e = InferenceEngine(GCN(spg.x.shape[-1], 16, spg.n_classes), spg,
                                params, config=ServeConfig(bits=bits),
                                runtime=Runtime.simulated(4, device=dev))
            e.full_sweep()
            out[dev] = e
        if bits == 32:
            err = float(np.abs(out["cuda"].logits - out["cpu"].logits).max())
            check(np.allclose(out["cuda"].logits, out["cpu"].logits,
                              rtol=1e-4, atol=1e-5),
                  f"32-bit logits card vs CPU (max abs err {err})")
        else:
            check(torch.equal(out["cuda"]._halos[0].cpu(), out["cpu"]._halos[0]),
                  "1-bit site-0 halo card == CPU")
    log(f"[small] yelp_like@smoke: 32-bit logits card vs CPU max abs err "
        f"{err:.3g} (rtol 1e-4, atol 1e-5); 1-bit site-0 halos equal")

    # -- 5. kernels vs plain versions on the slice's own tensors ---------------
    plan, csr = eng.block.plan, eng.block.csr
    errs = {name: 0.0 for name in kernels}
    detail = []
    for site, h in enumerate(eng._layers):
        buf = gather_boundary(h, plan).reshape(-1, h.shape[-1]).contiguous()
        rows_, d = buf.shape
        for bits in (1, 2, 4, 8):
            for stochastic in (False, True):
                u = torch.rand(buf.shape, device=buf.device,
                               generator=torch.Generator("cuda").manual_seed(
                                   site * 100 + bits)) if stochastic else None
                pk, sk, zk = qops.quantize_pack_rows(buf, u, bits)
                pr, sr, zr = qref.quantize_pack_ref(buf, u, bits)
                for what, a, b in (("payload", pk, pr), ("scale", sk, sr),
                                   ("zero", zk, zr)):
                    check(torch.equal(a, b),
                          f"quantize site {site} bits {bits} stochastic "
                          f"{stochastic}: {what} equal")
                errs["quantize_pack"] = max(
                    errs["quantize_pack"],
                    float((pk.int() - pr.int()).abs().max()),
                    float((sk - sr).abs().max()), float((zk - zr).abs().max()))
                ok = qops.dequantize_rows(pk, sk, zk, bits, d)
                orf = qref.unpack_dequantize_ref(pk, sk, zk, bits, d)
                check(torch.equal(ok, orf),
                      f"dequantize site {site} bits {bits}: equal")
                errs["unpack_dequantize"] = max(
                    errs["unpack_dequantize"], float((ok - orf).abs().max()))
                if bits == 1 and not stochastic:
                    w = qref.packed_width(d, bits)
                    qb, qo = bound(rows_ * d * 4 + rows_ * (w + 8),
                                   rows_ * d * 8)
                    db, do = bound(rows_ * (w + 8) + rows_ * d * 4,
                                   rows_ * d * 2)
                    detail.append(dict(
                        site=site, shape=[rows_, d], bits=bits,
                        quantize_ms=cuda_ms(lambda: qops.quantize_pack_rows(
                            buf, None, 1)),
                        quantize_plain_ms=cuda_ms(lambda: qref.quantize_pack_ref(
                            buf, None, 1)),
                        quantize_bound_ms=qb, quantize_bound_by=qo,
                        dequantize_ms=cuda_ms(lambda: qops.dequantize_rows(
                            pk, sk, zk, 1, d)),
                        dequantize_plain_ms=cuda_ms(
                            lambda: qref.unpack_dequantize_ref(pk, sk, zk, 1, d)),
                        dequantize_bound_ms=db, dequantize_bound_by=do))
        table = B.halo_table(h, eng._halos[site])
        table = table.reshape(-1, table.shape[-1]).contiguous()
        out_k = sops.spmm(table, csr)
        out_r = sref.spmm_ref(table, csr)
        err = float((out_k - out_r).abs().max())
        check(torch.allclose(out_k, out_r, rtol=1e-5, atol=1e-5),
              f"spmm site {site}: within rtol/atol 1e-5 (max abs err {err})")
        check(torch.equal(out_k, sops.spmm(table, csr)),
              f"spmm site {site}: same bits on a second run")
        log(f"[kernels] spmm site {site}: max abs err {err:.3g}, bit-equal to "
            f"the plain version: {torch.equal(out_k, out_r)}")
        errs["spmm_csr"] = max(errs["spmm_csr"], err)
        with warnings.catch_warnings():   # sparse CSR is "beta" in PyTorch
            warnings.simplefilter("ignore")
            sparse = torch.sparse_csr_tensor(csr.row_ptr, csr.col, csr.w,
                                             size=(csr.n_rows, csr.n_cols))
        dd = table.shape[-1]
        sb, so = bound(table.numel() * 4 + (csr.n_rows + 1) * 4 + csr.nnz * 8
                       + csr.n_rows * dd * 4, 2 * csr.nnz * dd)
        detail[-1].update(
            spmm_shape=[csr.n_rows, csr.n_cols, dd, csr.nnz],
            spmm_ms=cuda_ms(lambda: sops.spmm(table, csr)),
            spmm_plain_ms=cuda_ms(lambda: sref.spmm_ref(table, csr),
                                  iters=2, warmup=1),
            spmm_library_ms=cuda_ms(lambda: torch.sparse.mm(sparse, table)),
            spmm_bound_ms=sb, spmm_bound_by=so)
        log(f"[kernels] site {site}: {json.dumps(detail[-1])}")
    log(f"[kernels] max abs err vs plain versions: {errs}")

    # -- 6. summary -----------------------------------------------------------
    s0 = detail[0]
    times = {
        "quantize_pack": ("quantize", None),
        "unpack_dequantize": ("dequantize", None),
        "spmm_csr": ("spmm", "spmm_library_ms"),
    }
    summary = []
    for name, meta in kernels.items():
        key, lib = times[name]
        summary.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=errs[name], ms=s0[f"{key}_ms"],
            plain_ms=s0[f"{key}_plain_ms"], bound_ms=s0[f"{key}_bound_ms"],
            bound_by=s0[f"{key}_bound_by"],
            library_ms=s0[lib] if lib else None,
            shape=s0["spmm_shape" if key == "spmm" else "shape"]))
    print(json.dumps({"kernels": summary}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
