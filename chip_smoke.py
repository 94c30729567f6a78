#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each of which raises (and exits non-zero) on failure:

1. card   — needs ``torch.cuda.is_available()``; prints ``nvidia-smi``'s name
            and power limit.
2. build  — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
            into ``build/kernels/`` (cached by a hash of the sources), one
            ``nvcc`` per source, all started together.
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
5. kernels — each GCN kernel against its plain PyTorch version on the tensors
            the slice's sweep produced: quantize (bits 1/2/4/8, stochastic and
            deterministic; scale/zero in float32 and in bfloat16, the wire's
            type, which must equal the float32 ones cast by torch) bit-equal,
            dequantize bit-equal from either, SpMM bit-equal and
            the same bits on a second run (the split of hub rows into
            ``SEGMENT``-edge segments is fixed by the CSR). Then a shape
            sweep of quantize and dequantize against their plain versions,
            bit for bit: bits 1/2/4/8, stochastic and deterministic, d in
            ``SWEEP_D``, rows 1/7/1,000, contiguous, a view one element into
            its buffer (4-byte aligned h and u, 1-byte aligned payload) and
            constant rows. Times beside the bytes-or-operations bound: the
            Low-bit Module's as device time per launch from
            ``torch.profiler`` (the CUDA-event time of back-to-back wrapper
            calls beside it), the rest by CUDA events; for SpMM also
            ``torch.sparse.mm`` and the kernel under other plans (segments
            of 64 or 256 edges, units heaviest first).
            The GCN's tensors are freed after this phase.
6. lm     — serves granite-3-2b at its full published config (40 layers,
            2,533,531,648 parameters, float32 from a seeded generator, as the
            reference's ``serve_lm``) through the port's ``generate``: batch 8,
            prompt 2,016 + 32 new tokens, i.e. one prefill over 2,048 positions
            and 31 greedy decode steps. Cut from the ``prefill_32k`` /
            ``decode_32k`` shapes (seq 32,768, batch 32 / 128) to fit this
            script's time. The flash kernel's count is zeroed just before and
            must read 40 just after (one launch per prefill layer; decode
            attention is plain PyTorch and launches none). Prints prefill ms,
            decode tokens/s, peak memory, the first tokens and a profiled
            prefill and decode step split by kernel.
7. lm-small — reduced granite-3-2b and yi-34b (untied unembedding) on the
            card and on the CPU from the same numpy weights: prefill logits
            within rtol/atol 1e-4, greedy tokens equal.
8. flash  — the flash kernel against its plain versions on the slice's own
            layer-0 q/k/v: ``flash_fwd`` over (8*32, 2048, 64) with KV heads
            repeated 4:1, in float32 and from bfloat16 inputs, the model's
            ``attention_bshd`` (GQA through strides), a ragged windowed
            case (Sq = Skv = 2,080, window 100), head widths 1, 75, 200 and
            256 (window 37), and d = 128 (yi-34b's head width) at
            (8*32, 2048). Tolerance on the attention (acc / l): 1e-4
            absolute in float32, 2e-2 from bfloat16 inputs. CUDA-event times
            beside the operations bound (3xTF32: three TF32 tensor-core
            products per multiply-add), the plain version and
            ``scaled_dot_product_attention`` (timed here only; the port
            never calls it).
9. summary — a ``{"kernels": [...]}`` line (each kernel's launches on
            every path: a serving sweep, each kind of training step, an LM
            ``generate``), the card line, and the last line ``{"ok": true,
            "device": {...}}``.

After phase 8 (``flash``) the serving front runs (``serve_front_phase``),
last, so that its host work (checkpoints written and restored, the store's
host tables) cannot shift the host-clock times of the phases before it;
every count is zeroed just before each ``serve_once`` and read just after
it:

serve-front — ``python -m repro_torch.launch.serve``'s ``serve_once`` on the
            card: (1) GCN 256x2 on ``reddit_like@paper`` (P=4, 1 bit),
            trained 3 epochs into a temporary checkpoint, then a closed loop
            of 8 clients x 400 requests x 16 ids with a 64-node delta
            refresh every 50 completions; every sweep launches exactly
            ``SERVE_LAUNCHES``, the 3 epochs 3 x ``TRAIN_LAUNCHES``' Sylvie-S
            step, all 400 requests complete, the measured delta ships fewer
            bytes than ``full_sweep_wire_bytes()`` and equals a full sweep
            bit for bit. (2) GraphSAGE and GAT the same way (100 requests),
            each sweep pinned by ``SERVE_LAUNCHES``, delta == full bit for
            bit. (3) ``gdelt_like@paper`` through the store (4,096 kB hot-node
            cache) and 2 replicas: a closed loop of 1,000 requests measures
            QPS, then an open loop offers half of it with Zipf skew 1.1 and
            60 mutation-stream events in 50 ms windows (both from the same
            checkpoint and settings): completed + lost = 1,000, ``verify_store()`` passes,
            the store's hits + misses equal the rows looked up; prints hit
            rate, miss bytes, refresh lag p50/p99, escalations and
            ``slo_pass`` at 50 ms (a speed: printed, not gated), and
            profiles one store-backed delta refresh. (4) Degraded mode on
            (1)'s engine: partition 1 down, a delta refresh leaves its
            logits bit for bit, its staleness 1; after ``set_up`` and a full
            sweep the logits equal a fresh engine's bit for bit. In every
            ``serve_once`` run the load generator's refreshes all ran (8 in
            (1), one per stream batch in (3)), none failed and the server
            stayed healthy; (3)'s lag p50/p99 come from the loop's own clock
            reads, checked against its reported max and mean. (5) (1)
            again, restored (not trained), untraced and then under
            ``obs.enable()``, and 3 epochs of GCN Sylvie-A untraced and
            traced: the same launches, logits and losses bit for bit; the span tree is ``epoch > decide > step``
            and ``request > lookup``, ``admit``, ``refresh > plan > sweep``;
            ``wall_s >= seconds``; the trace and metrics JSON go to
            ``artifacts/torch/obs/chip_smoke/``, span counts and median host
            ms are printed.

chaos     — after serve-front (last: it spawns processes and writes
            checkpoints); every count is zeroed before each epoch and read
            after it. (a) GCN 256x2 and GAT 4x64 on ``reddit_like@paper``,
            P=4, Sylvie-S (``Uniform(1)``) and Sylvie-A
            (``BoundedStaleness(4, 1)``), ``CHAOS_EPOCHS`` epochs under the
            ``chaos_smoke`` fault spec (``CHAOS_FAULT``), in turns with the
            same runs fault-free: every epoch ``faults_injected == halos_reused +
            forced_syncs`` and equal to what the host plan draws, some
            fault injected, losses finite, launches per step as
            ``TRAIN_LAUNCHES`` (a forced recovery epoch runs at 32 bits:
            vanilla's); the median epoch ms faulted and clean side by
            side, and the median of their paired ratios.
            (b) GCN Sylvie-S under a rate-zero plan: parameters bit-equal to
            no plan's after 3 epochs. (c) GCN and GAT, sync and async
            (``Uniform(1)``), 3 epochs under each exchange schedule:
            parameters and losses bit-equal, launches equal epoch by epoch;
            one more async epoch of each profiled: device-busy ms and the ms
            in which side-stream and main-stream kernels ran at once
            (``stream_profile``, from the trace's stream ids; printed, not
            gated). (d) ``python -m repro_torch.launch.chaos --kill-resume
            --dataset reddit_like@paper --epochs 4``: ``"bit_exact": true``,
            its second and third legs plan-cache hits. (e)
            ``run_scenario("chaos_smoke")`` on the card, the accounting on
            every cell; one ``smoke`` cell traced: the full report key set
            and its trace file.

Between phases 5 and 6 (``lm``) four training phases run:

train     — GCN 256x2, GraphSAGE 256x2 and GAT (4 heads x 64, 2 layers),
            the paper configs of the port's registry, trained full-graph on
            ``reddit_like@paper``, P=4, at full width, ``TRAIN_EPOCHS``
            epochs each of vanilla (32 bits), Sylvie-S (``Uniform(1)``,
            stochastic) and Sylvie-A (``BoundedStaleness(eps_s=4)``, 1 bit,
            stochastic), random weights from seed 0. Every kernel's count
            is zeroed before each epoch and read after it: the counts must
            equal ``TRAIN_LAUNCHES[(arch, run, step)]`` exactly. Prints the
            median epoch ms of sync and async epochs (epoch 0 left out), the
            first, last and least loss (finite; the last below the first but
            for GAT at 1 bit, which does not train at these widths in the
            reference either: ``GAT_ONE_BIT``),
            validation accuracy, payload and error-compensation MB per
            epoch, peak memory, and a profiled sync and async epoch of
            GCN's and GAT's Sylvie-A split by kernel (GAT's must launch no
            index gather: its backward reads alpha through perm_t).
train-kernels — the tensors of one recorded GCN Sylvie-S step: the SpMM over
            the transposed CSR (d = 256) and over the scatter CSR, and
            quantize / dequantize of the site-1 gradient (bits 1/2/4/8,
            stochastic and deterministic, f32 and bf16 scale/zero), each
            bit-equal to its plain version run on the card; the transposed
            SpMM timed beside its bytes bound, its plain version and
            ``torch.sparse.mm`` of Aᵀ.
gat-kernels — the tensors of one recorded GAT Sylvie-S step: each of GAT's
            kernels against its plain version on the card
            (``gat_kernels_phase``: bit for bit, the softmax within rtol
            1e-6, atol 1e-7) and on a second run, ``spmm_csr_heads`` at one
            head against ``spmm_csr``, over the transposed CSR with
            ``w_idx = perm_t`` against the gather + kernel path it
            replaced, ``sddmm_heads`` also at ``SDDMM_SHAPES``,
            ``gat_softmax`` and ``gat_softmax_bwd`` (both modes) also at
            ``GAT_ROW_SHAPES`` (a 50,000-edge row, rows of 0, 1, 128, 129
            edges; 1, 2, 4, 8 heads); CUDA-event times beside the bound,
            the plain version and the library calls (per head for the
            per-head SpMM and the SDDMM; ``torch.sparse.softmax``, its
            backward and ``index_add_`` for the softmax and the two modes
            of its backward), and for those three each phase's device time
            and the CUDA launches a call and a GAT step make.
train-parity — deterministic 6-epoch Sylvie-S and Sylvie-A (eps_s=2) of each
            arch on ``yelp_like@small`` on the card and on the CPU: losses
            allclose at rtol 1e-4, halo caches and gradients allclose but
            for at most 1% of their rows, counted (``train_parity_phase``;
            GAT at 1 bit epoch by epoch from the CPU's state).

Run time on an H100: about three and a half minutes, the kernels' build included.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tools"))
from torch_timing import (cuda_ms, device_ms, kernel_times,  # noqa: E402
                          softmax_library_ms)

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12      # H100 SXM TF32 on the tensor cores, dense
SEED = 0
SWEEP_D = (1, 3, 31, 32, 33, 75, 255, 256, 600, 602, 1433, 4099)
TRAIN_EPOCHS = 20
TRAIN_ARCHS = ("gcn", "graphsage", "gat")
TRAIN_KERNELS = ("quantize_pack", "unpack_dequantize", "spmm_csr",
                 "spmm_csr_heads", "gat_softmax", "sddmm_heads",
                 "gat_softmax_bwd")
# kernel launches per training step (2 layers), by (arch, run, step), in
# TRAIN_KERNELS order. GCN and GraphSAGE (whose mean is the SpMM over the
# unit-weight CSR): forward 2 SpMM; backward 1 SpMM over the transposed CSR
# (2 in an async step, whose gslot gradient at site 0 needs layer 0's table
# gradient) and 1 over the scatter CSR; quantize/dequantize once per
# exchange: the forward at both sites, the backward at site 1 (sync: site
# 0's h is the input) or at both sites (async: the gslots), none at 32 bits.
# GAT exchanges hw = h @ w, which has a gradient at site 0 too: both sites
# exchange both ways and scatter a gradient in either step; per layer 1
# softmax and 1 per-head SpMM forward, and backward 1 per-head SpMM over the
# transposed CSR, 1 SDDMM and 2 softmax-backward launches (the forward CSR,
# then the transposed row sums).
# GAT exchanges the projected features its attention scores come from, and
# at 1 bit with stochastic rounding that noise enters the softmax's exponent:
# at the paper's widths its loss starts several times higher and rises, in
# the JAX reference as in the port
# (tests/test_torch_train_sage_gat.py::
# test_gat_at_paper_widths_fails_to_train_at_one_bit_as_jax_does). These
# runs are held to finite losses and exact launches, not to falling losses.
GAT_ONE_BIT = (("gat", "sylvie_s"), ("gat", "sylvie_a"))
_GCN_LAUNCHES = {("vanilla", "sync"): (0, 0, 4, 0, 0, 0, 0),
                 ("sylvie_s", "sync"): (3, 3, 4, 0, 0, 0, 0),
                 ("sylvie_a", "sync"): (3, 3, 4, 0, 0, 0, 0),
                 ("sylvie_a", "async"): (4, 4, 5, 0, 0, 0, 0)}
TRAIN_LAUNCHES = {
    **{("gcn",) + k: v for k, v in _GCN_LAUNCHES.items()},
    **{("graphsage",) + k: v for k, v in _GCN_LAUNCHES.items()},
    ("gat", "vanilla", "sync"): (0, 0, 2, 4, 2, 2, 4),
    ("gat", "sylvie_s", "sync"): (4, 4, 2, 4, 2, 2, 4),
    ("gat", "sylvie_a", "sync"): (4, 4, 2, 4, 2, 2, 4),
    ("gat", "sylvie_a", "async"): (4, 4, 2, 4, 2, 2, 4)}
# kernel launches per serving sweep (full or delta), in TRAIN_KERNELS order:
# one quantize and one dequantize per exchange site; GCN and GraphSAGE
# aggregate by one SpMM per layer, GAT by one softmax and one per-head SpMM
# (tests/test_torch_serve_front.py holds the plain versions to the same
# counts)
SERVE_LAUNCHES = {"gcn": (2, 2, 2, 0, 0, 0, 0),
                  "graphsage": (2, 2, 2, 0, 0, 0, 0),
                  "gat": (2, 2, 0, 2, 2, 0, 0)}

def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (a signed zero or a NaN included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(as_int), b.view(as_int))


def shifted(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts one element into its buffer."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def check_quant(qops, qref, h, u, bits: int, tag: str,
                shift_payload: bool = False) -> tuple[float, float]:
    """Quantize ``h`` (noise ``u`` or ``None``) with the kernel, scale/zero
    in float32 and in bfloat16, and dequantize each result: all bit-equal to
    the plain versions (bfloat16 to the float32 ones cast by torch). Returns
    the largest differences seen by quantize and by dequantize (0 and 0 when
    the checks pass)."""
    d = h.shape[1]
    pk, sk, zk = qops.quantize_pack_rows(h, u, bits)
    pr, sr, zr = qref.quantize_pack_ref(h, u, bits)
    for what, a, b in (("payload", pk, pr), ("scale", sk, sr), ("zero", zk, zr)):
        check(same_bits(a, b), f"quantize {tag} bits {bits} stochastic "
              f"{u is not None}: {what} bit-equal")
    pb, sb, zb = qops.quantize_pack_rows(h, u, bits, torch.bfloat16)
    for what, a, b in (("payload", pb, pk), ("scale", sb, sk.bfloat16()),
                       ("zero", zb, zk.bfloat16())):
        check(same_bits(a, b), f"quantize {tag} bits {bits} bf16 scale: "
              f"{what} equals the float32 result cast by torch")
    src = shifted(pk) if shift_payload else pk
    deq_err = 0.0
    for s_, z_ in ((sk, zk), (sb, zb)):
        ok = qops.dequantize_rows(src, s_, z_, bits, d)
        orf = qref.unpack_dequantize_ref(pk, s_.float(), z_.float(), bits, d)
        check(same_bits(ok, orf), f"dequantize {tag} bits {bits} "
              f"{s_.dtype}: bit-equal")
        deq_err = max(deq_err, float((ok - orf).abs().max()))
    return max(float((pk.int() - pr.int()).abs().max()),
               float((sk - sr).abs().max()),
               float((zk - zr).abs().max())), deq_err


def quant_shape_sweep(qops, qref) -> int:
    """Both Low-bit Module kernels against their plain versions over edge
    shapes: d in ``SWEEP_D`` (one value; one past a 32-lane chunk; rows
    whose packed width is not a multiple of 4; rows wider than the kernel
    stages through shared memory), rows 1/7/1,000, bits 1/2/4/8, stochastic and
    deterministic, for a contiguous h, a view one element into its buffer,
    and half the rows constant (rng = 0). Returns the cases checked."""
    gen = torch.Generator("cuda").manual_seed(SEED)
    n = 0
    for rows in (1, 7, 1000):
        for d in SWEEP_D:
            x = torch.randn(rows * d + 1, generator=gen, device="cuda")
            r = torch.rand(rows * d + 1, generator=gen, device="cuda")
            flat = x[:-1].view(rows, d).clone()
            flat[::2] = 0.37
            cases = (("contiguous", x[:-1].view(rows, d), r[:-1].view(rows, d)),
                     ("offset", x[1:].view(rows, d), r[1:].view(rows, d)),
                     ("constant rows", flat, r[:-1].view(rows, d)))
            for tag, h, u in cases:
                for bits in (1, 2, 4, 8):
                    for stochastic in (False, True):
                        check_quant(qops, qref, h, u if stochastic else None,
                                    bits, f"{tag} ({rows} x {d})",
                                    shift_payload=tag == "offset")
                        n += 1
    return n


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """(least ms, "bytes" | "operations") on the card for the same work."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_device(fn, label: str):
    """Run ``fn`` once under ``torch.profiler``; print its device time by
    kernel and return (fn's result, host ms, device-busy ms, {group: ms},
    {kernel: launches}) with the groups flash kernel / SpMM / GAT kernels /
    quantize / dequantize / matrix products (cuBLAS) / everything else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    on_dev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_dev) / 1e3
    groups = {"flash": 0.0, "spmm": 0.0, "gat": 0.0, "quantize": 0.0,
              "dequantize": 0.0, "gemm": 0.0, "other": 0.0}
    for e in on_dev:
        name = e.key.lower()
        g = "flash" if "flash_fwd_kernel" in name else \
            "spmm" if "spmm_" in name else \
            "gat" if any(w in name for w in ("rows_unit_kernel",
                                             "rows_segment_kernel",
                                             "rows_long_kernel",
                                             "sddmm_kernel")) else \
            "quantize" if "quantize_pack_" in name else \
            "dequantize" if "unpack_dequantize" in name else \
            "gemm" if any(w in name for w in ("gemm", "gemv", "cutlass",
                                              "xmma", "cublas")) else "other"
        groups[g] += e.self_device_time_total / 1e3
    log(f"[profile] {label}: host {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}% of the host time); by group "
        f"{json.dumps({k: round(v, 3) for k, v in groups.items()})}")
    for e in sorted(on_dev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:100]}")
    return out, wall, busy, groups, {e.key: e.count for e in on_dev}


def lm_phase(all_kernels: dict) -> dict:
    """granite-3-2b at full width served through ``generate``; returns the
    path's launch counts and layer 0's q/k/v for the kernel checks."""
    from repro_torch import configs
    from repro_torch.dist.runtime import resolve_device
    from repro_torch.launch.train import generate
    from repro_torch.models.lm import model as LM

    dev = resolve_device()
    cfg = configs.get("granite-3-2b").config()
    check(cfg.n_layers == 40 and cfg.param_count() == 2_533_531_648,
          "granite-3-2b full config: 40 layers, 2,533,531,648 parameters")
    t0 = time.perf_counter()
    params = LM.init_params(cfg, torch.Generator(dev).manual_seed(SEED),
                            dtype=torch.float32)
    torch.cuda.synchronize()
    n_alloc = sum(t.numel() for _, t in LM.tree_leaves(params))
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.segments[0].layers[0].attn.n_heads} heads / "
        f"{cfg.segments[0].layers[0].attn.n_kv_heads} KV heads, "
        f"{cfg.param_count()} parameters ({n_alloc} allocated with the "
        f"padded vocab), float32 {n_alloc * 4 / 1e9:.2f} GB, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    b, s_ctx, new = 8, 2016, 32
    log(f"[lm] batch {b}, prompt {s_ctx} + {new} new tokens: one prefill over "
        f"{s_ctx + new} positions, {new - 1} decode steps (cut from "
        f"prefill_32k/decode_32k: seq 32768, batch 32/128)")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (b, s_ctx))
    torch.cuda.reset_peak_memory_stats()
    for meta in all_kernels.values():
        meta["k"].launches = 0
    res = generate(params, cfg, prompts, new)
    torch.cuda.synchronize()
    launches = {name: meta["k"].launches for name, meta in all_kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"[lm] generate (first): prefill {res.prefill_s * 1e3:.1f} ms, "
        f"{new - 1} decode steps {res.decode_s * 1e3:.1f} ms; launches "
        f"{launches}; peak memory {peak / 1e9:.2f} GB")
    check(launches["flash_fwd"] == cfg.n_layers,
          f"flash_fwd launched {launches['flash_fwd']} times in one generate,"
          f" expected {cfg.n_layers} (one per prefill layer, none in decode)")
    check(all(n == 0 for name, n in launches.items() if name != "flash_fwd"),
          "the LM path launches no GCN kernel")
    check(res.tokens.shape == (b, new) and res.tokens.min() >= 0
          and res.tokens.max() < cfg.vocab, "greedy tokens in the vocab")
    warm = generate(params, cfg, prompts, new)
    check(np.array_equal(warm.tokens, res.tokens), "greedy tokens repeat")
    log(f"[lm] generate (second): prefill {warm.prefill_s * 1e3:.1f} ms "
        f"({b * (s_ctx + new) / warm.prefill_s:.0f} tokens/s), decode "
        f"{b * (new - 1) / warm.decode_s:.1f} tokens/s "
        f"({warm.decode_s / (new - 1) * 1e3:.2f} ms a step); first tokens of "
        f"each row: {res.tokens[:, :8].tolist()}")

    tokens = torch.zeros((b, s_ctx + new), dtype=torch.long, device=dev)
    tokens[:, :s_ctx] = torch.as_tensor(prompts)
    prefill = LM.make_prefill_step(cfg, b, s_ctx + new)
    (last, caches), *prof_p = profile_device(
        lambda: prefill(params, tokens), f"one prefill ({b}x{s_ctx + new})")
    check(tuple(last.shape) == (b, cfg.vocab)
          and bool(torch.isfinite(last).all()), "prefill logits finite")
    check(np.array_equal(last.argmax(-1).cpu().numpy(), res.tokens[:, 0]),
          "prefill argmax == first generated token")
    decode = LM.make_decode_step(cfg)
    _, *prof_d = profile_device(
        lambda: decode(params, caches, last.argmax(-1)[:, None], s_ctx),
        "one decode step")

    a = cfg.segments[0].layers[0].attn
    w = sum(t.numel() for _, t in LM.tree_leaves(params["seg0"])
            if t.dim() == 3)                  # the layers' weight matrices
    gemm_tflop = 2 * w * b * (s_ctx + new) / 1e12
    gemm_ms = prof_p[2]["gemm"]
    log(f"[lm] prefill matrix products: {gemm_tflop:.3f} TFLOP in "
        f"{gemm_ms:.1f} ms of cuBLAS = {gemm_tflop / gemm_ms * 1e3:.1f} "
        f"TFLOP/s (float32, not on the tensor cores: 67 TFLOP/s peak)")
    step_bytes = 4 * (w + params["embed"].numel()) + sum(
        c.numel() * c.element_size() for _, c in LM.tree_leaves(caches))
    step_bound, _ = bound(step_bytes, 0)
    log(f"[lm] one decode step reads at least {step_bytes / 1e9:.3f} GB "
        f"(float32 weights, bf16 caches) = {step_bound:.3f} ms at 3.35 TB/s;"
        f" device busy {prof_d[1]:.3f} ms, host {prof_d[0]:.3f} ms")
    p0 = LM.index_layer(params["seg0"], 0)["sub0"]
    h = LM.rms_norm(params["embed"][tokens], p0["ln_attn"], cfg.norm_eps)
    qkv = LM.project_qkv(p0["attn"], h, a,
                          torch.arange(s_ctx + new, device=dev))
    return dict(launches=launches, qkv=qkv)


def lm_small_phase() -> None:
    """Reduced granite-3-2b and yi-34b: card vs the CPU's plain versions."""
    from repro_torch import configs
    from repro_torch.launch.train import generate
    from repro_torch.models.convert import (lm_params_from_numpy,
                                            lm_params_to_numpy)
    from repro_torch.models.lm import model as LM

    for arch in ("granite-3-2b", "yi-34b"):
        cfg = configs.get(arch).reduced()
        tree = lm_params_to_numpy(LM.init_params(
            cfg, torch.Generator().manual_seed(SEED), dtype=torch.float32))
        b, s_ctx, new = 4, 56, 8
        prompts = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                       (b, s_ctx))
        out = {}
        for dev in ("cuda", "cpu"):
            params = lm_params_from_numpy(tree, cfg, device=dev)
            tok = torch.zeros((b, s_ctx + new), dtype=torch.long, device=dev)
            tok[:, :s_ctx] = torch.as_tensor(prompts)
            last, _ = LM.make_prefill_step(cfg, b, s_ctx + new)(params, tok)
            out[dev] = (last.cpu(),
                        generate(params, cfg, prompts, new, dev).tokens)
        err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        check(torch.allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                             atol=1e-4),
              f"{arch} reduced: prefill logits card vs CPU (max abs err {err})")
        check(np.array_equal(out["cuda"][1], out["cpu"][1]),
              f"{arch} reduced: greedy tokens card == CPU")
        log(f"[lm-small] {cfg.name}: prefill logits card vs CPU max abs err "
            f"{err:.3g} (rtol/atol 1e-4); {b}x{new} greedy tokens equal")


def flash_phase(q, k, v) -> dict:
    """The flash kernel against its plain versions on layer 0's q/k/v."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash import ops as fops
    from repro_torch.kernels.flash import ref as fref

    b, s, h, d = q.shape
    g = h // k.shape[2]
    scale = d ** -0.5

    def heads(x, rep=1):            # (B, S, Hx, D) -> (B*H, S, D)
        x = x.repeat_interleave(rep, dim=2) if rep > 1 else x
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

    qf, kf, vf = heads(q), heads(k, g), heads(v, g)

    def compare(tag, qq, kk, vv, tol, window=None, scale=scale):
        acc, m, l = fops.flash_fwd(qq, kk, vv, scale=scale, window=window)
        torch.cuda.synchronize()
        acc_r, m_r, l_r = fref.flash_fwd_ref(qq, kk, vv, scale=scale,
                                             window=window)
        err = float((acc / l[..., None] - acc_r / l_r[..., None]).abs().max())
        check(err <= tol, f"flash {tag}: attention within {tol} of the plain "
              f"version (max abs err {err})")
        check(torch.allclose(m, m_r, rtol=1e-5, atol=1e-5)
              and torch.allclose(l, l_r, rtol=1e-4), f"flash {tag}: m and l")
        log(f"[flash] {tag} {tuple(qq.shape)} {qq.dtype}: attention max abs "
            f"err {err:.3g} (tol {tol}); raw acc "
            f"{float((acc - acc_r).abs().max()):.3g}, "
            f"m {float((m - m_r).abs().max()):.3g}, l relative "
            f"{float(((l - l_r).abs() / l_r).max()):.3g}")
        return err

    errs = [compare("f32", qf, kf, vf, 1e-4),
            compare("bf16 inputs", qf.bfloat16(), kf.bfloat16(),
                    vf.bfloat16(), 2e-2)]
    gen = torch.Generator("cuda").manual_seed(SEED)
    rag = [torch.randn(64, 2080, d, generator=gen, device="cuda")
           for _ in range(3)]
    errs.append(compare("ragged, window 100", *rag, 1e-4, window=100))
    for dd in (1, 75, 200, 256):    # other head widths, other tile shapes
        small = [torch.randn(4, 300, dd, generator=gen, device="cuda")
                 for _ in range(3)]
        errs.append(compare(f"d {dd}, window 37", *small, 1e-4, window=37))
    # d = 128 (yi-34b's head width) at the slice's batch and length
    q128, k128, v128 = (torch.randn(b * h, s, 128, generator=gen,
                                    device="cuda") for _ in range(3))
    errs.append(compare("d 128", q128, k128, v128, 1e-4,
                        scale=128 ** -0.5))

    kw = dict(causal=True, window=None, softcap=None, q_offset=0, kv_len=s,
              scale=scale)
    out = fops.attention_bshd(q, k, v, **kw)
    ref = fref.attention_bshd_ref(q, k, v, **kw)
    bshd_err = float((out - ref).abs().max())
    check(bshd_err <= 1e-4, f"attention_bshd (GQA {g}:1) within 1e-4 of "
          f"blockwise_attention's plain version (max abs err {bshd_err})")
    errs.append(bshd_err)
    log(f"[flash] attention_bshd {tuple(q.shape)} / {tuple(k.shape)} (the "
        f"model's call): max abs err {bshd_err:.3g} (tol 1e-4)")

    pairs = s * (s + 1) // 2                   # causal: keys seen per head
    ops = 4 * d * pairs * b * h
    f_bytes = 4 * (qf.numel() + kf.numel() + vf.numel() + qf.numel()) \
        + 4 * 2 * b * h * s
    fb, fo = bound(f_bytes, 3 * ops, TF32_OPS_PER_S)
    bb, bo = bound(4 * (q.numel() + k.numel() + v.numel() + q.numel()),
                   3 * ops, TF32_OPS_PER_S)
    qs, ks, vs = (x.view(b, h, s, d) for x in (qf, kf, vf))
    q128s, k128s, v128s = (x.view(b, h, s, 128) for x in (q128, k128, v128))
    res = dict(
        shape=[b * h, s, d], max_abs_err=max(errs),
        ms=cuda_ms(lambda: fops.flash_fwd(qf, kf, vf, scale=scale)),
        plain_ms=cuda_ms(lambda: fref.flash_fwd_ref(qf, kf, vf, scale=scale),
                         iters=2, warmup=1),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, scale=scale)),
        bound_ms=fb, bound_by=fo,
        bf16_ms=cuda_ms(lambda: fops.flash_fwd(
            qf.bfloat16(), kf.bfloat16(), vf.bfloat16(), scale=scale)),
        bshd_ms=cuda_ms(lambda: fops.attention_bshd(q, k, v, **kw)),
        bshd_plain_ms=cuda_ms(lambda: fref.attention_bshd_ref(q, k, v, **kw),
                              iters=2, warmup=1),
        bshd_bound_ms=bb, bshd_bound_by=bo, gflop=ops / 1e9,
        gbytes=f_bytes / 1e9, bytes_ms=bound(f_bytes, 0)[0],
        cuda_core_ms=bound(0, ops)[0],
        d128_ms=cuda_ms(lambda: fops.flash_fwd(q128, k128, v128,
                                               scale=128 ** -0.5)),
        d128_library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q128s, k128s, v128s, is_causal=True, scale=128 ** -0.5)),
        d128_bound_ms=bound(4 * 4 * b * h * s * 128 + 4 * 2 * b * h * s,
                            6 * ops, TF32_OPS_PER_S)[0])
    log(f"[flash] times: {json.dumps(res)}")
    return res


@contextlib.contextmanager
def recording(owner, name: str, calls: list):
    """Wrap ``owner.name`` so that each call appends its arguments to
    ``calls``, all of them in the signature's order (keywords and defaults
    included); restored on exit."""
    real = getattr(owner, name)
    sig = inspect.signature(real)

    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        calls.append(tuple(bound.arguments.values()))
        return real(*args, **kwargs)
    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, real)


def train_phase(all_kernels: dict) -> dict:
    """GCN 256x2, GraphSAGE 256x2 and GAT 4x64 (the paper configs of the
    port's registry) trained full-graph on reddit_like@paper, P=4: vanilla,
    Sylvie-S and Sylvie-A, ``TRAIN_EPOCHS`` epochs each. Kernel counts are
    zeroed before each epoch and read after it; they must equal
    ``TRAIN_LAUNCHES``. Returns the launches per step, GCN's and GAT's last
    Sylvie-S step's kernel inputs (recorded) and their blocks."""
    from repro_torch import configs, datasets
    from repro_torch.core import exchange as X
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.kernels.gat import ops as gops
    from repro_torch.models.gnn import blocks as B
    from repro_torch.policy import BoundedStaleness, Uniform
    from repro_torch.train.trainer import GNNTrainer

    pg, _ = datasets.load_partitioned("reddit_like@paper", n_parts=4)
    d_in, n_cls = pg.x.shape[-1], pg.n_classes
    runs = {"vanilla": (SylvieConfig(mode="vanilla"), None),
            "sylvie_s": (SylvieConfig(mode="sync", bits=1), Uniform(bits=1)),
            "sylvie_a": (SylvieConfig(mode="async", bits=1),
                         BoundedStaleness(eps_s=4, bits=1))}
    out = dict(launches={})
    for arch in TRAIN_ARCHS:
        for name, (cfg, pol) in runs.items():
            torch.manual_seed(SEED)
            model = configs.get(arch).config().make(d_in, n_cls)
            tr = GNNTrainer(model, pg, cfg, policy=pol, seed=SEED)
            torch.cuda.reset_peak_memory_stats()
            hist = []
            for _ in range(TRAIN_EPOCHS):
                for meta in all_kernels.values():
                    meta["k"].launches = 0
                m = tr.train_epoch()                 # ends in float(loss)
                got = tuple(all_kernels[k]["k"].launches
                            for k in TRAIN_KERNELS)
                want = TRAIN_LAUNCHES[(arch, name, m.mode)]
                check(got == want
                      and all_kernels["flash_fwd"]["k"].launches == 0,
                      f"[train] {arch} {name} {m.mode} epoch {m.epoch}: "
                      f"launches {dict(zip(TRAIN_KERNELS, got))}, expected "
                      f"{dict(zip(TRAIN_KERNELS, want))} and no flash")
                out["launches"][f"{arch}_train_{name}_{m.mode}_step"] = {
                    k: meta["k"].launches for k, meta in all_kernels.items()}
                hist.append(m)
            peak = torch.cuda.max_memory_allocated()
            acc = tr.evaluate("val")
            losses = [m.loss for m in hist]
            tag = f"{arch} {name}"
            check(all(np.isfinite(losses)), f"[train] {tag}: losses finite")
            # GAT at 1 bit does not train at these widths in the reference
            # either (GAT_ONE_BIT): its losses are only required finite
            check(losses[-1] < losses[0] or (arch, name) in GAT_ONE_BIT,
                  f"[train] {tag}: last loss {losses[-1]} below the first "
                  f"{losses[0]}")
            ms = {mode: sorted(m.seconds * 1e3 for m in hist[1:]
                               if m.mode == mode) for mode in ("sync",
                                                               "async")}
            med = {mode: v[len(v) // 2] if v else None
                   for mode, v in ms.items()}
            res = out[f"{arch}_{name}"] = dict(
                median_epoch_ms=med, n_epochs=TRAIN_EPOCHS,
                loss_first=losses[0], loss_last=losses[-1],
                loss_min=min(losses), val_acc=acc,
                payload_mb=hist[-1].comm_payload_mb,
                ec_mb=hist[-1].comm_ec_mb, peak_gb=peak / 1e9,
                modes="".join(m.mode[0] for m in hist))
            log(f"[train] {tag} ({tr.policy.name}): {json.dumps(res)}")
            if name == "sylvie_a" and arch != "graphsage":
                for mode in ("sync", "async"):      # epochs 20 (sync), 21
                    *_, by_kernel = profile_device(
                        tr.train_epoch, f"one {mode} epoch of {arch} "
                        f"Sylvie-A (epoch {tr.epoch})")
                    # the backward reads alpha through perm_t: no gather
                    gathers = {k: n for k, n in by_kernel.items()
                               if "vectorized_gather_kernel" in k}
                    check(arch != "gat" or not gathers,
                          f"[train] a {mode} GAT epoch launched index "
                          f"gathers: {gathers}")
            if name == "sylvie_s" and arch == "gcn":
                # one more step with its backward tensors recorded
                rec = dict(aggregate=[], scatter=[], quantize=[])
                with recording(B, "spmm", rec["aggregate"]), \
                        recording(X, "spmm", rec["scatter"]), \
                        recording(sys.modules[
                            "repro_torch.kernels.quant.ops"],
                            "quantize_pack_rows", rec["quantize"]):
                    tr.train_epoch()
                out["recorded"], out["block"] = rec, tr.block
            if name == "sylvie_s" and arch == "gat":
                # one more step with every GAT kernel's inputs recorded
                rec = {k: [] for k in ("spmm_heads", "softmax", "sddmm_heads",
                                       "softmax_bwd", "row_sums_t")}
                with recording(B, "spmm_heads", rec["spmm_heads"]), \
                        recording(gops, "softmax", rec["softmax"]), \
                        recording(gops, "sddmm_heads", rec["sddmm_heads"]), \
                        recording(gops, "softmax_bwd", rec["softmax_bwd"]), \
                        recording(gops, "row_sums_t", rec["row_sums_t"]):
                    tr.train_epoch()
                out["gat_recorded"], out["gat_block"] = rec, tr.block
            del tr, model
            torch.cuda.empty_cache()
    log(f"[train] kernel launches per step: {json.dumps(out['launches'])}")
    return out


def train_kernels_phase(rec: dict, block) -> dict:
    """The SpMM over the transposed CSR, the scatter CSR and the Low-bit
    Module on the site-1 gradient, on the tensors one Sylvie-S step gave
    them, each bit-equal to its plain version run on the card."""
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref

    res = dict(spmm_csr=0.0, quantize_pack=0.0, unpack_dequantize=0.0)
    csr_t, scatter = block.csr_t, block.plan.scatter
    back = [a for a in rec["aggregate"] if a[1] is csr_t]
    check(len(back) == 1 and back[0][0].shape[1] == 256,
          "one transposed SpMM at d = 256 in a sync step")
    for tag, (g, csr) in (("transposed CSR", back[0]),
                          ("scatter CSR", rec["scatter"][0])):
        check(csr is (csr_t if tag == "transposed CSR" else scatter),
              f"{tag}: the step's own CSR")
        out_k, out_r = sops.spmm(g, csr), sref.spmm_ref(g, csr)
        err = float((out_k - out_r).abs().max())
        check(same_bits(out_k, out_r), f"[train-kernels] spmm over the {tag}"
              f": bit-equal to the plain version (max abs err {err})")
        check(same_bits(out_k, sops.spmm(g, csr)),
              f"[train-kernels] spmm over the {tag}: same bits twice")
        res["spmm_csr"] = max(res["spmm_csr"], err)
        log(f"[train-kernels] spmm over the {tag} {tuple(g.shape)} -> "
            f"{tuple(out_k.shape)}, nnz {csr.nnz}, {csr.long_rows.numel()} "
            f"split rows: bit-equal to the plain version, twice")
    g, csr = back[0]
    with warnings.catch_warnings():       # sparse CSR is "beta" in PyTorch
        warnings.simplefilter("ignore")
        sparse_t = torch.sparse_csr_tensor(csr.row_ptr, csr.col, csr.w,
                                           size=(csr.n_rows, csr.n_cols))
    d = g.shape[1]
    tb, to = bound(g.numel() * 4 + (csr.n_rows + 1) * 4 + csr.nnz * 8
                   + csr.n_rows * d * 4, 2 * csr.nnz * d)
    res.update(
        transposed_shape=[csr.n_rows, csr.n_cols, d, csr.nnz],
        transposed_ms=cuda_ms(lambda: sops.spmm(g, csr)),
        transposed_plain_ms=cuda_ms(lambda: sref.spmm_ref(g, csr), iters=2,
                                    warmup=1),
        transposed_library_ms=cuda_ms(lambda: torch.sparse.mm(sparse_t, g)),
        transposed_bound_ms=tb, transposed_bound_by=to,
        scatter_ms=cuda_ms(lambda: sops.spmm(*rec["scatter"][0])))
    check(len(rec["quantize"]) == 3, "three quantize calls in a Sylvie-S step")
    h = rec["quantize"][-1][0]               # the site-1 gradient buffer
    check(h.shape[1] == 256, "the backward quantizes the site-1 gradient")
    for bits in (1, 2, 4, 8):
        for stochastic in (False, True):
            u = torch.rand(h.shape, device=h.device, generator=torch.Generator(
                "cuda").manual_seed(bits)) if stochastic else None
            q_err, d_err = check_quant(qops, qref, h, u, bits,
                                       "site-1 gradient")
            res["quantize_pack"] = max(res["quantize_pack"], q_err)
            res["unpack_dequantize"] = max(res["unpack_dequantize"], d_err)
    log(f"[train-kernels] quantize/dequantize of the site-1 gradient "
        f"{tuple(h.shape)}: bits 1/2/4/8, stochastic and deterministic, f32 "
        f"and bf16 scale/zero, bit-equal to the plain versions")
    log(f"[train-kernels] {json.dumps(res)}")
    return res


# sddmm_heads at other shapes than the step's: (tag, heads, columns of the
# step's (n, 256) tables, offset view)
SDDMM_SHAPES = (("4 heads, dh 16", 4, 64, False),
                ("4 heads, dh 64, offset view", 4, 256, True),
                ("4 heads, dh 63", 4, 252, False),
                ("1 head, dh 256", 1, 256, False),
                ("2 heads, dh 128", 2, 256, False),
                ("8 heads, dh 32", 8, 256, False))


def sddmm_shapes(g: torch.Tensor, table: torch.Tensor, csr) -> dict:
    """sddmm_heads against its plain version, bit for bit and the same bits
    on a second run, at ``SDDMM_SHAPES`` over the step's CSR: the first
    columns of its g and table, or a copy starting one float into its
    buffer (not 16-byte aligned: the 4-byte copies). Returns ms by tag."""
    from repro_torch.kernels.gat import ops as gops
    from repro_torch.kernels.gat import ref as gref

    out = {}
    for tag, heads, width, offset in SDDMM_SHAPES:
        gg, tt = (x[:, :width].contiguous() for x in (g, table))
        if offset:
            gg, tt = shifted(gg), shifted(tt)
        got, again = (gops.sddmm_heads(gg, tt, csr, heads) for _ in "ab")
        want = gref.sddmm_heads_ref(gg, tt, csr, heads)
        err = float((got - want).abs().max())
        check(same_bits(got, want) and same_bits(got, again),
              f"[gat-kernels] sddmm_heads at {tag}: bit-equal to the plain "
              f"version and twice (max abs err {err})")
        out[tag] = cuda_ms(lambda: gops.sddmm_heads(gg, tt, csr, heads))
    log(f"[gat-kernels] sddmm_heads bit-equal to its plain version, twice, "
        f"at {[t[0] for t in SDDMM_SHAPES]}; ms {json.dumps(out)}")
    return out


# gat_softmax and gat_softmax_bwd at rows harder than the step's: (tag, heads,
# offset views), each over one CSR of rows of GAT_ROW_LENGTHS edges (a row of
# 50,000 edges is 391 segments, one of 1,300 is 11) from GAT_ROW_SOURCES
# sources, columns drawn from SEED
GAT_ROW_LENGTHS = (50_000, 0, 1, 128, 129, 1_300, 33)
GAT_ROW_SOURCES = 10_000
GAT_ROW_SHAPES = (("1 head", 1, False), ("2 heads", 2, False),
                  ("4 heads", 4, False), ("8 heads", 8, False),
                  ("2 heads, offset views", 2, True),
                  ("4 heads, offset views", 4, True))


def _outputs(x) -> tuple:
    return (x,) if torch.is_tensor(x) else tuple(x)


def gat_row_shapes() -> dict:
    """gat_softmax (within rtol 1e-6, atol 1e-7) and gat_softmax_bwd in both
    modes (bit for bit) against their plain versions, and the same bits on a
    second run, at ``GAT_ROW_SHAPES``. Mode 1 sums over the same CSR, a
    random permutation of its edges standing for ``perm_t``. Offset views
    start one float into their buffers, so the kernels take their 4-byte
    loads. Returns {tag: {kernel: ms}}."""
    from repro_torch.kernels.gat import ops as gops
    from repro_torch.kernels.gat import ref as gref
    from repro_torch.kernels.spmm.ref import csr_from_edges

    rng = np.random.default_rng(SEED)
    n_rows = len(GAT_ROW_LENGTHS)
    dst = np.repeat(np.arange(n_rows), GAT_ROW_LENGTHS)
    src = rng.integers(0, GAT_ROW_SOURCES, dst.size)
    csr = csr_from_edges(src, dst, np.ones(dst.size), n_rows,
                         GAT_ROW_SOURCES).to("cuda")
    perm = torch.from_numpy(rng.permutation(csr.nnz).astype(np.int32)).cuda()
    gen = torch.Generator("cuda").manual_seed(SEED)
    out = {}
    for tag, heads, offset in GAT_ROW_SHAPES:
        def rand(rows):
            t = torch.randn((rows, heads), device="cuda", generator=gen)
            return shifted(t) if offset else t
        s_src, s_dst, dalpha = (rand(n) for n in (GAT_ROW_SOURCES, n_rows,
                                                  csr.nnz))
        alpha = gops.softmax(s_src, s_dst, csr)
        dx = gops.softmax_bwd(alpha, dalpha, s_src, s_dst, csr)[0]
        if offset:
            alpha, dx = shifted(alpha), shifted(dx)
        cases = {
            "gat_softmax": (lambda: gops.softmax(s_src, s_dst, csr),
                            lambda: gref.gat_softmax_ref(s_src, s_dst, csr),
                            False),
            "gat_softmax_bwd": (
                lambda: gops.softmax_bwd(alpha, dalpha, s_src, s_dst, csr),
                lambda: gref.gat_softmax_bwd_ref(alpha, dalpha, s_src, s_dst,
                                                 csr), True),
            "gat_softmax_bwd_t": (lambda: gops.row_sums_t(dx, csr, perm),
                                  lambda: gref.row_sums_t_ref(dx, csr, perm),
                                  True)}
        out[tag] = {}
        for name, (kern, plain, exact) in cases.items():
            got, again, want = (_outputs(f()) for f in (kern, kern, plain))
            for a, b, w in zip(got, again, want):
                err = float((a - w).abs().max())
                check(same_bits(a, b), f"[gat-kernels] {name} at {tag}: "
                      f"same bits twice")
                check(same_bits(a, w) if exact else torch.allclose(
                    a, w, rtol=1e-6, atol=1e-7),
                      f"[gat-kernels] {name} at {tag}: against the plain "
                      f"version (max abs err {err})")
            out[tag][name] = cuda_ms(kern)
    log(f"[gat-kernels] gat_softmax (tol) and gat_softmax_bwd in both modes "
        f"(bit for bit) agree with their plain versions, twice, at "
        f"{[t[0] for t in GAT_ROW_SHAPES]} over rows of {GAT_ROW_LENGTHS} "
        f"edges; ms {json.dumps(out)}")
    return out


def gat_kernels_phase(rec: dict, block) -> dict:
    """GAT's four kernels on the inputs one Sylvie-S step of GAT 4x64 on
    reddit_like@paper gave them, each against its plain version run on the
    card: spmm_csr_heads (forward over the CSR; backward over the transposed
    CSR, reading alpha through ``w_idx = perm_t``, against the plain version
    over ``alpha[perm_t]`` and against the gather + kernel path that it
    replaced), sddmm_heads and gat_softmax_bwd (both modes) bit for bit (the
    same order, products and adds rounded apart); gat_softmax within rtol
    1e-6, atol 1e-7, because its ``expf`` and ``torch.exp`` need not round
    alike (whether it came out bit-equal is printed); spmm_csr_heads at one
    head bit-equal to spmm_csr; every kernel the same bits on a second run.
    sddmm_heads also bit for bit at other shapes (``SDDMM_SHAPES``: dh 16,
    an offset view that takes the 4-byte copies, dh 63, 1 / 2 / 8 heads),
    and the softmax and its backward at ``GAT_ROW_SHAPES``
    (``gat_row_shapes``). Then CUDA-event times beside the
    bytes-or-operations bound, the plain version and the library calls: for
    the per-head SpMM and the SDDMM one per head (``torch.sparse.mm``,
    ``torch.sparse.sampled_addmm``), for the softmax and its backward
    ``torch.sparse.softmax``, its backward and, for mode 1, ``index_add_``
    (``softmax_library_ms``); the replaced gather + kernel path and the
    gather alone beside the transposed per-head SpMM. A call of the softmax
    or its backward launches 2-3 kernels, its phases: their device times
    (``torch.profiler``), their sum and their count stand beside its event
    time, and the CUDA launches of a GAT step are printed beside
    ``TRAIN_LAUNCHES``' wrapper calls."""
    from repro_torch.kernels.gat import ops as gops
    from repro_torch.kernels.gat import ref as gref
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref

    csr, csr_t, perm = block.csr, block.csr_t, block.perm_t
    rec = {k: [tuple(a.detach() if torch.is_tensor(a) else a for a in call)
               for call in calls] for k, calls in rec.items()}
    for k, n in (("spmm_heads", 4), ("softmax", 2), ("sddmm_heads", 2),
                 ("softmax_bwd", 2), ("row_sums_t", 2)):
        check(len(rec[k]) == n, f"[gat-kernels] {len(rec[k])} recorded "
              f"{k} calls in a GAT step, expected {n}")
    table, _, alpha, _ = rec["spmm_heads"][0]        # layer 0, forward
    g, csr_b, alpha_b, w_idx = rec["spmm_heads"][2]  # layer 1, backward
    check(csr_b is csr_t and table.shape[1] == 256 and alpha.shape[1] == 4,
          "[gat-kernels] the step's CSRs at width 256, 4 heads")
    # the backward reads the forward's alpha itself (the same storage)
    # through the block's own perm_t: no transposed copy
    check(w_idx.data_ptr() == perm.data_ptr() and alpha_b.data_ptr()
          == rec["spmm_heads"][1][2].data_ptr(),
          "[gat-kernels] the backward's per-head SpMM takes layer 1's alpha "
          "with w_idx = perm_t")
    alpha_t = torch.index_select(alpha_b, 0, perm)   # the replaced gather
    s_src, s_dst, _ = rec["softmax"][0]
    g_s, table_s, _, n_heads = rec["sddmm_heads"][0]
    a_b, da_b, ss_b, sd_b, _ = rec["softmax_bwd"][0]
    dx_b, _, _ = rec["row_sums_t"][0]
    nnz, h = csr.nnz, n_heads
    d = table.shape[1]
    rows, cols = csr.n_rows, csr.n_cols
    plan_bytes = (rows + 1) * 4 + nnz * 4
    cases = {
        "gat_softmax": (lambda: gops.softmax(s_src, s_dst, csr),
                        lambda: gref.gat_softmax_ref(s_src, s_dst, csr),
                        False, (cols + rows) * h * 4 + plan_bytes
                        + nnz * h * 4, 8 * nnz * h),
        "spmm_csr_heads": (lambda: sops.spmm_heads(table, csr, alpha),
                           lambda: sref.spmm_heads_ref(table, csr, alpha),
                           True, cols * d * 4 + plan_bytes + nnz * h * 4
                           + rows * d * 4, 2 * nnz * d),
        "spmm_csr_heads_t": (lambda: sops.spmm_heads(g, csr_t, alpha_b,
                                                     w_idx=perm),
                             lambda: sref.spmm_heads_ref(g, csr_t, alpha_t),
                             True, rows * d * 4 + (cols + 1) * 4 + nnz * 4
                             + nnz * h * 4 + nnz * 4 + cols * d * 4,
                             2 * nnz * d),
        "sddmm_heads": (lambda: gops.sddmm_heads(g_s, table_s, csr, h),
                        lambda: gref.sddmm_heads_ref(g_s, table_s, csr, h),
                        True, (rows + cols) * d * 4 + plan_bytes
                        + nnz * h * 4, 2 * nnz * d),
        "gat_softmax_bwd": (
            lambda: gops.softmax_bwd(a_b, da_b, ss_b, sd_b, csr),
            lambda: gref.gat_softmax_bwd_ref(a_b, da_b, ss_b, sd_b, csr),
            True, 3 * nnz * h * 4 + (cols + 2 * rows) * h * 4 + plan_bytes,
            7 * nnz * h),
        "gat_softmax_bwd_t": (
            lambda: gops.row_sums_t(dx_b, csr_t, perm),
            lambda: gref.row_sums_t_ref(dx_b, csr_t, perm),
            True, nnz * h * 4 + nnz * 4 + (cols + 1) * 4 + nnz * 4
            + cols * h * 4, nnz * h),
    }
    res = {}
    for name, (kern, plain, exact, n_bytes, n_ops) in cases.items():
        got, again, want = (_outputs(f()) for f in (kern, kern, plain))
        err, bit_equal = 0.0, True
        for a, b, w in zip(got, again, want):
            err = max(err, float((a - w).abs().max()))
            bit_equal = bit_equal and same_bits(a, w)
            check(same_bits(a, b), f"[gat-kernels] {name}: same bits twice")
            check(bit_equal if exact else torch.allclose(a, w, rtol=1e-6,
                                                         atol=1e-7),
                  f"[gat-kernels] {name}: against the plain version (max "
                  f"abs err {err}, {'bit for bit' if exact else 'tol'})")
        tb, to = bound(n_bytes, n_ops)
        res[name] = dict(max_abs_err=err, bit_equal=bit_equal,
                         ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=2,
                                                            warmup=1),
                         bound_ms=tb, bound_by=to, library_ms=None,
                         shape=[rows, cols, d, nnz, h])
        if name.startswith("gat_softmax"):
            # a call runs its phases as separate kernels, one launch each:
            # their device times (torch.profiler) and their sum, the call's
            # device time, with no host time or gap between launches in it
            t = name.endswith("_t")     # the row sums: one phase less
            hubs = (csr_t if t else csr).long_rows.numel() > 0
            ph = kernel_times(kern, expect=1 + hubs * (1 if t else 2))
            res[name]["device_ms"] = sum(v[0] for v in ph.values())
            res[name]["phases_ms"] = {k: v[0] for k, v in ph.items()}
            res[name]["cuda_launches_per_call"] = len(ph)
        if name.startswith(("spmm_csr_heads", "sddmm")):
            # the table rows they gather, a d-wide row per edge, and the
            # rate at which they gather them
            res[name]["gathered_gb"] = nnz * d * 4 / 1e9
            res[name]["gather_tb_s"] = nnz * d * 4 / res[name]["ms"] / 1e9
        log(f"[gat-kernels] {name}: {json.dumps(res[name])}")
    # the path the backward took before w_idx: gather alpha into the
    # transposed order, then the kernel; and the gather alone (the yardstick)
    gather_path = lambda: sops.spmm_heads(
        g, csr_t, torch.index_select(alpha_b, 0, perm))
    check(same_bits(sops.spmm_heads(g, csr_t, alpha_b, w_idx=perm),
                    gather_path()),
          "[gat-kernels] spmm_csr_heads over csr_t with w_idx = perm_t == "
          "the gather + kernel path, bit for bit")
    res["spmm_csr_heads_t"]["gather_path_ms"] = cuda_ms(gather_path)
    res["alpha_t_gather"] = dict(
        ms=cuda_ms(lambda: torch.index_select(alpha_b, 0, perm)),
        indexing_ms=cuda_ms(lambda: alpha_b[perm]),
        bound_ms=bound(2 * nnz * h * 4 + nnz * 4, 0)[0])
    t = res["spmm_csr_heads_t"]
    log(f"[gat-kernels] spmm_csr_heads over csr_t: {t['ms']:.4f} ms with "
        f"w_idx, {t['gather_path_ms']:.4f} ms gather + kernel (bit-equal); "
        f"alpha[perm_t] alone: {json.dumps(res['alpha_t_gather'])}")
    res["sddmm_heads"]["shapes"] = sddmm_shapes(g_s, table_s, csr)
    rows_ms = gat_row_shapes()
    for name in ("gat_softmax", "gat_softmax_bwd", "gat_softmax_bwd_t"):
        res[name]["shapes"] = {tag: ms[name] for tag, ms in rows_ms.items()}
    lib = softmax_library_ms(
        csr, s_src, s_dst, gops.softmax(s_src, s_dst, csr), a_b, da_b, ss_b,
        sd_b, dx_b, gops.row_sums_t(dx_b, csr_t, perm))
    for name, call in (("gat_softmax", "softmax"),
                       ("gat_softmax_bwd", "softmax_bwd"),
                       ("gat_softmax_bwd_t", "row_sums_t")):
        res[name]["library_ms"] = lib[call]["ms"]
    log(f"[gat-kernels] library: torch.sparse.softmax, its backward "
        f"(aten._sparse_softmax_backward_data), index_add_ over the CSR's "
        f"columns (mode 1): {json.dumps(lib)}")
    # TRAIN_LAUNCHES counts wrapper calls; each call of the softmax and its
    # backward launches its phases
    per_call = {n: res[n]["cuda_launches_per_call"] for n in (
        "gat_softmax", "gat_softmax_bwd", "gat_softmax_bwd_t")}
    calls = {"gat_softmax": len(rec["softmax"]),
             "gat_softmax_bwd": len(rec["softmax_bwd"]),
             "gat_softmax_bwd_t": len(rec["row_sums_t"])}
    log(f"[gat-kernels] CUDA launches per wrapper call {per_call}; a GAT "
        f"step's wrapper calls {calls} (TRAIN_LAUNCHES: gat_softmax 2, "
        f"gat_softmax_bwd 4 = both modes) launch "
        f"{sum(per_call[n] * calls[n] for n in calls)} CUDA kernels")
    one = alpha[:, :1].contiguous()
    check(same_bits(sops.spmm_heads(table, csr, one), sops.spmm(
        table, dataclasses.replace(csr, w=alpha[:, 0].contiguous()))),
        "[gat-kernels] spmm_csr_heads at one head == spmm_csr, bit for bit")
    log("[gat-kernels] spmm_csr_heads at one head: bit-equal to spmm_csr")

    dh = d // h
    with warnings.catch_warnings():       # sparse CSR is "beta" in PyTorch
        warnings.simplefilter("ignore")
        a_heads = [torch.sparse_csr_tensor(
            csr.row_ptr, csr.col, alpha[:, k].contiguous(),
            size=(rows, cols)) for k in range(h)]
        t_heads = [table[:, k * dh:(k + 1) * dh].contiguous()
                   for k in range(h)]
        g_heads = [g_s[:, k * dh:(k + 1) * dh].contiguous()
                   for k in range(h)]
        ts_heads = [table_s[:, k * dh:(k + 1) * dh].t()
                    for k in range(h)]
        res["spmm_csr_heads"]["library_ms"] = cuda_ms(
            lambda: [torch.sparse.mm(a, t) for a, t in zip(a_heads, t_heads)])
        res["sddmm_heads"]["library_ms"] = cuda_ms(
            lambda: [torch.sparse.sampled_addmm(a, gh, th, beta=0.0)
                     for a, gh, th in zip(a_heads, g_heads, ts_heads)])
    log(f"[gat-kernels] library calls, one per head: spmm "
        f"{res['spmm_csr_heads']['library_ms']} ms, sampled_addmm "
        f"{res['sddmm_heads']['library_ms']} ms")
    return res


def halo_rows_apart(a: torch.Tensor, b: torch.Tensor, atol_frac: float) -> int:
    """Rows of two (P, rows, d) halo buffers that are not allclose at rtol
    1e-4 and atol ``atol_frac`` times b's largest value."""
    a, b = a.cpu(), b.cpu()
    atol = atol_frac * float(b.abs().max())
    close = torch.isclose(a, b, rtol=1e-4, atol=atol).all(-1)
    return int((~close).sum())


def train_parity_phase() -> dict:
    """Deterministic 6-epoch Sylvie-S and Sylvie-A (eps_s=2) of GCN,
    GraphSAGE and GAT (reduced: d_hidden 16) on yelp_like@small from the
    same numpy weights, on the card and on the CPU (the plain versions the
    CPU tests hold to JAX): losses allclose at rtol 1e-4; halo caches and
    gradients allclose (rtol 1e-4; atol 1e-6 of the site's largest feature,
    1e-3 of its largest gradient: rows of gradient that are cancellation
    noise may take other 1-bit codes) but for at most 1% of the rows,
    counted — the products run in another order on the card, and a row's
    bf16 scale can round to its neighbour. GAT exchanges hw = h @ w at 1
    bit, so those differences flip codes and a free run drifts apart
    chaotically (as against JAX, ``tests/test_torch_train_sage_gat.py``):
    its card trainer takes the CPU trainer's state before every epoch, and
    a vanilla GAT run is compared free."""
    from repro_torch import configs, datasets
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.dist.runtime import Runtime
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.policy import BoundedStaleness, Uniform
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.trainer import GNNTrainer

    pg, _ = datasets.load_partitioned("yelp_like@small", n_parts=4)
    dims = (pg.x.shape[-1], pg.n_classes)
    res = {}
    for arch in TRAIN_ARCHS:
        spec = configs.get(arch).reduced()
        torch.manual_seed(SEED)
        params = params_to_numpy(spec.make(*dims))
        runs = [("sylvie_s", SylvieConfig(mode="sync", bits=1,
                                          stochastic=False),
                 Uniform(bits=1, stochastic=False)),
                ("sylvie_a", SylvieConfig(mode="async", bits=1,
                                          stochastic=False),
                 BoundedStaleness(eps_s=2, bits=1, stochastic=False))]
        if arch == "gat":
            runs.append(("vanilla", SylvieConfig(mode="vanilla"), None))
        for name, cfg, pol in runs:
            tr = {dev: GNNTrainer(spec.make(*dims), pg, cfg, policy=pol,
                                  params=params,
                                  runtime=Runtime.simulated(4, device=dev))
                  for dev in ("cuda", "cpu")}
            lockstep = arch == "gat" and name != "vanilla"
            for _ in range(6):
                if lockstep:
                    tr["cuda"].state = optlib.tree_map(
                        lambda t: t.to(tr["cuda"].device), tr["cpu"].state)
                for t in tr.values():
                    t.train_epoch()
            losses = {dev: [m.loss for m in t.history]
                      for dev, t in tr.items()}
            err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                            losses["cpu"]))
            tag = f"[train-parity] {arch} {name}"
            check(np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4,
                              atol=0),
                  f"{tag}: losses card vs CPU (max rel {err})")
            halo = {dev: t.state.halo for dev, t in tr.items()}
            n_rows = pg.plan.n_parts * tr["cpu"].block.plan.halo_rows
            apart = dict(
                feats=[halo_rows_apart(a, b, 1e-6) for a, b in zip(
                    halo["cuda"].feats, halo["cpu"].feats)],
                grads=[halo_rows_apart(a, b, 1e-3) for a, b in zip(
                    halo["cuda"].grads, halo["cpu"].grads)])
            check(max(apart["feats"] + apart["grads"]) <= 0.01 * n_rows,
                  f"{tag}: halo rows apart {apart} of {n_rows}")
            res[f"{arch}_{name}"] = dict(
                loss_max_rel=err, rows_apart=apart, rows=n_rows,
                lockstep=lockstep,
                modes="".join(m.mode[0] for m in tr["cpu"].history))
            log(f"{tag}: {json.dumps(res[f'{arch}_{name}'])}")
    return res


# the parent span each span of the serving front and the trainer must sit
# in (None: top level); a sweep outside a refresh is a full_sweep() call
SPAN_PARENTS = {"epoch": {None}, "decide": {"epoch"}, "step": {"epoch"},
                "admit": {None}, "request": {None}, "lookup": {"request"},
                "refresh": {None}, "plan": {"refresh"},
                "sweep": {"refresh", None}}


def span_tree(events: list) -> dict:
    """Check every span's innermost enclosing span against ``SPAN_PARENTS``
    (a delta sweep must sit in a refresh); return {name: [count, median host
    ms]}."""
    spans = sorted((e for e in events if e["ph"] == "X"),
                   key=lambda e: (e["ts"], -e["dur"]))
    stack: list = []
    durs: dict = {}
    for e in spans:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
            stack.pop()
        parent = stack[-1]["name"] if stack and (
            e["ts"] + e["dur"] <= stack[-1]["ts"] + stack[-1]["dur"]) \
            else None
        allowed = SPAN_PARENTS.get(e["name"], set())
        if e["name"] == "sweep" and e.get("args", {}).get("kind") == "delta":
            allowed = {"refresh"}
        check(parent in allowed, f"[serve-front] span {e['name']} sits in "
              f"{parent}, expected one of {allowed}")
        durs.setdefault(e["name"], []).append(e["dur"] * 1e3)
        stack.append(e)
    return {k: [len(v), float(np.median(v))] for k, v in sorted(durs.items())}


def serve_front_phase(all_kernels: dict) -> dict:
    """The serving front through ``python -m repro_torch.launch.serve``'s
    ``serve_once`` at the paper's widths (see the module docstring)."""
    import tempfile

    from repro_torch import configs, obs
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.launch import serve as launch
    from repro_torch.policy import BoundedStaleness
    from repro_torch.serve import InferenceEngine
    from repro_torch.serve import loadgen
    from repro_torch.train.trainer import GNNTrainer

    names = list(all_kernels)

    def snap() -> np.ndarray:
        return np.array([all_kernels[k]["k"].launches for k in names])

    def zero() -> None:
        for meta in all_kernels.values():
            meta["k"].launches = 0

    def pinned(diff: np.ndarray) -> tuple:
        check(diff[names.index("flash_fwd")] == 0, "a sweep launched flash")
        return tuple(int(diff[names.index(k)]) for k in TRAIN_KERNELS)

    @contextlib.contextmanager
    def watching(sweeps: list):
        """Record each sweep (engine, kind, launches, report) of the
        engines built inside, by launch counts read around ``_run``."""
        real = InferenceEngine._run

        def run(self, *args, **kw):
            before = snap()
            rep = real(self, *args, **kw)
            sweeps.append((self, kw["kind"], pinned(snap() - before), rep))
            return rep
        InferenceEngine._run = run
        try:
            yield
        finally:
            InferenceEngine._run = real

    @contextlib.contextmanager
    def probing(loops: list):
        """Record each load generator run inside as (server, refreshes
        expected, refresh lags): the loop gets a clock that logs its reads
        (the loop reads it once at its start and once right after each
        refresh returns) and the server's refresh is wrapped to mark them."""
        real = {k: getattr(loadgen, k) for k in ("closed_loop", "open_loop")}

        def probed(name):
            def run(server, n_nodes, **kw):
                reads: list = []
                after: list = []        # index of the read after a refresh

                def clock() -> float:
                    reads.append(server.clock())
                    return reads[-1]

                def refresh(*args, **k):
                    rep = type(server).refresh(server, *args, **k)
                    after.append(len(reads))
                    return rep
                server.refresh = refresh
                try:
                    load = real[name](server, n_nodes, clock=clock, **kw)
                finally:
                    del server.refresh
                feed = sorted(kw.get("feed") or [], key=lambda b: b[0])
                every = kw.get("refresh_every")
                # the closed loop refreshes once per refresh_every
                # completions (its clients, fewer, finish at most that many
                # a step); the open loop once per feed batch (none is empty)
                want = len(feed) if name == "open_loop" else \
                    kw["requests"] // every if every else 0
                lags = [reads[i] - reads[0] - b[0]
                        for i, b in zip(after, feed)]
                loops.append((server, want, lags))
                return load
            return run
        for k in real:
            setattr(loadgen, k, probed(k))
        try:
            yield
        finally:
            for k, fn in real.items():
                setattr(loadgen, k, fn)

    def serve(*argv) -> tuple:
        """serve_once on the card with its counts zeroed just before and
        read just after: (report, sweeps, launches, seconds, refresh lags
        of the open loop's stream in s). Fails unless every refresh the load
        generator asked for ran and the server stayed healthy."""
        sweeps: list = []
        loops: list = []
        zero()
        t0 = time.perf_counter()
        with watching(sweeps), probing(loops):
            rep = launch.serve_once(launch.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        load = rep["load"]
        check(len(loops) == 1, f"[serve-front] {len(loops)} load runs")
        server, want, lags = loops[0]
        check(load["refresh_failures"] == 0 and server.refresh_failures == 0
              and server.health == "healthy",
              f"[serve-front] {argv}: {load['refresh_failures']} refreshes "
              f"failed, server {server.health}")
        check(load["refreshes"] == want, f"[serve-front] {argv}: "
              f"{load['refreshes']} refreshes, expected {want}")
        if "refresh_lag_max_s" in load:
            check(max(lags, default=0.0) == load["refresh_lag_max_s"]
                  and float(np.mean(lags) if lags else 0.0)
                  == load["refresh_lag_mean_s"],
                  f"[serve-front] refresh lags read back {lags} disagree "
                  f"with the report's max and mean")
        return rep, sweeps, snap(), secs, lags

    def same(a: np.ndarray, b: np.ndarray) -> bool:
        return a.shape == b.shape and a.dtype == b.dtype and \
            np.array_equal(a.view(np.uint32), b.view(np.uint32))

    def delta_equals_full(eng, tag: str) -> None:
        """The engine's last sweep was a delta refresh: a full sweep from
        the same features must give the same bits everywhere."""
        d_logits = eng._logits_host.copy()
        d_caches = eng._layers + eng._halos
        eng.full_sweep()
        check(same(d_logits, eng._logits_host),
              f"[serve-front] {tag}: delta refresh logits == full sweep's")
        for a, b in zip(d_caches, eng._layers + eng._halos):
            check(same_bits(a, b), f"[serve-front] {tag}: delta refresh "
                  f"caches == full sweep's")

    out: dict = {"launches": {}}
    train_step = np.array(TRAIN_LAUNCHES[("gcn", "sylvie_s", "sync")])
    with tempfile.TemporaryDirectory(prefix="serve_front_") as tmp:
        tmp = Path(tmp)
        # -- 1. GCN 256x2 serve_once on reddit_like@paper --------------------
        gcn_argv = ("--graph", "reddit_like@paper", "--arch", "gcn",
                    "--ckpt-dir", str(tmp / "gcn"), "--train-epochs", "3",
                    "--clients", "8", "--requests", "400", "--batch", "16",
                    "--refresh-every", "50", "--refresh-nodes", "64",
                    "--seed", str(SEED))
        rep, sweeps, total, secs, _ = serve(*gcn_argv)
        eng = sweeps[-1][0]
        check(sweeps[0][1] == "full" and sweeps[0][2] == SERVE_LAUNCHES["gcn"],
              f"[serve-front] gcn first sweep launches {sweeps[0][2]}, "
              f"expected {SERVE_LAUNCHES['gcn']}")
        check(all(s[2] == SERVE_LAUNCHES["gcn"] for s in sweeps),
              "[serve-front] gcn: every sweep launches SERVE_LAUNCHES")
        served = sum(np.array(s[2]) for s in sweeps)
        trained = total[[names.index(k) for k in TRAIN_KERNELS]] - served
        check(np.array_equal(trained, 3 * train_step),
              f"[serve-front] gcn: 3 training epochs launched {trained}, "
              f"expected 3 x {train_step}")
        load = rep["load"]
        check(load["requests"] == 400, f"[serve-front] gcn: "
              f"{load['requests']} of 400 requests completed")
        check(rep["delta_refresh"]["kind"] == "delta"
              and rep["delta_refresh"]["wire_bytes"]
              < rep["full_sweep_wire_bytes"],
              "[serve-front] gcn: the measured delta ships less than a full "
              "sweep")
        full_ms = sorted(s[3].seconds * 1e3 for s in sweeps
                         if s[1] == "full")
        delta_ms = sorted(s[3].seconds * 1e3 for s in sweeps
                          if s[1] == "delta")
        res = out["gcn"] = dict(
            qps=load["qps"], p50_ms=load["p50_ms"], p99_ms=load["p99_ms"],
            requests=load["requests"], refreshes=load["refreshes"],
            refresh_failures=load["refresh_failures"],
            first_sweep_ms=rep["sweep_seconds"] * 1e3,
            full_sweep_ms=full_ms,
            delta_ms_median=delta_ms[len(delta_ms) // 2],
            refresh_wire_bytes=load["refresh_wire_bytes"],
            delta_wire_bytes=rep["delta_refresh"]["wire_bytes"],
            full_sweep_wire_bytes=rep["full_sweep_wire_bytes"],
            sweeps=len(sweeps), seconds=secs)
        out["launches"]["gcn_serve_front_sweep"] = dict(
            zip(TRAIN_KERNELS, sweeps[0][2]))
        log(f"[serve-front] gcn reddit_like@paper serve_once (3 epochs "
            f"trained, 8 clients x 400 requests x 16 ids, 64-node delta "
            f"every 50): {json.dumps(res)}")
        final_logits = eng._logits_host.copy()
        delta_equals_full(eng, "gcn")

        # -- 4. degraded mode on the same engine -----------------------------
        before = eng._logits_host.copy()
        eng.set_down([1])
        rng = np.random.default_rng(SEED + 5)
        ids = rng.choice(eng.pg.part_of.size, size=64, replace=False)
        rows = rng.normal(0, 1, (64, eng.pg.x.shape[-1])).astype(np.float32)
        dsweeps: list = []
        with watching(dsweeps):
            drep = eng.refresh(ids, rows)
        check(drep.kind == "delta" and dsweeps[0][2] == SERVE_LAUNCHES["gcn"],
              f"[serve-front] degraded refresh ran {drep.kind} with launches "
              f"{dsweeps[0][2]}")
        check(same(eng._logits_host[1], before[1]),
              "[serve-front] partition 1's logits frozen bit for bit")
        check(eng.part_staleness.tolist() == [0, 1, 0, 0],
              f"[serve-front] staleness {eng.part_staleness.tolist()}")
        p1 = eng.pg.global_ids[1][eng.pg.node_mask[1]][:32]
        check(eng.query(p1).staleness.tolist() == [1] * 32,
              "[serve-front] partition 1's answers stamped stale")
        eng.set_up([1])
        eng.full_sweep()
        torch.manual_seed(SEED)
        fresh, _ = InferenceEngine.from_checkpoint(
            tmp / "gcn", configs.get("gcn").config().make(
                eng.pg.x.shape[-1], eng.pg.n_classes),
            dataclasses.replace(eng.pg, x=eng._x_host.copy()),
            config=eng.config, runtime=eng.runtime, seed=SEED)
        fresh.full_sweep()
        check(eng.part_staleness.tolist() == [0] * 4
              and same(eng._logits_host, fresh._logits_host),
              "[serve-front] after set_up + full_sweep the logits equal a "
              "fresh engine's bit for bit")
        log(f"[serve-front] degraded: partition 1 down, a 64-node delta "
            f"refresh ({drep.seconds * 1e3:.3f} ms, launches "
            f"{dsweeps[0][2]}) left its {int(eng.pg.node_mask[1].sum())} "
            f"logits rows frozen bit for bit, staleness [0, 1, 0, 0]; after "
            f"set_up + full_sweep the logits equal a fresh engine's bit for "
            f"bit")
        gcn_pg = eng.pg
        del eng, fresh, sweeps, dsweeps
        torch.cuda.empty_cache()

        # -- 2. GraphSAGE and GAT served the same way ------------------------
        for arch in ("graphsage", "gat"):
            rep, sweeps, total, secs, _ = serve(
                "--graph", "reddit_like@paper", "--arch", arch,
                "--ckpt-dir", str(tmp / arch), "--train-epochs", "3",
                "--requests", "100", "--refresh-nodes", "64",
                "--seed", str(SEED))
            check(all(s[2] == SERVE_LAUNCHES[arch] for s in sweeps),
                  f"[serve-front] {arch}: sweep launches "
                  f"{[s[2] for s in sweeps]}, expected "
                  f"{SERVE_LAUNCHES[arch]}")
            check(rep["load"]["requests"] == 100
                  and rep["delta_refresh"]["kind"] == "delta",
                  f"[serve-front] {arch}: 100 requests and a delta refresh")
            delta_equals_full(sweeps[-1][0], arch)
            out["launches"][f"{arch}_serve_front_sweep"] = dict(
                zip(TRAIN_KERNELS, sweeps[0][2]))
            res = out[arch] = dict(
                qps=rep["load"]["qps"], p50_ms=rep["load"]["p50_ms"],
                p99_ms=rep["load"]["p99_ms"],
                refresh_failures=rep["load"]["refresh_failures"],
                first_sweep_ms=rep["sweep_seconds"] * 1e3,
                delta_ms=rep["delta_refresh"]["seconds"] * 1e3,
                delta_wire_bytes=rep["delta_refresh"]["wire_bytes"],
                full_sweep_wire_bytes=rep["full_sweep_wire_bytes"],
                seconds=secs)
            log(f"[serve-front] {arch} reddit_like@paper serve_once: "
                f"{json.dumps(res)}; delta == full bit for bit")
            del sweeps
            torch.cuda.empty_cache()

        # -- 3. store, 2 replicas, open loop, mutation stream on gdelt --------
        base = ("--graph", "gdelt_like@paper", "--arch", "gcn",
                "--ckpt-dir", str(tmp / "gdelt"), "--train-epochs", "3",
                "--store", "--replicas", "2", "--requests", "1000",
                "--batch", "16", "--seed", str(SEED))
        closed, sweeps, *_ = serve(*base)
        qps = closed["load"]["qps"]
        obs.reset_metrics()
        # 50 ms consumption windows, so the stream's refreshes fall among
        # the requests (at 0.25 s the first is due after the last arrival)
        rep, sweeps, total, secs, lags = serve(
            *base, "--open-loop", "--qps", repr(qps / 2), "--skew", "1.1",
            "--stream-events", "60", "--stream-window", "0.05",
            "--slo-ms", "50")
        eng = sweeps[-1][0]
        load, st = rep["load"], rep["store"]
        check(len(lags) == load["refreshes"] > 0,
              f"[serve-front] open loop: {len(lags)} stream refreshes")
        check(load["completed"] + load["lost"] == 1000,
              f"[serve-front] open loop: {load['completed']} completed + "
              f"{load['lost']} lost != 1000")
        n_rows = eng.verify_store()
        lookups = load["completed"] * 16
        check(st["hits"] + st["misses"] == lookups
              and obs.snapshot()["counters"]["store.hits"] == st["hits"],
              f"[serve-front] store hits {st['hits']} + misses "
              f"{st['misses']} != {lookups} row lookups")
        check(all(s[2] == SERVE_LAUNCHES["gcn"] for s in sweeps),
              "[serve-front] gdelt: every sweep launches SERVE_LAUNCHES")
        # what the store adds to a sweep: the emb table's copy to the host
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng._publish(None)
            t.append((time.perf_counter() - t0) * 1e3)
        emb = eng._layers[-1]
        res = out["gdelt"] = dict(
            closed_qps=qps, closed_p99_ms=closed["load"]["p99_ms"],
            offered_qps=load["qps_offered"],
            achieved_qps=load["qps_achieved"], completed=load["completed"],
            lost=load["lost"], p50_ms=load["p50_ms"], p99_ms=load["p99_ms"],
            slo_ms=load["slo_ms"], slo_pass=load["slo_pass"],
            hit_rate=st["hit_rate"], miss_bytes=st["miss_bytes"],
            cached_bytes=st["cached_bytes"], shard_bytes=st["shard_bytes"],
            refreshes=load["refreshes"],
            escalations=load["refresh_escalations"],
            refresh_failures=load["refresh_failures"],
            refresh_lag_p50_ms=float(np.percentile(lags, 50)) * 1e3,
            refresh_lag_p99_ms=float(np.percentile(lags, 99)) * 1e3,
            refresh_lag_max_ms=load["refresh_lag_max_s"] * 1e3,
            verified_rows=n_rows, emb_table_mb=emb.numel() * 4 / 1e6,
            publish_full_ms_median=sorted(t)[2],
            delta_ms=rep["delta_refresh"]["seconds"] * 1e3,
            replicas=rep["replicas"], seconds=secs)
        log(f"[serve-front] gdelt_like@paper store (4,096 kB cache), 2 "
            f"replicas, open loop at half the closed loop's QPS, Zipf 1.1, "
            f"60 stream events: {json.dumps(res)}")
        ids = rng.choice(eng.pg.part_of.size, size=64, replace=False)
        rows = rng.normal(0, 1, (64, eng.pg.x.shape[-1])).astype(np.float32)
        _, wall, busy, groups, _ = profile_device(
            lambda: eng.refresh(ids, rows),
            "one store-backed 64-node delta refresh on gdelt_like@paper")
        out["gdelt"]["profiled_delta"] = dict(host_ms=wall, busy_ms=busy,
                                              groups=groups)
        del eng, sweeps
        torch.cuda.empty_cache()

        # -- 5. tracing on: item 1's serving and 3 epochs of Sylvie-A --------
        # (1) again, restored (no training): untraced, then traced
        warm, wsweeps, wtotal, *_ = serve(*gcn_argv)
        obs.reset_metrics()
        obs.enable()
        rep5, sweeps5, total5, *_ = serve(*gcn_argv)
        serve_events = obs.drain()
        obs.disable()
        for tag, r, sw, tot in (("untraced", warm, wsweeps, wtotal),
                                ("traced", rep5, sweeps5, total5)):
            check(np.array_equal(tot, wtotal)
                  and np.array_equal(tot[[names.index(k)
                                          for k in TRAIN_KERNELS]], served)
                  and [s[2] for s in sw] == [SERVE_LAUNCHES["gcn"]] * len(sw)
                  and len(sw) == out["gcn"]["sweeps"],
                  f"[serve-front] {tag} serving launched {tot}, the first "
                  f"run's sweeps {served}")
            check(same(sw[-1][0]._logits_host, final_logits),
                  f"[serve-front] {tag} serving logits == the first run's, "
                  f"bit for bit")
            for k in ("requests", "refreshes", "refresh_wire_bytes"):
                check(r["load"][k] == out["gcn"][k],
                      f"[serve-front] {tag} {k} {r['load'][k]}")
        full_ms = sorted(s[3].seconds * 1e3 for s in wsweeps
                         if s[1] == "full")
        delta_ms = sorted(s[3].seconds * 1e3 for s in wsweeps
                          if s[1] == "delta")
        out["gcn"].update(warm_qps=warm["load"]["qps"],
                          warm_p50_ms=warm["load"]["p50_ms"],
                          warm_p99_ms=warm["load"]["p99_ms"],
                          warm_full_sweep_ms=full_ms,
                          warm_delta_ms_median=delta_ms[len(delta_ms) // 2])
        log(f"[serve-front] gcn serve_once again, restored, untraced: "
            f"{json.dumps({k: v for k, v in out['gcn'].items() if k.startswith('warm')})}")
        serve_spans = span_tree(serve_events)
        for name in ("admit", "request", "lookup", "refresh", "plan",
                     "sweep"):
            check(name in serve_spans, f"[serve-front] no {name} span")
        del sweeps5, wsweeps

        def sylvie_a(traced: bool) -> tuple:
            torch.manual_seed(SEED)
            model = configs.get("gcn").config().make(gcn_pg.x.shape[-1],
                                                     gcn_pg.n_classes)
            tr = GNNTrainer(model, gcn_pg, SylvieConfig(mode="async", bits=1),
                            policy=BoundedStaleness(eps_s=4, bits=1),
                            seed=SEED)
            (obs.enable if traced else obs.disable)()
            hist = []
            for _ in range(3):
                zero()
                m = tr.train_epoch()
                got = pinned(snap())
                check(got == TRAIN_LAUNCHES[("gcn", "sylvie_a", m.mode)],
                      f"[serve-front] Sylvie-A epoch {m.epoch} ({m.mode}, "
                      f"traced {traced}) launched {got}")
                hist.append(m)
            events = obs.drain()
            obs.disable()
            return hist, events
        plain, _ = sylvie_a(False)
        traced, train_events = sylvie_a(True)
        check([m.loss for m in plain] == [m.loss for m in traced]
              and [m.mode for m in traced] == ["sync", "async", "async"],
              f"[serve-front] traced losses {[m.loss for m in traced]} == "
              f"untraced {[m.loss for m in plain]}, bit for bit")
        check(all(m.wall_s >= m.seconds > 0.0 for m in plain + traced),
              "[serve-front] EpochMetrics.wall_s >= seconds")
        train_spans = span_tree(train_events)
        check({k: v[0] for k, v in train_spans.items()}
              == {"decide": 3, "epoch": 3, "step": 3},
              f"[serve-front] training spans {train_spans}")
        obs_dir = obs.default_obs_dir() / "chip_smoke"
        for run, events in (("serve", serve_events),
                            ("train", train_events)):
            trace = obs.write_trace(obs_dir / f"{run}.trace.json", events)
            obs.write_metrics(obs_dir / f"{run}.metrics.json",
                              metrics=obs.snapshot(),
                              run=f"chip_smoke/{run}",
                              trace_path=str(trace))
        out["spans"] = dict(serve=serve_spans, train=train_spans,
                            traced_qps=rep5["load"]["qps"],
                            traced_p50_ms=rep5["load"]["p50_ms"],
                            traced_p99_ms=rep5["load"]["p99_ms"],
                            untraced_qps=warm["load"]["qps"],
                            wall_ms=[m.wall_s * 1e3 for m in traced],
                            step_ms=[m.seconds * 1e3 for m in traced])
        log(f"[serve-front] traced (obs on): launches and logits / losses "
            f"bit-equal to the untraced runs; spans [count, median host ms] "
            f"{json.dumps(out['spans'])}; trace and metrics -> {obs_dir}")
    return out


CHAOS_EPOCHS = 20     # chaos_smoke's 6, extended for the epoch medians
CHAOS_FAULT = "drop=0.15,corrupt=0.05,seed=7"     # the chaos_smoke spec
CHAOS_ARCHS = ("gcn", "gat")


def stream_profile(fn, label: str) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and read its trace's device
    activities (kernels, copies, memsets) by CUDA stream: the device-busy ms
    (the union of every stream's intervals), each stream's busy ms, and the
    ms during which the main stream (the one with the most device time) and
    any other stream ran at once. The trace goes to ``build/``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    path = ROOT / "build" / f"chaos_profile_{label}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    by_stream: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            sid = e.get("args", {}).get("stream", e.get("tid"))
            by_stream.setdefault(sid, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))

    def union(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def length(iv):
        return sum(b - a for a, b in iv)

    merged = {s: union(iv) for s, iv in by_stream.items()}
    main = max(merged, key=lambda s: length(merged[s])) if merged else None
    others = union([i for s, iv in merged.items() if s != main for i in iv])
    both, j = 0.0, 0
    for a, b in merged.get(main, []):
        while j < len(others) and others[j][1] <= a:
            j += 1
        k = j
        while k < len(others) and others[k][0] < b:
            both += min(b, others[k][1]) - max(a, others[k][0])
            k += 1
    res = dict(host_ms=wall,
               busy_ms=length(union([i for iv in by_stream.values()
                                     for i in iv])) / 1e3,
               streams={str(s): dict(busy_ms=length(iv) / 1e3,
                                     activities=len(by_stream[s]))
                        for s, iv in merged.items()},
               concurrent_ms=both / 1e3)
    log(f"[chaos] profile {label}: {json.dumps(res)}")
    return res


def chaos_phase(all_kernels: dict) -> dict:
    """Fault-tolerant training, the overlap schedule, kill-and-resume and
    the scenario runner on the card (see the module docstring)."""
    from repro_torch import configs, datasets
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.launch import scenarios
    from repro_torch.policy import BoundedStaleness, Uniform
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.trainer import GNNTrainer

    t_phase = time.perf_counter()
    names = list(all_kernels)

    def zero() -> None:
        for meta in all_kernels.values():
            meta["k"].launches = 0

    def counts() -> tuple:
        return tuple(all_kernels[k]["k"].launches for k in TRAIN_KERNELS)

    pg, _ = datasets.load_partitioned("reddit_like@paper", n_parts=4)
    d_in, n_cls = pg.x.shape[-1], pg.n_classes
    plan = scenarios.parse_fault(CHAOS_FAULT)
    runs = {"sylvie_s": (SylvieConfig(mode="sync", bits=1),
                         lambda: Uniform(bits=1)),
            "sylvie_a": (SylvieConfig(mode="async", bits=1),
                         lambda: BoundedStaleness(eps_s=4, bits=1))}
    out: dict = dict(launches={})

    def trainer(arch, cfg, pol, **kw):
        torch.manual_seed(SEED)
        model = configs.get(arch).config().make(d_in, n_cls)
        return GNNTrainer(model, pg, cfg, policy=pol, seed=SEED, **kw)

    # (a) faulted training at full width, beside the same runs fault-free,
    # their epochs in turns
    for arch in CHAOS_ARCHS:
        for name, (cfg, pol) in runs.items():
            trs = {key: trainer(arch, cfg, pol(), fault_plan=fp)
                   for key, fp in (("faulted", plan), ("clean", None))}
            for _ in range(CHAOS_EPOCHS):
                for key, tr in trs.items():
                    zero()
                    m = tr.train_epoch()
                    got = counts()
                    tag = f"[chaos] {arch} {name} {key} epoch {m.epoch} " \
                          f"({m.mode})"
                    recovery = m.forced_syncs > 0
                    want = TRAIN_LAUNCHES[(arch, "vanilla", "sync")
                                          if recovery else (arch, name,
                                                            m.mode)]
                    check(got == want and all_kernels["flash_fwd"]["k"]
                          .launches == 0,
                          f"{tag}: launches {got}, expected {want}")
                    drawn = plan.events(m.epoch, tr.n_sites, 4).n_injected \
                        if key == "faulted" else 0
                    check(m.faults_injected == drawn == m.halos_reused
                          + m.forced_syncs,
                          f"{tag}: injected {m.faults_injected} (the plan "
                          f"draws {drawn}) != reused {m.halos_reused} + "
                          f"forced {m.forced_syncs}")
                    if key == "faulted" and not recovery:
                        out["launches"][
                            f"{arch}_train_faulted_{name}_{m.mode}_step"] = {
                            k: all_kernels[k]["k"].launches for k in names}
            hist = {key: tr.history for key, tr in trs.items()}
            del trs
            for key, h in hist.items():
                check(all(np.isfinite([m.loss for m in h])),
                      f"[chaos] {arch} {name} {key}: losses finite "
                      f"{[m.loss for m in h]}")
            check(sum(m.faults_injected for m in hist["faulted"]) > 0,
                  f"[chaos] {arch} {name}: no fault injected")
            # epochs 1.. in the same mode in both runs, recovery epochs out
            pairs = [(f.seconds * 1e3, c.seconds * 1e3, f.mode)
                     for f, c in zip(hist["faulted"][1:], hist["clean"][1:])
                     if f.mode == c.mode and not f.forced_syncs]
            med = {}
            for mode in ("sync", "async"):
                fs = sorted(f for f, _, md in pairs if md == mode)
                cs = sorted(c for _, c, md in pairs if md == mode)
                ratio = sorted(f / c for f, c, md in pairs if md == mode)
                if fs:
                    med[mode] = dict(
                        faulted_ms=fs[len(fs) // 2],
                        clean_ms=cs[len(cs) // 2],
                        overhead=ratio[len(ratio) // 2] - 1.0,
                        epochs=len(fs))
            res = out[f"{arch}_{name}"] = dict(
                median=med,
                accounting=[(m.faults_injected, m.halos_reused,
                             m.forced_syncs, m.mode)
                            for m in hist["faulted"]],
                loss_faulted=[m.loss for m in hist["faulted"]],
                loss_clean=[m.loss for m in hist["clean"]])
            log(f"[chaos] {arch} {name} under {CHAOS_FAULT}, {CHAOS_EPOCHS} "
                f"epochs in turns with the same run fault-free: median epoch "
                f"ms by mode (epochs 1.., recovery epochs left out; overhead "
                f"= the median of the paired ratios - 1) "
                f"{json.dumps(med)}; per epoch (injected, reused, forced, "
                f"mode) {res['accounting']}; losses faulted "
                f"{[round(x, 4) for x in res['loss_faulted']]} clean "
                f"{[round(x, 4) for x in res['loss_clean']]}")
    torch.cuda.empty_cache()

    # (b) a rate-zero plan against no plan: the parameters bit for bit
    cfg, pol = runs["sylvie_s"]
    params = []
    for fp in (None, scenarios.parse_fault("seed=7")):
        tr = trainer("gcn", cfg, pol(), fault_plan=fp)
        tr.fit(3)
        params.append(optlib.tree_leaves(tr.state.params))
        del tr
    check(all(same_bits(a, b) for a, b in zip(*params)),
          "[chaos] a rate-zero plan trains the parameters of no plan")
    log("[chaos] GCN Sylvie-S, 3 epochs: a rate-zero plan's parameters equal "
        "no plan's bit for bit")

    # (c) overlap against blocking: bit-equal parameters, equal launches;
    # then one profiled async epoch under each schedule
    for arch in CHAOS_ARCHS:
        for mode in ("sync", "async"):
            res = {}
            for sched in ("blocking", "overlap"):
                tr = trainer(arch, SylvieConfig(mode=mode, bits=1,
                                                schedule=sched),
                             Uniform(bits=1))
                seen = []
                for _ in range(3):
                    zero()
                    m = tr.train_epoch()
                    seen.append((m.mode, tuple(
                        all_kernels[k]["k"].launches for k in names)))
                    if sched == "overlap":
                        out["launches"][f"{arch}_train_overlap_{m.mode}_"
                                        f"step"] = dict(zip(names,
                                                            seen[-1][1]))
                res[sched] = (seen, optlib.tree_leaves(tr.state.params),
                              [m.loss for m in tr.history],
                              [round(m.seconds * 1e3, 3) for m in tr.history])
                if mode == "async":
                    res[sched] += (stream_profile(
                        tr.train_epoch, f"{arch}_{sched}_async"),)
                del tr
            (sb, pb, lb), (so, po, lo) = (res["blocking"][:3],
                                          res["overlap"][:3])
            check(sb == so, f"[chaos] {arch} {mode}: launches per epoch "
                  f"blocking {sb} != overlap {so}")
            check(lb == lo and all(same_bits(a, b) for a, b in zip(pb, po)),
                  f"[chaos] {arch} {mode}: overlap parameters and losses "
                  f"{lo} bit-equal to blocking {lb}")
            log(f"[chaos] {arch} {mode}: 3 epochs, overlap == blocking bit "
                f"for bit (losses {lb}), launches equal {sb}; epoch ms "
                f"blocking {res['blocking'][3]} overlap "
                f"{res['overlap'][3]}")
            if mode == "async":
                out[f"{arch}_overlap_profile"] = {
                    s: res[s][4] for s in ("blocking", "overlap")}
    torch.cuda.empty_cache()

    # (d) kill-and-resume on the card, in worker processes
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.chaos", "--kill-resume",
           "--dataset", "reddit_like@paper", "--epochs", "4"]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    kr = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                        text=True, timeout=600)
    check(kr.returncode == 0, f"[chaos] kill-resume exited {kr.returncode}:"
          f"\n{kr.stdout}\n{kr.stderr}")
    report = json.loads(kr.stdout[kr.stdout.index("{"):])
    check('"bit_exact": true' in kr.stdout and report["bit_exact"],
          f"[chaos] kill-resume not bit-exact: {kr.stdout}")
    check(report["plan_cache_hits"][1:] == [True, True],
          f"[chaos] kill-resume legs 2 and 3 plan-cache hits: "
          f"{report['plan_cache_hits']}")
    out["kill_resume"] = dict(report, seconds=time.perf_counter() - t0)
    log(f"[chaos] kill-resume on reddit_like@paper (uniform:1 sync, 4 "
        f"epochs): {json.dumps(out['kill_resume'])}")

    # (e) the scenario runner on the card
    t0 = time.perf_counter()
    art = ROOT / "artifacts" / "torch" / "chip_smoke"
    reps = scenarios.run_scenario("chaos_smoke", out_dir=art / "scenarios")
    for rep in reps:
        check(rep["faults_injected"] == rep["halos_reused"]
              + rep["forced_syncs"] and rep["faults_injected"] > 0,
              f"[chaos] {rep['cell']}: accounting {rep['faults_injected']} "
              f"== {rep['halos_reused']} + {rep['forced_syncs']} > 0")
    cell = scenarios.resolve("smoke").cells()[0].cell_id
    (rep,) = scenarios.run_scenario("smoke", only=cell,
                                    out_dir=art / "scenarios",
                                    obs_trace=True, obs_dir=art / "obs")
    check(set(rep) == scenarios.REPORT_KEYS and rep["obs"]["enabled"]
          and Path(rep["trace_path"]).is_file(),
          f"[chaos] traced smoke cell: keys {sorted(rep)}, trace "
          f"{rep['trace_path']}")
    out["scenarios"] = dict(
        chaos_smoke={r["cell"]: [r["faults_injected"], r["halos_reused"],
                                 r["forced_syncs"], r["final_loss"]]
                     for r in reps},
        smoke_cell=cell, trace=rep["trace_path"],
        seconds=time.perf_counter() - t0)
    log(f"[chaos] scenarios: {json.dumps(out['scenarios'])}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[chaos] phase done in {out['seconds']:.1f} s")
    return out


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
    from repro_torch.kernels.flash import ops as fops
    from repro_torch.kernels.gat import ops as gops
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
    # GAT's kernels are the port's own: the JAX package computes the same
    # functions outside any Pallas kernel, at these lines
    gat_kernels = {
        sops.SPMM_HEADS.name: dict(
            k=sops.SPMM_HEADS, source="src/repro_torch/kernels/csrc/spmm.cu",
            replaces="src/repro/models/gnn/models.py:141"),
        gops.GAT_SOFTMAX.name: dict(
            k=gops.GAT_SOFTMAX, source="src/repro_torch/kernels/csrc/gat.cu",
            replaces="src/repro/models/gnn/blocks.py:132"),
        gops.SDDMM_HEADS.name: dict(
            k=gops.SDDMM_HEADS, source="src/repro_torch/kernels/csrc/gat.cu",
            replaces="src/repro/models/gnn/models.py:140"),
        gops.GAT_SOFTMAX_BWD.name: dict(
            k=gops.GAT_SOFTMAX_BWD,
            source="src/repro_torch/kernels/csrc/gat.cu",
            replaces="src/repro/models/gnn/blocks.py:132"),
    }
    lm_kernels = {
        fops.FLASH_FWD.name: dict(
            k=fops.FLASH_FWD, source="src/repro_torch/kernels/csrc/flash.cu",
            replaces="src/repro/kernels/flash/flash.py:32"),
    }
    all_kernels = {**kernels, **gat_kernels, **lm_kernels}

    # -- 2. build ------------------------------------------------------------
    secs = build.build_all()
    log(f"[build] {len(build.SOURCES)} sources -> {build.BUILD_DIR} in "
        f"{secs:.1f} s")

    # -- 3. the slice: GCN 256x2 serving reddit_like@paper, P=4, 1 bit --------
    t0 = time.perf_counter()
    pg, _ = datasets.load_partitioned("reddit_like@paper", n_parts=4)
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

    for meta in all_kernels.values():
        meta["k"].launches = 0
    rep = eng.full_sweep()
    torch.cuda.synchronize()
    serve_launches = {name: meta["k"].launches
                      for name, meta in all_kernels.items()}
    launches = {name: serve_launches[name] for name in kernels}
    check(all(serve_launches[k] == 0 for k in ("flash_fwd", *gat_kernels)),
          "the GCN path launches no flash and no GAT kernel")
    log(f"[slice] full sweep {rep.seconds * 1e3:.3f} ms (first, host clock), "
        f"launches {launches}, wire bytes {rep.wire_bytes}")
    for name, n in launches.items():
        exact = name != sops.SPMM.name
        check(n == eng.n_sites if exact else n >= eng.n_sites,
              f"{name} launched {n} times in one sweep, expected "
              f"{'' if exact else 'at least '}{eng.n_sites}")
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
        f"{busy:.3f} ms ({100 * busy / wall:.1f}% of the host time), "
        f"{sum(e.count for e in on_dev)} device launches")
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
    spg, _ = datasets.load_partitioned("yelp_like@smoke", n_parts=4)
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
    # the same CSR under other plans, timed only: other segment lengths, and
    # the units sorted heaviest first instead of in CSR order
    alt_plans = {}
    for seg in (64, 256):
        alt_plans[f"segment {seg}"] = sref.CSR(
            csr.row_ptr, csr.col, csr.w, csr.n_cols,
            *(x.to(csr.col.device) if torch.is_tensor(x) else x
              for x in sref.split_plan(csr.row_ptr.cpu().numpy(), seg)))
    length = csr.units[:, 1] - csr.units[:, 0]
    alt_plans["heaviest first"] = dataclasses.replace(csr, units=csr.units[
        torch.argsort(length, descending=True, stable=True)].contiguous())
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
                q_err, d_err = check_quant(qops, qref, buf, u, bits,
                                           f"site {site}")
                errs["quantize_pack"] = max(errs["quantize_pack"], q_err)
                errs["unpack_dequantize"] = max(errs["unpack_dequantize"],
                                                d_err)
        # the sweep's own call: 1 bit, deterministic, bf16 scale/zero
        w, ec = qref.packed_width(d, 1), 2 * 2
        u = torch.rand(buf.shape, device=buf.device,
                       generator=torch.Generator("cuda").manual_seed(site))
        pk, sk, zk = qops.quantize_pack_rows(buf, None, 1, torch.bfloat16)
        quant = lambda: qops.quantize_pack_rows(buf, None, 1, torch.bfloat16)
        squant = lambda: qops.quantize_pack_rows(buf, u, 1, torch.bfloat16)
        deq = lambda: qops.dequantize_rows(pk, sk, zk, 1, d)
        qb, qo = bound(rows_ * d * 4 + rows_ * (w + ec), rows_ * d * 8)
        qsb, qso = bound(2 * rows_ * d * 4 + rows_ * (w + ec), rows_ * d * 10)
        db, do = bound(rows_ * (w + ec) + rows_ * d * 4, rows_ * d * 2)
        detail.append(dict(
            site=site, shape=[rows_, d], bits=1, scale_dtype="bfloat16",
            quantize_ms=device_ms(quant, "quantize_pack"),
            quantize_event_ms=cuda_ms(quant),
            quantize_plain_ms=cuda_ms(lambda: [
                t.bfloat16() for t in qref.quantize_pack_ref(buf, None, 1)]),
            quantize_bound_ms=qb, quantize_bound_by=qo,
            quantize_stochastic_ms=device_ms(squant, "quantize_pack"),
            quantize_stochastic_event_ms=cuda_ms(squant),
            quantize_stochastic_bound_ms=qsb,
            quantize_stochastic_bound_by=qso,
            dequantize_ms=device_ms(deq, "unpack_dequantize_kernel"),
            dequantize_event_ms=cuda_ms(deq),
            dequantize_plain_ms=cuda_ms(lambda: qref.unpack_dequantize_ref(
                pk, sk.float(), zk.float(), 1, d)),
            dequantize_bound_ms=db, dequantize_bound_by=do))
        table = B.halo_table(h, eng._halos[site])
        table = table.reshape(-1, table.shape[-1]).contiguous()
        out_k = sops.spmm(table, csr)
        out_r = sref.spmm_ref(table, csr)
        err = float((out_k - out_r).abs().max())
        check(torch.equal(out_k, out_r), f"spmm site {site}: bit-equal to the "
              f"plain version (max abs err {err})")
        check(torch.equal(out_k, sops.spmm(table, csr)),
              f"spmm site {site}: same bits on a second run")
        log(f"[kernels] spmm site {site}: bit-equal to the plain version and "
            f"on a second run; {csr.long_rows.numel()} of {csr.n_rows} rows "
            f"split at SEGMENT {sref.SEGMENT} into {csr.n_partials} segments, "
            f"{csr.units.shape[0]} work units")
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
            spmm_bound_ms=sb, spmm_bound_by=so,
            spmm_other_plans_ms={
                name: cuda_ms(lambda: sops.spmm(table, alt))
                for name, alt in alt_plans.items()})
        log(f"[kernels] site {site}: {json.dumps(detail[-1])}")
    log(f"[kernels] max abs err vs plain versions: {errs}")
    n_cases = quant_shape_sweep(qops, qref)
    log(f"[kernels] quantize/dequantize shape sweep: {n_cases} cases (bits "
        f"1/2/4/8, stochastic and deterministic, d {list(SWEEP_D)}, rows "
        f"1/7/1000, contiguous / offset by one element / constant rows), "
        f"scale/zero float32 and bfloat16: all bit-equal to the plain "
        f"versions")
    del eng, eng_s, pg, model, runtime, plan, csr, table, out_k, out_r, buf
    del pk, sk, zk, u
    del alt_plans
    del sparse, prof, out, e, spg, small
    torch.cuda.empty_cache()

    # -- 6. GCN, GraphSAGE, GAT training on reddit_like@paper ------------------
    tr = train_phase(all_kernels)

    # -- 7. the backward's kernels vs their plain versions ---------------------
    trk = train_kernels_phase(tr.pop("recorded"), tr.pop("block"))
    for name in errs:
        errs[name] = max(errs[name], trk[name])
    torch.cuda.empty_cache()

    # -- 7b. GAT's kernels vs their plain versions ------------------------------
    gk = gat_kernels_phase(tr.pop("gat_recorded"), tr.pop("gat_block"))
    torch.cuda.empty_cache()

    # -- 8. training, card vs the CPU's plain versions -------------------------
    train_parity_phase()

    # -- 9. the LM: granite-3-2b at full width, prefill + greedy decode -------
    lm = lm_phase(all_kernels)

    # -- 10. small LMs: card vs the CPU's plain versions -----------------------
    lm_small_phase()

    # -- 11. the flash kernel vs its plain versions on layer 0's q/k/v ---------
    fl = flash_phase(*lm.pop("qkv"))
    torch.cuda.empty_cache()

    # -- 11b. the serving front: serve_once, store, degraded mode, tracing -----
    # last: its host work (checkpoints written and restored, the store's
    # host tables) must not shift the host-clock times of the phases above
    sf = serve_front_phase(all_kernels)

    # -- 11c. chaos: faults, the overlap schedule, kill-and-resume, scenarios --
    # last: it spawns processes and writes checkpoints
    torch.cuda.empty_cache()
    ch = chaos_phase(all_kernels)

    # -- 12. summary ----------------------------------------------------------
    s0 = detail[0]
    times = {
        "quantize_pack": ("quantize", None),
        "unpack_dequantize": ("dequantize", None),
        "spmm_csr": ("spmm", "spmm_library_ms"),
    }
    # the Low-bit Module's further times: event time, stochastic rounding
    extra = {
        "quantize_pack": ("event_ms", "stochastic_ms", "stochastic_event_ms",
                          "stochastic_bound_ms"),
        "unpack_dequantize": ("event_ms",),
        "spmm_csr": (),
    }
    # launches per path: one serving sweep (the slice's, and the serving
    # front's of each arch), one training step of each kind, one LM generate
    per_path = {name: dict(
        gcn_serve_sweep=serve_launches[name],
        **{path: n.get(name, 0) for path, n in sf["launches"].items()},
        **{path: n[name] for path, n in tr["launches"].items()},
        **{path: n[name] for path, n in ch["launches"].items()},
        lm_generate=lm["launches"][name]) for name in all_kernels}
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
            shape=s0["spmm_shape" if key == "spmm" else "shape"],
            launches_per_path=per_path[name],
            **{k: s0[f"{key}_{k}"] for k in extra[name]},
            **({k: v for k, v in trk.items() if k.startswith(
                ("transposed", "scatter"))} if key == "spmm" else {})))
    # GAT's kernels: their launches in one GAT Sylvie-S step (their main
    # path), times on that step's tensors; the backward's variants beside
    gat_step = tr["launches"]["gat_train_sylvie_s_sync_step"]
    for name, meta in gat_kernels.items():
        main = gk[name]
        twin = gk.get(f"{name}_t")
        summary.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=gat_step[name],
            max_abs_err=max(main["max_abs_err"],
                            twin["max_abs_err"] if twin else 0.0),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main["shape"],
            bit_equal=main["bit_equal"], launches_per_path=per_path[name],
            **({k: main[k] for k in ("device_ms", "phases_ms",
                                     "cuda_launches_per_call") if k in main}),
            **({f"transposed_{k}": twin[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "bit_equal", "device_ms", "phases_ms",
                "cuda_launches_per_call")
                if twin.get(k) is not None}
               if twin else {}),
            **({k: main[k] for k in ("gathered_gb", "gather_tb_s")
                if k in main}),
            **({"transposed_gather_path_ms": twin["gather_path_ms"],
                "transposed_gather_tb_s": twin["gather_tb_s"]}
               if twin and "gather_path_ms" in twin else {}),
            **({"other_shapes_ms": main["shapes"]} if "shapes" in main
               else {}),
            **({"transposed_other_shapes_ms": twin["shapes"]}
               if twin and "shapes" in twin else {})))
    meta = lm_kernels["flash_fwd"]
    summary.append(dict(
        name="flash_fwd", route="cuda", source=meta["source"],
        replaces=meta["replaces"], launches=lm["launches"]["flash_fwd"],
        launches_per_path=per_path["flash_fwd"],
        max_abs_err=fl["max_abs_err"], ms=fl["ms"], plain_ms=fl["plain_ms"],
        bound_ms=fl["bound_ms"], bound_by=fl["bound_by"],
        library_ms=fl["library_ms"], shape=fl["shape"],
        model_call_ms=fl["bshd_ms"], model_call_bound_ms=fl["bshd_bound_ms"],
        d128_ms=fl["d128_ms"], d128_library_ms=fl["d128_library_ms"]))
    print(json.dumps({"kernels": summary}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
