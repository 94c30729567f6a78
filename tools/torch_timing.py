"""Timing on one CUDA card, shared by ``chip_smoke.py`` and
``tools/torch_gat_check.py``: CUDA-event time of back-to-back calls, device
time of the kernels a call launches (``torch.profiler``), and the library
calls that compute GAT's edge softmax, its backward and the transposed row
sums, softcapped attention and the attention's backward (timed as
yardsticks only; the port never calls them).

It imports torch alone, so it times the port of whichever checkout the
caller put on ``sys.path``.
"""
from __future__ import annotations

import re
import warnings

import torch


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


def kernel_times(fn, kernel: str = "", expect: int = 1, iters: int = 20,
                 traces: int = 3) -> dict:
    """{CUDA kernel: [device ms per launch, launches per call]} of the
    kernels ``fn`` launches whose name contains ``kernel`` (a wrapper's
    phases, with ``kernel`` empty), by ``torch.profiler`` over ``iters``
    calls, traced in a second cycle after a first, warm-up one. No host time
    and no gap between launches is in it, which CUDA events around
    back-to-back calls of a short kernel cannot promise. A kernel is named
    by its ``*_kernel<...>`` template where it has one. The trace may miss
    some launches of a kernel launched from a library of its own (seen on
    the card: 8 of 20, and once all 20; the launches per call say how many
    it held), so a trace that holds fewer than ``expect`` kernels is taken
    again, up to ``traces`` times, and then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()                      # the warm-up cycle ends here
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.count \
                    and kernel in e.key:
                name = re.search(r"\w+_kernel<[^>]*>", e.key)
                out[name.group(0) if name else e.key[:60]] = [
                    e.self_device_time_total / e.count / 1e3,
                    e.count / iters]
        if len(out) >= expect:
            return out
        print(f"[profile] the trace held {len(out)} of the {expect} kernels "
              f"named {kernel or 'anything'}; tracing again", flush=True)
    raise RuntimeError(f"the profiler saw {len(out)} of the {expect} kernels "
                       f"named {kernel or 'anything'} in {iters} calls, "
                       f"{traces} traces")


def device_ms(fn, kernel: str, iters: int = 20, traces: int = 3) -> float:
    """Device milliseconds per launch of the CUDA kernel whose name contains
    ``kernel``, launched at most once a call (``kernel_times``). Where no
    trace holds it (seen on the card: three traces in a row), the call's
    CUDA-event time instead (``cuda_ms``, host gaps included), and a line
    says so."""
    try:
        ev = kernel_times(fn, kernel, 1, iters, traces).values()
    except RuntimeError as err:
        print(f"[profile] {err}; {kernel} timed by CUDA events instead",
              flush=True)
        return cuda_ms(fn, iters)
    n = sum(per_call for _, per_call in ev)
    if n > 1:
        raise RuntimeError(f"{kernel}: {n} launches a call, expected one")
    return sum(ms * per_call for ms, per_call in ev) / n


def softmax_library_ms(csr, s_src, s_dst, alpha, a_b, da_b, ss_b, sd_b, dx,
                       sums_t) -> dict:
    """The library calls that compute GAT's edge softmax and its backward,
    beside the kernels' own outputs. ``torch.sparse.softmax`` over dim 1 of
    a hybrid COO tensor (rows, edges, H) of the scores from ``s_src`` and
    ``s_dst``, held to ``alpha``; its backward
    (``aten._sparse_softmax_backward_data``) from ``a_b`` and ``da_b`` over
    the scores from ``ss_b`` and ``sd_b`` (mode 0); and ``index_add_`` of
    ``dx`` over the CSR's columns, held to the transposed row sums
    ``sums_t`` (mode 1). The column of the COO tensor is the edge itself:
    the CSR repeats (row, source) pairs, which coalescing would add. The
    first two cover the softmax over each row's edges and its gradient, not
    the gather of ``s_src``, the leaky ReLU or its slope, nor ``d s_dst``'s
    row sums; ``index_add_`` covers all of mode 1 but adds in no fixed
    order. Returns {call: {"ms": CUDA-event ms, "max_abs_diff": against the
    kernel}} for "softmax", "softmax_bwd" (whose kernel output it is not
    held to: the slope is outside it) and "row_sums_t"."""
    nnz, h = csr.nnz, alpha.shape[1]
    col = csr.col.long()
    rows_e = torch.repeat_interleave(
        torch.arange(csr.n_rows, device=col.device),
        (csr.row_ptr[1:] - csr.row_ptr[:-1]).long())
    idx = torch.stack([rows_e, torch.arange(nnz, device=col.device)])

    def coo(values):
        return torch.sparse_coo_tensor(idx, values, (csr.n_rows, nnz, h)
                                       ).coalesce()

    def scores(ss, sd):
        x = ss[col] + sd[rows_e]
        return torch.where(x >= 0, x, 0.2 * x)

    def diff(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0
    out = {}
    with warnings.catch_warnings():        # sparse invariant checks
        warnings.simplefilter("ignore")
        sp = coo(scores(s_src, s_dst))
        out["softmax"] = dict(
            ms=cuda_ms(lambda: torch.sparse.softmax(sp, 1)),
            max_abs_diff=diff(torch.sparse.softmax(sp, 1).values(), alpha))
        sp_b, a_sp, g_sp = coo(scores(ss_b, sd_b)), coo(a_b), coo(da_b)
        out["softmax_bwd"] = dict(
            ms=cuda_ms(lambda: torch.ops.aten._sparse_softmax_backward_data(
                g_sp, a_sp, 1, sp_b)), max_abs_diff=None)
    sums = lambda: torch.zeros((csr.n_cols, h), device=dx.device).index_add_(
        0, csr.col, dx)
    out["row_sums_t"] = dict(ms=cuda_ms(sums),
                             max_abs_diff=diff(sums(), sums_t))
    return out


def flex_attention_ms(q, k, v, *, window, softcap: float, scale: float,
                      d_out=None):
    """One ``flex_attention`` call that computes the LM's softcapped causal
    (windowed) attention: q (B, Sq, H, D), k/v (B, Skv, Hkv, D) as
    ``attention_bshd`` takes them, copied once to the (B, H, S, D) layout
    the library takes; ``softcap * tanh(score / softcap)`` as its
    ``score_mod`` (on the scaled score, as ``blockwise_attention`` caps it),
    the causal and window mask as a block mask (which skips the tiles no
    row sees), GQA through ``enable_gqa``. Compiled once (untimed: Triton
    kernels generated by Inductor, cached under the checkout's ``build/``,
    compiled in this process). Returns (CUDA-event ms, its output in
    ``attention_bshd``'s (B, Sq, H, D) layout). With ``d_out`` (the output's
    gradient, in that layout) it times the backward instead (its compiled
    backward, ``torch.autograd.grad`` of one forward kept alive) and returns
    (ms, (dq, dk, dv) in ``attention_bshd``'s layouts)."""
    import os
    from pathlib import Path
    build = Path(__file__).resolve().parents[1] / "build"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def capped(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    def visible(b, h, q_idx, kv_idx):
        seen = kv_idx <= q_idx
        return seen if window is None else seen & (q_idx - kv_idx < window)
    mask = create_block_mask(visible, None, None, q.shape[1], k.shape[1],
                             device=q.device)
    call = torch.compile(flex_attention, dynamic=False)

    def run():
        return call(qh, kh, vh, score_mod=capped, block_mask=mask,
                    scale=scale, enable_gqa=kh.shape[1] != qh.shape[1])
    if d_out is None:
        out = run().transpose(1, 2)
        return cuda_ms(run), out
    for t in (qh, kh, vh):
        t.requires_grad_(True)
    out = run()
    g = d_out.transpose(1, 2).contiguous()

    def grads():
        return torch.autograd.grad(out, (qh, kh, vh), g, retain_graph=True)
    ms = cuda_ms(grads, iters=3, warmup=1)
    return ms, tuple(x.transpose(1, 2) for x in grads())


def sdpa_backward_ms(q, k, v, d_out, *, scale: float):
    """The backward of one ``scaled_dot_product_attention`` call (causal,
    float32) that computes ``attention_bshd`` with neither window nor
    softcap: q (B, S, H, D), k (B, S, Hkv, D), v (B, S, Hkv, Dv) copied to
    the (B, H, S, D) layout, KV heads repeated to H (what a GQA call costs
    the library beside the port's in-kernel sum). ``torch.autograd.grad`` of
    one forward kept alive, by CUDA events; returns (ms, (dq, dk, dv) in
    ``attention_bshd``'s layouts, dk and dv summed over each KV head's
    query heads)."""
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    kh, vh = (x.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
              .requires_grad_(True) for x in (k, v))
    qh = q.transpose(1, 2).contiguous().requires_grad_(True)
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                         scale=scale)
    do = d_out.transpose(1, 2).contiguous()

    def grads():
        return torch.autograd.grad(out, (qh, kh, vh), do, retain_graph=True)
    ms = cuda_ms(grads, iters=3, warmup=1)
    dq, dk, dv = (x.transpose(1, 2) for x in grads())
    b, s, hkv = k.shape[:3]
    dk = dk.reshape(b, s, hkv, g, -1).sum(3)
    dv = dv.reshape(b, s, hkv, g, -1).sum(3)
    return ms, (dq, dk, dv)
