"""Wrappers of the flash-attention forward kernel (``csrc/flash.cu``).

Three entry points, with the JAX package's signatures so the tests compare
like with like:

* :func:`flash_fwd` — raw ``(acc, m, l)`` over (BH, S, D)
  (``repro/kernels/flash/flash.py:76``);
* :func:`flash_attention` — the normalised attention
  (``repro/kernels/flash/ops.py:15``);
* :func:`attention_bshd` — the LM's prefill attention in the model's own
  (B, S, H, D) layout with GQA, the attention-logit softcap and values
  narrower than the queries (MLA) (``repro/models/lm/model.py:126``
  ``blockwise_attention``); the LM calls this one.

Every entry point takes a ``v`` of width Dv <= D and returns Dv columns. A
CPU tensor goes to the plain version in ``ref.py``. Any other tensor goes
to the kernel: the wrapper first refuses what the kernel does not compute
(a nonzero ``q_offset``, non-float dtypes, head widths above 256, a ``v``
wider than ``q``) and then anything not on a CUDA device. The kernel's
softcapped instances are float32 only: under a softcap ``attention_bshd``
widens bfloat16 / float16 inputs to float32 first (the kernel computes in
float32 whatever it loads). ``FLASH_FWD.launches`` counts the launches.

Block sizes (``blk_q``, ``blk_k``, ``block``) are the plain version's, as in
the JAX package; the kernel tiles by its own (128 query rows x 64 keys up to
D = 128) whatever they are. A block size changes only the order of the
float32 sums, not the function.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..build import Kernel
from . import ref as _r

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

FLASH_FWD = Kernel("flash_fwd", "flash.cu",
                   [_P, _P, _P, _P, _P, _P, _I, _I64, _I, _I, _I64, _I64, _I,
                    _I, _P, ctypes.c_float, ctypes.c_float, _I, _I64, _I64,
                    _I, _P])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_D = 256
MAX_BATCH_HEADS = 65535     # the grid's y dimension


def _check_kernel_args(q, k, v, *, q_offset=0, softcap=None) -> None:
    """Raise for what the kernel does not compute, then for a device that
    is not CUDA."""
    if softcap is not None and softcap < 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")
    if q_offset != 0:
        raise NotImplementedError(
            "the flash kernel takes q_offset 0 only (prefill); ROADMAP queue A")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32, bfloat16 or float16, "
                            f"got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not q.shape[-1] == k.shape[-1] >= v.shape[-1] or q.shape[-1] > MAX_D:
        raise ValueError(f"the flash kernel takes one head width D <= {MAX_D}"
                         f" for q and k and a width Dv <= D for v, got "
                         f"{q.shape[-1]}, {k.shape[-1]}, {v.shape[-1]}")
    if q.device.type != "cuda":
        raise ValueError(f"q must be on the CPU or a CUDA device, got "
                         f"{q.device}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must be on one device")


def _launch(q, k, v, out, m, l, *, batch, heads, kv_heads, sq, skv, strides,
            scale, causal, window, kv_len, normalize, softcap=None) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if batch * heads > MAX_BATCH_HEADS:
        raise ValueError(f"batch * heads must be <= {MAX_BATCH_HEADS}, got "
                         f"{batch * heads}")
    FLASH_FWD(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              None if m is None else m.data_ptr(),
              None if l is None else l.data_ptr(),
              _DTYPES[q.dtype], batch, heads, kv_heads, sq, skv, q.shape[-1],
              v.shape[-1], (ctypes.c_int64 * 12)(*strides), scale,
              float(softcap or 0.0), int(causal),
              0 if window is None else window, kv_len, int(normalize),
              torch.cuda.current_stream(q.device).cuda_stream)


def flash_fwd(q, k, v, *, blk_q: int = 128, blk_k: int = 128,
              causal: bool = True, scale: float = 1.0,
              window: Optional[int] = None):
    """(BH, Sq, D) x (BH, Skv, D) x (BH, Skv, Dv) -> (acc (BH, Sq, Dv), m,
    l), float32; out = acc / l."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 \
            or k.shape[:2] != v.shape[:2] or q.shape[0] != k.shape[0]:
        raise ValueError(f"q must be (BH, Sq, D), k (BH, Skv, D) and v "
                         f"(BH, Skv, Dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type == "cpu":
        return _r.flash_fwd_ref(q, k, v, blk_q=blk_q, blk_k=blk_k,
                                causal=causal, scale=scale, window=window)
    _check_kernel_args(q, k, v)
    bh, sq, _ = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    acc = torch.empty((bh, sq, dv), dtype=torch.float32, device=q.device)
    m = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    l = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    # each (BH, S, D) tensor is a batch of BH single-head sequences
    strides = [q.stride(0), q.stride(1), 0, k.stride(0), k.stride(1), 0,
               v.stride(0), v.stride(1), 0, sq * dv, dv, 0]
    _launch(q, k, v, acc, m, l, batch=bh, heads=1, kv_heads=1, sq=sq,
            skv=skv, strides=strides, scale=scale, causal=causal,
            window=window, kv_len=skv, normalize=False)
    return acc, m, l


def flash_attention(q, k, v, *, causal: bool = True, scale: float = 1.0,
                    window: Optional[int] = None, **kw):
    """q/k/v: (BH, S, D) -> (BH, Sq, D), numerically safe normalisation."""
    acc, m, l = flash_fwd(q, k, v, causal=causal, scale=scale, window=window,
                          **kw)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


flash_ref = _r.flash_ref


def attention_bshd(q, k, v, *, causal: bool, window: Optional[int],
                   softcap: Optional[float], q_offset: int, kv_len: int,
                   block: int = 1024, scale: float = 1.0) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv), Dv <= D
    -> (B, Sq, H, Dv) in q's dtype. Query head ``h`` reads KV head
    ``h // (H / Hkv)``; masks at absolute query positions ``q_offset + i``
    and keys below ``kv_len``; ``softcap`` caps each score at
    ``softcap * tanh(score / softcap)`` before the softmax.

    The kernel scales q in float32, as the Pallas kernel does; the plain
    version scales it in q's dtype, as ``blockwise_attention`` does. The two
    agree in float32, the LM's serving dtype, and differ by a rounding of q
    in bfloat16."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3] or q.shape[0] != k.shape[0] \
            or q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"q must be (B, Sq, H, D), k (B, Skv, Hkv, D) and v "
                         f"(B, Skv, Hkv, Dv) with Hkv dividing H, got "
                         f"{tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type == "cpu":
        return _r.attention_bshd_ref(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_offset=q_offset,
                                     kv_len=kv_len, block=block, scale=scale)
    _check_kernel_args(q, k, v, q_offset=q_offset, softcap=softcap)
    dtype = q.dtype
    if softcap and dtype != torch.float32:
        # the softcapped instances are float32 only; the kernel widens
        # bf16 / f16 to float32 as it loads them, so this is the same sum
        q, k, v = q.float(), k.float(), v.float()
    b, sq, h, _ = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3]]
    _launch(q, k, v, out, None, None, batch=b, heads=h, kv_heads=hkv, sq=sq,
            skv=skv, strides=strides, scale=scale, causal=causal,
            window=window, kv_len=max(0, min(kv_len, skv)), normalize=True,
            softcap=softcap)
    return out.to(dtype)
