"""Wrappers of the flash-attention kernels: the forward (``csrc/flash.cu``)
and its backward (``csrc/flash_bwd.cu``).

Three forward entry points, with the JAX package's signatures so the tests
compare like with like:

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

The gradient: ``attention_bshd`` goes through :class:`FlashAttention` (a
``torch.autograd.Function``) whenever q, k or v requires grad. Its forward
also keeps each row's log-sum-exp (``lse = m + log(l)`` from the forward
kernel's own ``m`` and ``l``) and saves q, k, v, the output and lse; its
backward is :func:`attention_bshd_bwd`: on a CUDA tensor the two kernels of
``flash_bwd.cu`` (``FLASH_BWD_DQ``, then ``FLASH_BWD_DKDV``, each counting
its launches), on a CPU tensor the plain ``attention_bshd_bwd_ref``. The
backward kernels take float32 only (the LM trains in float32) and
``q_offset`` 0; anything else raises. Without grad, ``attention_bshd``
launches the forward kernel exactly as before, with no ``m`` or ``l``.
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

# the backward's two passes share one C signature (flash_bwd.cu)
_BWD_ARGS = [_P] * 10 + [_I64, _I, _I, _I64, _I64, _I, _I, _P,
                         ctypes.c_float, ctypes.c_float, _I, _I64, _I64, _P]
FLASH_BWD_DQ = Kernel("flash_bwd_dq", "flash_bwd.cu", _BWD_ARGS)
FLASH_BWD_DKDV = Kernel("flash_bwd_dkdv", "flash_bwd.cu", _BWD_ARGS)

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


def _check_grid(batch, heads, window) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if batch * heads > MAX_BATCH_HEADS:
        raise ValueError(f"batch * heads must be <= {MAX_BATCH_HEADS}, got "
                         f"{batch * heads}")


def _launch(q, k, v, out, m, l, *, batch, heads, kv_heads, sq, skv, strides,
            scale, causal, window, kv_len, normalize, softcap=None) -> None:
    _check_grid(batch, heads, window)
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


def _check_bshd(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3] or q.shape[0] != k.shape[0] \
            or q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"q must be (B, Sq, H, D), k (B, Skv, Hkv, D) and v "
                         f"(B, Skv, Hkv, Dv) with Hkv dividing H, got "
                         f"{tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def _bshd_fwd(q, k, v, *, causal, window, softcap, q_offset, kv_len, block,
              scale, with_lse: bool):
    """The forward on q's device; with ``with_lse`` also the float32
    log-sum-exp (B * H, Sq)."""
    if q.device.type == "cpu":
        return _r.attention_bshd_ref(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_offset=q_offset,
                                     kv_len=kv_len, block=block, scale=scale,
                                     return_lse=with_lse)
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
    m = l = None
    if with_lse:
        m = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3]]
    _launch(q, k, v, out, m, l, batch=b, heads=h, kv_heads=hkv, sq=sq,
            skv=skv, strides=strides, scale=scale, causal=causal,
            window=window, kv_len=max(0, min(kv_len, skv)), normalize=True,
            softcap=softcap)
    out = out.to(dtype)
    return (out, m + torch.log(l)) if with_lse else out


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
    in bfloat16. Differentiable (:class:`FlashAttention`) when q, k or v
    requires grad."""
    _check_bshd(q, k, v)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, kv_len=kv_len, block=block, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, kw)
    return _bshd_fwd(q, k, v, **kw, with_lse=False)


class FlashAttention(torch.autograd.Function):
    """``attention_bshd`` with its gradient: the forward keeps lse, the
    backward is :func:`attention_bshd_bwd` on the tensors' device."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        if kw["q_offset"] != 0:
            raise NotImplementedError(
                "the flash backward takes q_offset 0 only (training's "
                "prefill shape)")
        out, lse = _bshd_fwd(q, k, v, **kw, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        kw = ctx.kw
        dq, dk, dv = attention_bshd_bwd(
            q, k, v, out, lse, d_out, causal=kw["causal"],
            window=kw["window"], softcap=kw["softcap"], kv_len=kw["kv_len"],
            scale=kw["scale"], block=kw["block"])
        return dq, dk, dv, None


def _check_bwd_args(*tensors) -> None:
    """Raise for what the backward kernels do not compute, then for a device
    that is not CUDA."""
    q, k, v = tensors[:3]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the flash backward kernels take float32 only, "
                            f"got {t.dtype}")
    if not q.shape[-1] == k.shape[-1] >= v.shape[-1] or q.shape[-1] > MAX_D:
        raise ValueError(f"the flash backward takes one head width D <= "
                         f"{MAX_D} for q and k and a width Dv <= D for v, "
                         f"got {q.shape[-1]}, {k.shape[-1]}, {v.shape[-1]}")
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"the flash backward runs on the CPU or one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")


def attention_bshd_bwd(q, k, v, out, lse, d_out, *, causal: bool,
                       window: Optional[int], softcap: Optional[float],
                       kv_len: int, scale: float = 1.0, block: int = 1024):
    """The gradient of ``attention_bshd`` (``q_offset`` 0): (dq, dk, dv)
    shaped as q, k and v, from the forward's ``out`` (B, Sq, H, Dv) and
    ``lse`` (B * H, Sq) and the output's gradient ``d_out``. A CPU tensor
    goes to ``attention_bshd_bwd_ref`` (KV blocks of ``block`` keys); a CUDA
    tensor to ``flash_bwd_dq`` (Delta and dq) and then ``flash_bwd_dkdv``
    (dk and dv), float32 only."""
    _check_bshd(q, k, v)
    kw = dict(causal=causal, window=window, softcap=softcap, kv_len=kv_len,
              scale=scale)
    if q.device.type == "cpu":
        return _r.attention_bshd_bwd_ref(q, k, v, out, lse, d_out, **kw,
                                         block=block)
    args, keep = bwd_launch_args(q, k, v, out, lse, d_out, **kw)
    FLASH_BWD_DQ(*args)         # writes delta, read by the second pass
    FLASH_BWD_DKDV(*args)
    return keep[:3]


def bwd_launch_args(q, k, v, out, lse, d_out, *, causal: bool,
                    window: Optional[int], softcap: Optional[float],
                    kv_len: int, scale: float = 1.0):
    """The C arguments that ``flash_bwd_dq`` and then ``flash_bwd_dkdv``
    take for ``attention_bshd_bwd``'s CUDA route, after its checks, and the
    tensors they point into: (dq, dk, dv, delta, the inputs), which the
    caller keeps alive while the kernels may run."""
    if softcap is not None and softcap < 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")
    _check_bwd_args(q, k, v, out, lse, d_out)
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    _check_grid(b, h, window)
    if out.shape != (b, sq, h, dv) or d_out.shape != out.shape \
            or lse.shape != (b * h, sq):
        raise ValueError(f"out and d_out must be {(b, sq, h, dv)} and lse "
                         f"{(b * h, sq)}, got {tuple(out.shape)}, "
                         f"{tuple(d_out.shape)}, {tuple(lse.shape)}")
    q, k, v, out, d_out = (t if t.stride(-1) == 1 else t.contiguous()
                           for t in (q, k, v, out, d_out))
    lse = lse.contiguous()
    dq, dk, dvv = (torch.empty(t.shape, dtype=torch.float32, device=q.device)
                   for t in (q, k, v))
    delta = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    strides = [x for t in (q, k, v, out, d_out, dq, dk, dvv)
               for x in t.stride()[:3]]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), b, h, hkv, sq, skv,
            d, dv, (ctypes.c_int64 * 24)(*strides), scale,
            float(softcap or 0.0), int(causal),
            0 if window is None else window, max(0, min(kv_len, skv)),
            torch.cuda.current_stream(q.device).cuda_stream)
    return args, (dq, dk, dvv, delta, q, k, v, out, lse, d_out)
