"""Wrappers of GAT's CSR kernels (``csrc/gat.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel on the current stream or raises. ``GAT_SOFTMAX``,
``GAT_SOFTMAX_BWD`` and ``SDDMM_HEADS`` count their launches (one each per
call; ``gat_softmax_bwd`` serves :func:`softmax_bwd` in mode 0 and
:func:`row_sums_t` in mode 1). One call of the softmax or its backward runs
up to three CUDA kernels, its phases: every unit of the plan, then the
segments of the CSR's long rows, then their combination.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import Kernel
from ..spmm.ref import CSR, SEGMENT
from . import ref as _r

_P, _I = ctypes.c_void_p, ctypes.c_int

GAT_SOFTMAX = Kernel("gat_softmax", "gat.cu",
                     [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _I,
                      _I, _P])
GAT_SOFTMAX_BWD = Kernel("gat_softmax_bwd", "gat.cu",
                         [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                          _I, _I, _I, _P, _P, _P, _I, _I, _P])
SDDMM_HEADS = Kernel("sddmm_heads", "gat.cu",
                     [_P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _P])
# the head counts the CUDA kernels are built for
CUDA_HEADS = (1, 2, 4, 8)
# the widest rows (H * dh) the CUDA SDDMM stages: one warp's row of g and two
# batches of slices must fit a block's shared memory
SDDMM_MAX_WIDTH = 53_000


def _on_cuda(ref: torch.Tensor, csr: CSR, n_heads: int, floats=(),
             ints=()) -> bool:
    """True for CUDA inputs (checked: contiguous float32 ``floats``, int32
    ``ints`` and plan, all on ``ref``'s device), False for CPU ones; raises
    for any other device."""
    if ref.device.type == "cpu":
        return False
    if ref.device.type != "cuda":
        raise ValueError(f"inputs must be on the CPU or a CUDA device, got "
                         f"{ref.device}")
    if n_heads not in CUDA_HEADS:
        raise ValueError(f"the CUDA kernels take {CUDA_HEADS} heads, got "
                         f"{n_heads}")
    plan = (csr.row_ptr, csr.col, csr.units, csr.long_rows, csr.long_ptr)
    for ts, want in ((floats, torch.float32), (plan + tuple(ints),
                                               torch.int32)):
        for t in ts:
            if t.device != ref.device or t.dtype != want \
                    or not t.is_contiguous():
                raise ValueError(f"inputs must be contiguous {want} on "
                                 f"{ref.device}, got {t.dtype} on "
                                 f"{t.device}")
    return True


def _plan(csr: CSR) -> tuple:
    return (csr.row_ptr.data_ptr(), csr.col.data_ptr(), csr.units.data_ptr(),
            csr.units.shape[0], csr.long_rows.data_ptr(),
            csr.long_ptr.data_ptr(), csr.long_rows.shape[0], SEGMENT,
            csr.n_partials)


def _partials(csr: CSR, n_heads: int, device) -> torch.Tensor:
    """The row kernels' workspace: two sets of a partial per segment."""
    return torch.empty((2 * csr.n_partials, n_heads), dtype=torch.float32,
                       device=device)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_heads(name: str, t: torch.Tensor, rows: int, n_heads: int):
    if t.dim() != 2 or t.shape != (rows, n_heads):
        raise ValueError(f"{name} must be ({rows}, {n_heads}), got "
                         f"{tuple(t.shape)}")


def softmax(s_src: torch.Tensor, s_dst: torch.Tensor, csr: CSR
            ) -> torch.Tensor:
    """Edge softmax of ``leaky_relu(s_src[col] + s_dst[row], 0.2)`` over each
    row's edges: (n_src, H), (n_rows, H) float32 -> alpha (nnz, H) in CSR
    order."""
    n_heads = s_dst.shape[-1]
    _check_heads("s_src", s_src, csr.n_cols, n_heads)
    _check_heads("s_dst", s_dst, csr.n_rows, n_heads)
    if not _on_cuda(s_src, csr, n_heads, (s_src, s_dst)):
        return _r.gat_softmax_ref(s_src, s_dst, csr)
    alpha = torch.empty((csr.nnz, n_heads), dtype=torch.float32,
                        device=s_src.device)
    part = _partials(csr, n_heads, s_src.device)
    GAT_SOFTMAX(s_src.data_ptr(), s_dst.data_ptr(), *_plan(csr),
                part.data_ptr(), alpha.data_ptr(), csr.n_rows, n_heads,
                _stream(s_src))
    return alpha


def softmax_bwd(alpha: torch.Tensor, dalpha: torch.Tensor,
                s_src: torch.Tensor, s_dst: torch.Tensor, csr: CSR
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The edge softmax's backward over the forward CSR: -> (dx (nnz, H),
    the gradient of the scores' pre-activation; d s_dst (n_rows, H), its
    row sums)."""
    n_heads = s_dst.shape[-1]
    for name, t, rows in (("alpha", alpha, csr.nnz),
                          ("dalpha", dalpha, csr.nnz),
                          ("s_src", s_src, csr.n_cols),
                          ("s_dst", s_dst, csr.n_rows)):
        _check_heads(name, t, rows, n_heads)
    if not _on_cuda(alpha, csr, n_heads,
                    (alpha, dalpha, s_src, s_dst)):
        return _r.gat_softmax_bwd_ref(alpha, dalpha, s_src, s_dst, csr)
    dev = alpha.device
    dx = torch.empty_like(alpha)
    ds_dst = torch.empty((csr.n_rows, n_heads), dtype=torch.float32,
                         device=dev)
    part = _partials(csr, n_heads, dev)
    GAT_SOFTMAX_BWD(0, alpha.data_ptr(), dalpha.data_ptr(), s_src.data_ptr(),
                    s_dst.data_ptr(), None, None, *_plan(csr),
                    part.data_ptr(), dx.data_ptr(), ds_dst.data_ptr(),
                    csr.n_rows, n_heads, _stream(alpha))
    return dx, ds_dst


def row_sums_t(dx: torch.Tensor, csr_t: CSR,
               perm_t: torch.Tensor) -> torch.Tensor:
    """Row sums over the transposed CSR of per-edge values given in forward
    edge order: ``out[c] = sum_e' dx[perm_t[e']]`` (``d s_src``). ``perm_t``
    is (nnz,) int32: transposed edge -> forward edge."""
    n_heads = dx.shape[-1]
    _check_heads("dx", dx, csr_t.nnz, n_heads)
    if perm_t.shape != (csr_t.nnz,):
        raise ValueError(f"perm_t must be ({csr_t.nnz},), got "
                         f"{tuple(perm_t.shape)}")
    if not _on_cuda(dx, csr_t, n_heads, (dx,), (perm_t,)):
        return _r.row_sums_t_ref(dx, csr_t, perm_t)
    out = torch.empty((csr_t.n_rows, n_heads), dtype=torch.float32,
                      device=dx.device)
    part = _partials(csr_t, n_heads, dx.device)
    GAT_SOFTMAX_BWD(1, None, None, None, None, dx.data_ptr(),
                    perm_t.data_ptr(), *_plan(csr_t), part.data_ptr(), None,
                    out.data_ptr(), csr_t.n_rows, n_heads, _stream(dx))
    return out


def sddmm_heads(g: torch.Tensor, table: torch.Tensor, csr: CSR,
                n_heads: int) -> torch.Tensor:
    """``out[e, h] = sum_{k < dh} g[row_e, h*dh + k] * table[col_e, h*dh +
    k]`` in ``k`` order: g (n_rows, H*dh), table (n_src, H*dh) float32 ->
    (nnz, H)."""
    d = g.shape[-1]
    if g.dim() != 2 or g.shape[0] != csr.n_rows or d % n_heads \
            or table.shape != (csr.n_cols, d):
        raise ValueError(f"g must be ({csr.n_rows}, H*dh) and table "
                         f"({csr.n_cols}, H*dh), got {tuple(g.shape)}, "
                         f"{tuple(table.shape)} for {n_heads} heads")
    if not _on_cuda(g, csr, n_heads, (g, table)):
        return _r.sddmm_heads_ref(g, table, csr, n_heads)
    if d > SDDMM_MAX_WIDTH:
        raise ValueError(f"the CUDA SDDMM takes rows of at most "
                         f"{SDDMM_MAX_WIDTH} floats, got {d}")
    out = torch.empty((csr.nnz, n_heads), dtype=torch.float32,
                      device=g.device)
    SDDMM_HEADS(g.data_ptr(), table.data_ptr(), csr.col.data_ptr(),
                csr.units.data_ptr(), csr.units.shape[0],
                csr.long_rows.data_ptr(), csr.long_ptr.data_ptr(),
                csr.long_rows.shape[0], out.data_ptr(), csr.n_rows, n_heads,
                d // n_heads, _stream(g))
    return out
