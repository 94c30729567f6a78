"""Error-feedback quantized weight-gradient all-reduce (EF21), as
``repro.train.compression`` computes it.

    c_t   = Q_b(g_t - m_t + e_t)          compress with memory
    e_t+1 = (g_t - m_t + e_t) - DQ(c_t)   local error feedback
    m_t+1 = m_t + mean(DQ(c_t))           shared gradient estimate

Off by default; an ``EpochDecision`` with ``ef_bits`` set routes the reduced
weight gradient through :func:`ef_allreduce` inside the step. Both
compressors are deterministic: 1 bit is scaled sign (1-bit Adam's), wider is
round-to-nearest affine quantization through the Low-bit Module (the quantize
and dequantize kernels on CUDA). On the simulated stack the wire is the
identity (the reduced gradient is already global).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import quantization as qlib
from .optimizer import tree_leaves, tree_map


@dataclasses.dataclass
class EFState:
    error: dict      # per-leaf local residual
    estimate: dict   # per-leaf shared gradient estimate

    @staticmethod
    def zeros_like(params) -> "EFState":
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return EFState(error=z, estimate=tree_map(torch.zeros_like, z))


def _compress(innov: torch.Tensor, bits: int) -> torch.Tensor:
    """DQ(Q_b(innov)), one row per leading index (a vector is one row)."""
    flat = innov.reshape(-1, innov.shape[-1]) if innov.dim() > 1 \
        else innov.reshape(1, -1)
    if bits == 1:
        scale = torch.mean(torch.abs(flat), dim=-1, keepdim=True)
        return (torch.sign(flat) * scale).reshape(innov.shape)
    qt = qlib.quantize(flat, bits, stochastic=False)
    return qlib.dequantize(qt).reshape(innov.shape)


def ef_allreduce(grads, state: EFState, bits: int = 1):
    """-> (mean-gradient estimate tree, new EFState)."""
    innov = tree_map(lambda g, e, m: g.to(torch.float32) - m + e, grads,
                     state.error, state.estimate)
    deq = tree_map(lambda x: _compress(x, bits), innov)
    est = tree_map(torch.add, state.estimate, deq)
    return est, EFState(error=tree_map(torch.sub, innov, deq), estimate=est)


def ef_wire_bytes(params, bits: int) -> tuple[int, int]:
    """(payload, error-compensation) bytes one compressed all-reduce moves."""
    payload = ec = 0
    for p in tree_leaves(params):
        rows = int(p.numel() // p.shape[-1]) if p.dim() > 1 else 1
        d = int(p.shape[-1]) if p.dim() > 1 else int(p.numel())
        pb, eb = qlib.comm_bytes(rows, d, bits)
        payload += pb
        ec += eb
    return payload, ec
