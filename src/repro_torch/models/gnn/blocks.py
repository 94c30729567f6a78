"""GraphBlock: the device-side partitioned graph + message-passing primitives.

The partition-local edge lists address the concatenated ``[local ; halo]``
feature table (``halo_table``). Two ways to aggregate over them:

* ``gather_src`` + ``agg_sum`` — gather a message per edge, then sum onto the
  destinations (``index_add_``): the plain form of the JAX package's
  ``segment_sum`` aggregation;
* :func:`aggregate` — the same weighted sum as one CSR SpMM over the whole
  stack (``repro_torch.kernels.spmm``): rows ``P * n_local``, table
  ``P * (n_local + halo_rows)``, columns of partition ``p`` offset by
  ``p * (n_local + halo_rows)``. GCN aggregates this way. It is
  differentiable: the gradient of the table is the same kernel over the
  transposed CSR, ``grad_table = Aᵀ · grad_out`` (edge weights are constants
  and get none). Both CSRs, each with its own split plan (the transposed
  matrix's hub columns become split hub rows), are built once, on the host,
  in :func:`build_block`, so the sums' order — and their bits — are fixed by
  the graph in both directions, with no atomics;
* :func:`agg_mean` — GraphSAGE's mean: the same SpMM over unit-weight views
  of both CSRs (their ``row_ptr``, ``col`` and plans shared, ``w`` ones),
  divided by ``max(deg, 1)``; the in-degrees come from the CSR's ``row_ptr``
  on the host;
* :func:`gat_aggregate` — GAT's attention-weighted sum per head: the edge
  softmax (``kernels.gat``) and the per-head SpMM forward; the per-head SpMM
  over the transposed CSR, an SDDMM and the softmax's backward in the
  backward pass. ``perm_t`` (transposed edge -> forward edge, built with
  ``csr_t``) is the index through which the kernels over the transposed CSR
  read per-edge values kept in forward order (alpha, the scores' gradient):
  no transposed copy of them is gathered.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ...core.exchange import PlanArrays
from ...graph.partition import PartitionedGraph
from ...kernels.gat import ops as gat
from ...kernels.spmm.ops import spmm, spmm_heads
from ...kernels.spmm.ref import CSR, csr_from_edges


@dataclasses.dataclass(frozen=True)
class GraphBlock:
    """Static per-partition graph data (stacked leading axis P; one
    partition's, leading axis 1, under a sharded runtime)."""

    edges: torch.Tensor                   # (P, E, 2) int64 [src_ext, dst_local]
    edge_mask: torch.Tensor               # (P, E) bool
    node_mask: torch.Tensor               # (P, n_local) bool
    plan: PlanArrays
    edge_weight: Optional[torch.Tensor] = None   # (P, E) GCN-normalized weights
    csr: Optional[CSR] = None             # CSR of the whole stack (edge weights)
    n_local: int = 0
    csr_t: Optional[CSR] = None           # its transpose (the backward)
    deg: Optional[torch.Tensor] = None    # (P, n_local) float32 in-degrees
    perm_t: Optional[torch.Tensor] = None  # (nnz,) int32 csr_t edge -> csr edge

    @property
    def n_parts(self) -> int:
        """Partitions stacked here (P, or 1 under a sharded runtime)."""
        return int(self.node_mask.shape[0])

    @functools.cached_property
    def csr_unit(self) -> CSR:
        """``csr`` with unit weights (its structure and plan shared)."""
        return dataclasses.replace(self.csr, w=torch.ones_like(self.csr.w))

    @functools.cached_property
    def csr_t_unit(self) -> CSR:
        return dataclasses.replace(self.csr_t,
                                   w=torch.ones_like(self.csr_t.w))


def _stack_edges(pg: PartitionedGraph, rows: slice = slice(None)):
    """Every stacked partition's real edges flattened over the stack
    (``rows`` picks the partitions: all, or one rank's): destination
    ``p*n_local + dst``, source ``p*n_ext + src_ext`` with ``n_ext = n_local +
    halo_rows``, in edge-list order; their weights (ones when the graph has
    none) and the stack's (rows, table rows)."""
    plan = pg.plan
    n_ext = plan.n_local + plan.halo_rows
    edges, edge_mask = pg.edges[rows], pg.edge_mask[rows]
    p_idx, e_idx = np.nonzero(edge_mask)
    src = edges[p_idx, e_idx, 0].astype(np.int64) + p_idx * n_ext
    dst = edges[p_idx, e_idx, 1].astype(np.int64) + p_idx * plan.n_local
    w = np.ones(src.size, np.float32) if pg.edge_weight is None \
        else pg.edge_weight[rows][p_idx, e_idx]
    n = edge_mask.shape[0]
    return src, dst, w, (n * plan.n_local, n * n_ext)


def transpose_perm(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(nnz,) int32: for each edge position of the transposed CSR (edges
    sorted by source, stably) its position in the forward CSR (sorted by
    destination, stably) — :func:`csr_from_edges`' two orders."""
    fwd_pos = np.empty(src.size, np.int64)
    fwd_pos[np.argsort(dst, kind="stable")] = np.arange(src.size)
    return fwd_pos[np.argsort(src, kind="stable")].astype(np.int32)


def build_block(pg: PartitionedGraph, device=None,
                part: Optional[int] = None) -> GraphBlock:
    """The block of the whole stack, or (``part``, a sharded runtime's rank)
    of that one partition: its edges, masks, plan row and CSRs, built on the
    host."""
    rows = slice(None) if part is None else slice(part, part + 1)
    src, dst, w, shape = _stack_edges(pg, rows)
    csr = csr_from_edges(src, dst, w, *shape)
    deg = np.diff(csr.row_ptr.numpy()).reshape(-1, pg.plan.n_local)
    return GraphBlock(
        edges=torch.as_tensor(pg.edges[rows], dtype=torch.int64,
                              device=device),
        edge_mask=torch.as_tensor(pg.edge_mask[rows], device=device),
        node_mask=torch.as_tensor(pg.node_mask[rows], device=device),
        plan=PlanArrays.from_plan(pg.plan, device, part),
        edge_weight=None if pg.edge_weight is None
        else torch.as_tensor(pg.edge_weight[rows], device=device),
        csr=csr.to(device), n_local=pg.plan.n_local,
        csr_t=csr_from_edges(dst, src, w, shape[1], shape[0]).to(device),
        deg=torch.as_tensor(deg.astype(np.float32), device=device),
        perm_t=torch.as_tensor(transpose_perm(src, dst), device=device))


# --- message-passing primitives -------------------------------------------------
def halo_table(h: torch.Tensor, halo: torch.Tensor) -> torch.Tensor:
    """[local ; halo] feature table addressed by extended src indices."""
    return torch.cat([h, halo], dim=1)


def gather_src(block: GraphBlock, table: torch.Tensor) -> torch.Tensor:
    """(P, n_ext, d) -> (P, E, d): the source row of every edge."""
    idx = block.edges[..., 0:1].expand(-1, -1, table.shape[-1])
    return torch.gather(table, 1, idx)


def gather_dst(block: GraphBlock, h: torch.Tensor) -> torch.Tensor:
    """(P, n_local, d) -> (P, E, d): the destination row of every edge."""
    idx = block.edges[..., 1:2].expand(-1, -1, h.shape[-1])
    return torch.gather(h, 1, idx)


def _flat_dst(block: GraphBlock) -> torch.Tensor:
    offs = torch.arange(block.n_parts, device=block.edges.device)[:, None]
    return (block.edges[..., 1] + offs * block.n_local).reshape(-1)


def agg_sum(block: GraphBlock, msgs: torch.Tensor) -> torch.Tensor:
    """(P, E, d) per-edge messages -> (P, n_local, d) sums onto destinations
    (masked edges add nothing)."""
    msgs = torch.where(block.edge_mask[..., None], msgs, 0.0)
    p, d = msgs.shape[0], msgs.shape[-1]
    out = torch.zeros((p * block.n_local, d), dtype=msgs.dtype,
                      device=msgs.device)
    out.index_add_(0, _flat_dst(block), msgs.reshape(-1, d))
    return out.reshape(p, block.n_local, d)


def degrees(block: GraphBlock) -> torch.Tensor:
    """(P, n_local) in-degree over real edges (counted on the host from the
    CSR's ``row_ptr`` when the block was built)."""
    return block.deg


class _Aggregate(torch.autograd.Function):
    """``spmm(table, csr)`` forward, ``spmm(grad_out, csr_t)`` backward."""

    @staticmethod
    def forward(ctx, table, csr: CSR, csr_t: CSR):
        ctx.csr_t = csr_t
        return spmm(table, csr)

    @staticmethod
    def backward(ctx, grad_out):
        return spmm(grad_out.contiguous(), ctx.csr_t), None, None


def _spmm_stack(block: GraphBlock, table: torch.Tensor, csr: CSR,
                csr_t: CSR) -> torch.Tensor:
    p, n_ext, d = table.shape
    out = _Aggregate.apply(table.reshape(p * n_ext, d), csr, csr_t)
    return out.reshape(p, block.n_local, d)


def aggregate(block: GraphBlock, table: torch.Tensor) -> torch.Tensor:
    """(P, n_ext, d) table -> (P, n_local, d) weighted neighbor sums: the same
    value as ``agg_sum(block, gather_src(block, table) * edge_weight)``, as
    one SpMM launch over the stack, and one more over the transposed CSR in
    the backward pass when the table needs a gradient."""
    if block.edge_weight is None:
        raise ValueError("the block has no edge weights to aggregate with")
    return _spmm_stack(block, table, block.csr, block.csr_t)


def agg_mean(block: GraphBlock, table: torch.Tensor) -> torch.Tensor:
    """(P, n_ext, d) table -> (P, n_local, d) mean over each node's
    in-neighbours (0 where it has none): the JAX package's ``agg_mean(block,
    gather_src(block, table))``, as the unit-weight SpMM over the stack
    divided by ``max(deg, 1)``."""
    s = _spmm_stack(block, table, block.csr_unit, block.csr_t_unit)
    return s / torch.clamp(block.deg, min=1.0)[..., None]


class _GatAggregate(torch.autograd.Function):
    """Forward: ``alpha = gat.softmax(s_src, s_dst, csr)``, ``out =
    spmm_heads(table, csr, alpha)``. Backward, from ``g = d out``:
    ``d table = spmm_heads(g, csr_t, alpha, w_idx=perm_t)`` (the kernel
    reads alpha through ``perm_t``; nothing gathers ``alpha[perm_t]``);
    ``dalpha = sddmm_heads(g, table)``; ``dx, d s_dst =
    gat.softmax_bwd(alpha, dalpha, ...)``; ``d s_src = gat.row_sums_t(dx,
    csr_t, perm_t)``."""

    @staticmethod
    def forward(ctx, table, s_src, s_dst, block: GraphBlock):
        alpha = gat.softmax(s_src, s_dst, block.csr)
        ctx.block = block
        ctx.save_for_backward(table, s_src, s_dst, alpha)
        return spmm_heads(table, block.csr, alpha)

    @staticmethod
    def backward(ctx, g):
        table, s_src, s_dst, alpha = ctx.saved_tensors
        blk, g = ctx.block, g.contiguous()
        d_table = d_src = d_dst = None
        if ctx.needs_input_grad[0]:
            d_table = spmm_heads(g, blk.csr_t, alpha, w_idx=blk.perm_t)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dalpha = gat.sddmm_heads(g, table, blk.csr, alpha.shape[1])
            dx, d_dst = gat.softmax_bwd(alpha, dalpha, s_src, s_dst, blk.csr)
            d_src = gat.row_sums_t(dx, blk.csr_t, blk.perm_t)
        return d_table, d_src, d_dst, None


def gat_aggregate(block: GraphBlock, table: torch.Tensor, s_src: torch.Tensor,
                  s_dst: torch.Tensor) -> torch.Tensor:
    """GAT's aggregation over the stack: ``table`` (P, n_ext, H*dh),
    ``s_src`` (P, n_ext, H), ``s_dst`` (P, n_local, H) -> (P, n_local, H*dh)
    with ``out[r, h, :] = sum_e alpha[e, h] table[col_e, h, :]`` and ``alpha
    = edge_softmax(leaky_relu(s_src[col] + s_dst[r], 0.2))`` over each row's
    real edges (0 for a row without any). Differentiable in all three."""
    p, n_ext, d = table.shape
    n_heads = s_src.shape[-1]
    out = _GatAggregate.apply(
        table.reshape(p * n_ext, d).contiguous(),
        s_src.reshape(p * n_ext, n_heads).contiguous(),
        s_dst.reshape(p * block.n_local, n_heads).contiguous(), block)
    return out.reshape(p, block.n_local, d)
