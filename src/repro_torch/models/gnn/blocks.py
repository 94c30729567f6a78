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
  the graph in both directions, with no atomics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...core.exchange import PlanArrays
from ...graph.partition import PartitionedGraph
from ...kernels.spmm.ops import spmm
from ...kernels.spmm.ref import CSR, csr_from_edges


@dataclasses.dataclass(frozen=True)
class GraphBlock:
    """Static per-partition graph data (stacked leading axis P)."""

    edges: torch.Tensor                   # (P, E, 2) int64 [src_ext, dst_local]
    edge_mask: torch.Tensor               # (P, E) bool
    node_mask: torch.Tensor               # (P, n_local) bool
    plan: PlanArrays
    edge_weight: Optional[torch.Tensor] = None   # (P, E) GCN-normalized weights
    csr: Optional[CSR] = None             # weighted CSR of the whole stack
    n_local: int = 0
    csr_t: Optional[CSR] = None           # its transpose (the backward)

    @property
    def n_parts(self) -> int:
        return self.plan.n_parts


def stack_csr(pg: PartitionedGraph, transpose: bool = False) -> CSR:
    """The weighted CSR of every partition's real edges, flattened over the
    stack: destination ``p*n_local + dst``, source ``p*n_ext + src_ext`` with
    ``n_ext = n_local + halo_rows``. Each row keeps its edge-list order.
    ``transpose`` swaps the two: a row per table row, gathering from the
    destinations it feeds, in edge-list order."""
    plan = pg.plan
    n_ext = plan.n_local + plan.halo_rows
    p_idx, e_idx = np.nonzero(pg.edge_mask)
    src = pg.edges[p_idx, e_idx, 0].astype(np.int64) + p_idx * n_ext
    dst = pg.edges[p_idx, e_idx, 1].astype(np.int64) + p_idx * plan.n_local
    shape = (plan.n_parts * plan.n_local, plan.n_parts * n_ext)
    w = pg.edge_weight[p_idx, e_idx]
    if transpose:
        return csr_from_edges(dst, src, w, shape[1], shape[0])
    return csr_from_edges(src, dst, w, *shape)


def build_block(pg: PartitionedGraph, device=None) -> GraphBlock:
    weighted = pg.edge_weight is not None
    return GraphBlock(
        edges=torch.as_tensor(pg.edges, dtype=torch.int64, device=device),
        edge_mask=torch.as_tensor(pg.edge_mask, device=device),
        node_mask=torch.as_tensor(pg.node_mask, device=device),
        plan=PlanArrays.from_plan(pg.plan, device),
        edge_weight=torch.as_tensor(pg.edge_weight, device=device)
        if weighted else None,
        csr=stack_csr(pg).to(device) if weighted else None,
        n_local=pg.plan.n_local,
        csr_t=stack_csr(pg, transpose=True).to(device) if weighted else None)


# --- message-passing primitives -------------------------------------------------
def halo_table(h: torch.Tensor, halo: torch.Tensor) -> torch.Tensor:
    """[local ; halo] feature table addressed by extended src indices."""
    return torch.cat([h, halo], dim=1)


def gather_src(block: GraphBlock, table: torch.Tensor) -> torch.Tensor:
    """(P, n_ext, d) -> (P, E, d): the source row of every edge."""
    idx = block.edges[..., 0:1].expand(-1, -1, table.shape[-1])
    return torch.gather(table, 1, idx)


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
    """(P, n_local) in-degree over real edges."""
    ones = block.edge_mask.to(torch.float32).reshape(-1)
    out = torch.zeros(block.n_parts * block.n_local, dtype=torch.float32,
                      device=ones.device)
    out.index_add_(0, _flat_dst(block), ones)
    return out.reshape(block.n_parts, block.n_local)


class _Aggregate(torch.autograd.Function):
    """``spmm(table, csr)`` forward, ``spmm(grad_out, csr_t)`` backward."""

    @staticmethod
    def forward(ctx, table, csr: CSR, csr_t: CSR):
        ctx.csr_t = csr_t
        return spmm(table, csr)

    @staticmethod
    def backward(ctx, grad_out):
        return spmm(grad_out.contiguous(), ctx.csr_t), None, None


def aggregate(block: GraphBlock, table: torch.Tensor) -> torch.Tensor:
    """(P, n_ext, d) table -> (P, n_local, d) weighted neighbor sums: the same
    value as ``agg_sum(block, gather_src(block, table) * edge_weight)``, as
    one SpMM launch over the stack, and one more over the transposed CSR in
    the backward pass when the table needs a gradient."""
    if block.csr is None:
        raise ValueError("the block has no edge weights to aggregate with")
    p, n_ext, d = table.shape
    out = _Aggregate.apply(table.reshape(p * n_ext, d), block.csr, block.csr_t)
    return out.reshape(p, block.n_local, d)
