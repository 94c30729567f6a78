"""GraphBlock: the device-side partitioned graph + message-passing primitives.

The partition-local edge lists address the concatenated ``[local ; halo]``
feature table (``halo_table``). Everything is a sum, a max or a gather in
an order fixed by the graph on the host, with no atomics (``ROADMAP.md``
§C, "No atomics on the path"). Two CSRs index the table, two the edges:

* ``csr`` (rows ``P * n_local``, the destinations of the stack; columns
  ``P * n_ext`` table rows, ``n_ext = n_local + halo_rows``, those of
  partition ``p`` offset by ``p * n_ext``; the edge weights) and its
  transpose ``csr_t``, each with its own split plan (the transposed
  matrix's hub columns become split hub rows); ``perm_t`` maps a
  transposed edge to its forward one;
* ``ecsr`` (the same rows, row order and within-row order as ``csr``;
  columns the flat edge ids ``p * e_pad + e`` of the ``(P * e_pad, d)``
  per-edge messages; weights ones; ``csr``'s plan) and ``ecsr_t`` (the
  table rows grouped by source in the order of ``csr_t``, its columns
  ``ecsr.col[perm_t]``; ``csr_t``'s plan), built at first use from the
  block's edges. A padded edge is in neither.

The primitives over them:

* :func:`aggregate` — the weighted neighbour sum as one SpMM over ``csr``
  (``repro_torch.kernels.spmm``), its table gradient the same kernel over
  ``csr_t`` (GCN);
* :func:`agg_mean` — GraphSAGE's mean of table rows: the SpMM over
  unit-weight views of both CSRs divided by ``max(deg, 1)`` (the in-degrees
  from ``row_ptr`` on the host);
* :func:`gather_src` / :func:`gather_dst` — a message per edge from the
  table or the destinations' rows; their gradients are the SpMM over
  ``ecsr_t`` / ``ecsr`` (an edge's weight of 1.0 multiplies exactly);
* :func:`agg_sum` — per-edge messages summed onto their destinations, the
  SpMM over ``ecsr``; its gradient a plain gather ``g[dst]`` (0 on padded
  edges). :func:`agg_mean_msgs` and :func:`agg_std` (PNA) build on it;
* :func:`agg_max_min` — the per-column maximum and minimum of each
  destination's messages in one pass of ``kernels.seg`` over ``ecsr``,
  which also counts the edges that reach each; the gradient, a second
  kernel, splits ``g`` evenly among them, as ``jax.ops.segment_max``'s does;
  :func:`agg_max` / :func:`agg_min` are its halves;
* :func:`gat_aggregate` — GAT's attention-weighted sum per head: the edge
  softmax (``kernels.gat``) and the per-head SpMM forward; the per-head SpMM
  over ``csr_t`` (alpha read through ``perm_t``, no transposed copy
  gathered), an SDDMM and the softmax's backward in the backward pass.

Tracing (``repro_torch.obs``): :func:`aggregate` and :func:`agg_mean`, and
their backward, are ``agg`` spans timed on the device (args ``dir``,
``"fwd"`` | ``"bwd"``, and ``width``, the table's).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ... import obs
from ...core.exchange import PlanArrays
from ...graph.partition import PartitionedGraph
from ...kernels.gat import ops as gat
from ...kernels.seg.ops import seg_max_min, seg_max_min_bwd
from ...kernels.spmm.ops import spmm, spmm_heads
from ...kernels.spmm.ref import CSR, csr_from_edges
from . import so3


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
    edge_attr: Optional[torch.Tensor] = None  # (P, E, d_e) [dist|unit|sh...]

    @property
    def n_parts(self) -> int:
        """Partitions stacked here (P, or 1 under a sharded runtime)."""
        return int(self.node_mask.shape[0])

    def _flat(self, col: int, rows_per_part: int) -> torch.Tensor:
        offs = torch.arange(self.n_parts, device=self.edges.device)[:, None]
        return (self.edges[..., col] + offs * rows_per_part).reshape(-1)

    @functools.cached_property
    def src_flat(self) -> torch.Tensor:
        """(P * E,) int64: every edge's row of the flattened table."""
        return self._flat(0, self.csr.n_cols // self.n_parts)

    @functools.cached_property
    def dst_flat(self) -> torch.Tensor:
        """(P * E,) int64: every edge's row of the flattened destinations."""
        return self._flat(1, self.n_local)

    @functools.cached_property
    def ecsr(self) -> CSR:
        """``csr``'s rows, order and plan (its tensors shared) over the
        ``(P * E, d)`` per-edge messages: column ``k`` the flat edge id ``p *
        E + e`` of ``csr``'s ``k``-th edge, weights ones. Built at first use
        (only the zoo's models use it), from the block's own edges: the real
        ones in ``(p, e)`` order sorted stably by destination, the order
        :func:`csr_from_edges` gave ``csr``."""
        real = torch.nonzero(self.edge_mask.reshape(-1)).squeeze(1)
        order = torch.sort(self.dst_flat[real], stable=True).indices
        col = real[order].to(torch.int32)
        return dataclasses.replace(
            self.csr, col=col, n_cols=self.edge_mask.numel(),
            w=torch.ones(col.shape, dtype=torch.float32, device=col.device))

    @functools.cached_property
    def epad(self) -> torch.Tensor:
        """(n_pad,) int32: the flat ids of the padded edges, the message
        rows that ``ecsr`` names no edge of."""
        return torch.nonzero(~self.edge_mask.reshape(-1)).squeeze(1).to(
            torch.int32)

    @functools.cached_property
    def ecsr_t(self) -> CSR:
        """``csr_t``'s rows, order and plan over the messages: the table
        rows grouped by source, columns ``ecsr.col[perm_t]``."""
        ecsr = self.ecsr
        return dataclasses.replace(self.csr_t,
                                   col=ecsr.col[self.perm_t.long()],
                                   w=ecsr.w, n_cols=ecsr.n_cols)

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


def geometry_edge_attr(g, l_max: int = 2) -> np.ndarray:
    """Per-edge ``[dist, unit(3), sh((l_max+1)^2)]`` computed on the *global*
    graph (host-side, before partitioning: halo positions never move at
    runtime)."""
    src, dst = g.edge_index
    vec = g.pos[src] - g.pos[dst]
    dist = np.linalg.norm(vec, axis=-1, keepdims=True)
    unit = vec / np.maximum(dist, 1e-9)
    sh = so3.real_sh_np(unit, l_max)
    return np.concatenate([dist, unit, sh], axis=-1).astype(np.float32)


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
        perm_t=torch.as_tensor(transpose_perm(src, dst), device=device),
        edge_attr=None if pg.edge_attr is None
        else torch.as_tensor(pg.edge_attr[rows], device=device))


# --- message-passing primitives -------------------------------------------------
def halo_table(h: torch.Tensor, halo: torch.Tensor) -> torch.Tensor:
    """[local ; halo] feature table addressed by extended src indices."""
    return torch.cat([h, halo], dim=1)


class _Gather(torch.autograd.Function):
    """``rows[idx]`` forward; backward ``spmm(g, csr)`` over the edge CSR
    whose rows are ``rows`` (``ecsr_t`` for the table, ``ecsr`` for the
    destinations): each row sums its real edges' gradients in CSR order.
    A padded edge's message feeds no aggregation, so its gradient is 0 and
    it is left out."""

    @staticmethod
    def forward(ctx, rows, idx, csr: CSR):
        ctx.csr = csr
        return rows.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        return spmm(g.contiguous(), ctx.csr), None, None


def _gather(rows: torch.Tensor, idx: torch.Tensor, csr: CSR, p: int
            ) -> torch.Tensor:
    d = rows.shape[-1]
    out = _Gather.apply(rows.reshape(-1, d), idx, csr)
    return out.reshape(p, -1, d)


def gather_src(block: GraphBlock, table: torch.Tensor) -> torch.Tensor:
    """(P, n_ext, d) -> (P, E, d): the source row of every edge."""
    return _gather(table, block.src_flat, block.ecsr_t, block.n_parts)


def gather_dst(block: GraphBlock, h: torch.Tensor) -> torch.Tensor:
    """(P, n_local, d) -> (P, E, d): the destination row of every edge."""
    return _gather(h, block.dst_flat, block.ecsr, block.n_parts)


class _EdgeSum(torch.autograd.Function):
    """``spmm(msgs, ecsr)`` forward; backward ``g[dst]`` on real edges, 0 on
    padded ones."""

    @staticmethod
    def forward(ctx, msgs, block: GraphBlock):
        ctx.block = block
        return spmm(msgs, block.ecsr)

    @staticmethod
    def backward(ctx, g):
        blk = ctx.block
        return torch.where(blk.edge_mask.reshape(-1, 1),
                           g.index_select(0, blk.dst_flat), 0.0), None


def _flat_msgs(msgs: torch.Tensor) -> torch.Tensor:
    return msgs.reshape(-1, msgs.shape[-1]).contiguous()


def agg_sum(block: GraphBlock, msgs: torch.Tensor) -> torch.Tensor:
    """(P, E, d) per-edge messages -> (P, n_local, d) sums onto destinations
    (padded edges add nothing), in ``ecsr``'s order and plan."""
    out = _EdgeSum.apply(_flat_msgs(msgs), block)
    return out.reshape(block.n_parts, block.n_local, -1)


def degrees(block: GraphBlock) -> torch.Tensor:
    """(P, n_local) in-degree over real edges (counted on the host from the
    CSR's ``row_ptr`` when the block was built)."""
    return block.deg


def agg_mean_msgs(block: GraphBlock, msgs: torch.Tensor) -> torch.Tensor:
    """(P, E, d) per-edge messages -> (P, n_local, d) their mean over each
    destination's real edges (0 where it has none): the JAX package's
    ``agg_mean``."""
    return agg_sum(block, msgs) / torch.clamp(block.deg, min=1.0)[..., None]


def agg_std(block: GraphBlock, msgs: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """``sqrt(max(E[m^2] - E[m]^2, 0) + eps)`` per destination and column.
    The maximum is ``torch.maximum`` against zeros, which, like
    ``jnp.maximum``, sends half the gradient each way on a tie: a row of one
    edge, or of equal messages, ties at exactly 0."""
    mu = agg_mean_msgs(block, msgs)
    mu2 = agg_mean_msgs(block, msgs * msgs)
    var = mu2 - mu * mu
    return torch.sqrt(torch.maximum(var, torch.zeros_like(var)) + eps)


class _SegMaxMin(torch.autograd.Function):
    """``seg_max_min(msgs, ecsr)`` forward: the max and the min (the tie
    counts kept for the backward). Backward, as ``jax.ops.segment_max``'s
    VJP of each: ``d msg[e] = where(msg[e] == max[dst], g_max[dst] * (1 /
    count_max[dst]), 0) + where(msg[e] == min[dst], g_min[dst] * (1 /
    count_min[dst]), 0)`` on real edges, 0 on padded ones
    (``seg_max_min_bwd``)."""

    @staticmethod
    def forward(ctx, msgs, block: GraphBlock):
        mx, cmx, mn, cmn = seg_max_min(msgs, block.ecsr)
        ctx.block = block
        ctx.save_for_backward(msgs, mx, cmx, mn, cmn)
        return mx, mn

    @staticmethod
    def backward(ctx, g_max, g_min):
        msgs, mx, cmx, mn, cmn = ctx.saved_tensors
        blk = ctx.block
        return seg_max_min_bwd(msgs, blk.ecsr, mx, cmx, mn, cmn, g_max,
                               g_min, blk.epad), None


def agg_max_min(block: GraphBlock, msgs: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, E, d) per-edge messages -> the (P, n_local, d) per-column maximum
    and minimum over each destination's real edges (0 where it has none),
    from one read of the messages."""
    mx, mn = _SegMaxMin.apply(_flat_msgs(msgs), block)
    shape = (block.n_parts, block.n_local, -1)
    return mx.reshape(shape), mn.reshape(shape)


def agg_max(block: GraphBlock, msgs: torch.Tensor) -> torch.Tensor:
    """The per-column maximum: the JAX package's ``agg_max``."""
    return agg_max_min(block, msgs)[0]


def agg_min(block: GraphBlock, msgs: torch.Tensor) -> torch.Tensor:
    """The per-column minimum, bit for bit the JAX package's ``agg_min``
    (``-agg_max(block, -msgs)``)."""
    return agg_max_min(block, msgs)[1]


def _agg_span(direction: str, x: torch.Tensor):
    """The ``agg`` span of one SpMM over ``x``'s rows (``obs.NULL_SPAN``,
    with no args built, when tracing is off)."""
    if not obs.enabled():
        return obs.NULL_SPAN
    return obs.span("agg", {"dir": direction, "width": int(x.shape[-1])},
                    x.device)


class _Aggregate(torch.autograd.Function):
    """``spmm(table, csr)`` forward, ``spmm(grad_out, csr_t)`` backward."""

    @staticmethod
    def forward(ctx, table, csr: CSR, csr_t: CSR):
        ctx.csr_t = csr_t
        with _agg_span("fwd", table):
            return spmm(table, csr)

    @staticmethod
    def backward(ctx, grad_out):
        with _agg_span("bwd", grad_out):
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
