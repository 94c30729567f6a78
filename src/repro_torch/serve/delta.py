"""Incremental k-hop delta refresh: host-side planning + wire accounting.

When the features of a batch of nodes change, the layer-``h`` input
embeddings that can change are exactly the nodes within ``h`` directed hops of
the changed set (each GNN layer pulls one hop) —
:func:`repro_torch.graph.partition.khop_frontier`. A delta refresh therefore
re-ships, at exchange site ``i``, only the boundary rows whose owner lies in
``frontier[i]`` (the :class:`RefreshPlan` send masks); every other halo row
comes from the engine's per-layer cache. Under deterministic rounding the
cached rows are bit-identical to what a fresh exchange would deliver, so a
delta refresh equals a full sweep exactly while shipping a fraction of the
bytes.

Wire accounting is exact: per site, the quantized payload + error
compensation of the affected real rows (the Table-3 rule of
:func:`~repro_torch.core.quantization.comm_bytes`) plus a 1-bit-per-real-row
bitmap per site for a delta.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core.quantization import comm_bytes
from ..dist.api import local_slice
from ..graph.partition import PartitionedGraph, global_edges, khop_frontier
from ..policy.base import EpochDecision


@dataclasses.dataclass(frozen=True)
class RefreshPlan:
    """One refresh's schedule: ``send_affected[i]`` is a (P, rows) bool mask
    over the site-``i`` send buffer (a subset of the plan's ``send_mask``);
    ``affected_rows[i]`` its row count over all partitions; ``changed`` the
    seed-set size; ``full`` plans re-ship every real row."""

    send_affected: tuple[np.ndarray, ...]
    affected_rows: tuple[int, ...]
    changed: int
    full: bool

    def device_masks(self, device=None,
                     part: Optional[int] = None) -> tuple[torch.Tensor, ...]:
        """uint8 masks for the sweep, on ``device``: every partition's, or
        (``part``, a sharded runtime's rank) that partition's row."""
        return tuple(torch.as_tensor(local_slice(m, part), dtype=torch.uint8,
                                     device=device)
                     for m in self.send_affected)


def _send_globals(pg: PartitionedGraph) -> np.ndarray:
    """(P, rows) global node id owning each send-buffer row (-1 padding)."""
    plan = pg.plan
    idx = plan.send_idx.reshape(plan.n_parts, -1).astype(np.int64)
    mask = plan.send_mask.reshape(plan.n_parts, -1)
    rows = np.take_along_axis(pg.global_ids, idx, axis=1)
    return np.where(mask, rows, -1)


@dataclasses.dataclass(frozen=True)
class FrontierIndex:
    """Refresh-planning state for one immutable partition, built once per
    engine (the global edge list and send-row ownership), so each
    ``plan_refresh`` is O(frontier), not O(graph)."""

    pg: PartitionedGraph
    edges: tuple[np.ndarray, np.ndarray]     # global_edges(pg)
    send_globals: np.ndarray                 # (P, rows), -1 padding
    base_mask: np.ndarray                    # (P, rows) = plan.send_mask

    @staticmethod
    def build(pg: PartitionedGraph) -> "FrontierIndex":
        return FrontierIndex(
            pg=pg, edges=global_edges(pg), send_globals=_send_globals(pg),
            base_mask=pg.plan.send_mask.reshape(pg.plan.n_parts, -1))

    def plan_refresh(self, changed_global_ids, n_sites: int) -> RefreshPlan:
        """Delta plan: site ``i`` re-ships the boundary rows owned by nodes
        within ``i`` hops of the changed set."""
        changed = np.asarray(changed_global_ids, dtype=np.int64).reshape(-1)
        frontier = khop_frontier(self.pg, changed, max(n_sites - 1, 0),
                                 edges=self.edges)
        sg = np.clip(self.send_globals, 0, None)
        masks, rows = [], []
        for i in range(n_sites):
            aff = self.base_mask & frontier[min(i, frontier.shape[0] - 1)][sg]
            masks.append(aff)
            rows.append(int(aff.sum()))
        return RefreshPlan(send_affected=tuple(masks),
                           affected_rows=tuple(rows),
                           changed=int(changed.size), full=False)


def plan_refresh(pg: PartitionedGraph, changed_global_ids,
                 n_sites: int) -> RefreshPlan:
    """One-shot :meth:`FrontierIndex.plan_refresh` (builds the O(E) index
    each call: hold a :class:`FrontierIndex` when planning repeatedly, as
    the engine does)."""
    return FrontierIndex.build(pg).plan_refresh(changed_global_ids, n_sites)


def plan_full(pg: PartitionedGraph, n_sites: int) -> RefreshPlan:
    """The full-sweep plan: every real row ships."""
    mask = pg.plan.send_mask.reshape(pg.plan.n_parts, -1)
    rows = int(mask.sum())
    return RefreshPlan(send_affected=(mask,) * n_sites,
                       affected_rows=(rows,) * n_sites,
                       changed=0, full=True)


@dataclasses.dataclass(frozen=True)
class RefreshReport:
    """What one refresh (full sweep or delta) cost on the wire, and its
    host-clock seconds (``repro_torch.obs.clock`` around the sweep, ending
    after the logits reached the host and, with a store attached, after the
    publish)."""

    kind: str                       # "full" | "delta"
    forced: bool                    # delta request escalated by the bound
    changed: int                    # seed nodes whose features changed
    affected_rows: tuple[int, ...]  # real rows shipped per site
    payload_bytes: int
    ec_bytes: int                   # error-compensation (scale/zero)
    meta_bytes: int                 # delta bitmap (which cached rows refresh)
    seconds: float = 0.0

    @property
    def wire_bytes(self) -> int:
        return self.payload_bytes + self.ec_bytes + self.meta_bytes


def refresh_wire_bytes(plan_real_rows: int, site_dims, decision: EpochDecision,
                       refresh: RefreshPlan, scale_dtype) -> tuple[int, int, int]:
    """(payload, ec, meta) exact wire bytes of one refresh under ``decision``
    (forward direction only; a full sweep needs no bitmap)."""
    payload = ec = 0
    for i, d in enumerate(site_dims):
        pb, eb = comm_bytes(refresh.affected_rows[i], int(d),
                            decision.sites[i].fwd_bits, scale_dtype)
        payload += pb
        ec += eb
    meta = 0 if refresh.full else len(tuple(site_dims)) * \
        math.ceil(plan_real_rows / 8)
    return payload, ec, meta
