"""Host-side graph partitioner + static halo-exchange plan (Sylvie's Graph Engine).

Splits a global graph into ``P`` equal (padded) partitions, builds the HALO node
sets (paper §2.2 / Alg. 1 lines 3-7), and emits a **static** exchange plan in one
of two layouts:

* ``dense`` — the classic pairwise-blocked buffer: ``send_idx[p, q, s]`` is the
  local index (in partition ``p``) of the ``s``-th node that ``p`` must send to
  ``q``; every (p, q) block is padded to ``h_pad`` (the max over all pairs) so a
  single ``all_to_all`` moves everything. Wire bytes scale with the *worst* pair
  — badly skewed on power-law graphs — and the all-masked diagonal self-blocks
  ride along for free.
* ``compact`` (default) — ragged ring buckets: the send buffer of partition
  ``p`` is the concatenation over ring offsets ``k = 1..P-1`` of the rows ``p``
  sends to partition ``(p+k) % P``. Bucket ``k`` is sized to the *ring max*
  ``max_p count[p -> (p+k)%P]`` rounded up to ``alignment`` rows (SPMD needs one
  static shape per bucket, not per pair), the diagonal (``k = 0``) is dropped
  from the wire entirely, and ``send_idx`` doubles as the compaction
  permutation: ``gather_boundary`` produces a packed buffer with no dead
  pairwise blocks. The exchange is one stacked roll (or one point-to-point
  send) per bucket; it is *not* an involution — the backward communication runs the
  reversed rings (see ``core/exchange.py``).

Either way the partition-local edge list's ``src`` indices address the
concatenated ``[local_features ; halo_buffer]`` table: a halo node received
from ``q`` at slot ``s`` lives at extended index ``n_local + q*h_pad + s``
(dense) or ``n_local + bucket_start[(p-q) % P] + s`` (compact).

All arrays carry a leading partition axis ``P`` (the simulated runtime keeps
the whole stack on one device). The plan is independent of the *model*; it is
computed once per (graph, P) and reused every layer/epoch (as in the paper).

:func:`analytic_partition_spec` sizes the same buffers without a graph
(``PartitionShapeSpec``, the dense layout), for the cell inventory of
``launch/cells.py``. :func:`partition_graph` times itself into the gauge
``setup.partition_s`` (``repro_torch.obs``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from .. import obs
from .formats import Graph


@dataclasses.dataclass
class HaloPlan:
    n_parts: int
    n_local: int
    h_pad: int                    # max per-(p,q) pairwise count (dense slot count)
    send_idx: np.ndarray          # dense: (P, P, h_pad) int32; compact: (P, R)
    send_mask: np.ndarray         # same shape as send_idx, bool
    recv_mask: np.ndarray         # (P, halo_rows) bool
    layout: str = "dense"         # "dense" | "compact"
    bucket_sizes: Optional[np.ndarray] = None   # (P,) aligned ring-bucket rows
    pair_counts: Optional[np.ndarray] = None    # (P_recv, P_send) true halo counts
    alignment: int = 1

    @property
    def halo_rows(self) -> int:
        """Rows of the (send or recv) halo buffer of one partition."""
        if self.layout == "compact":
            return int(self.bucket_sizes.sum())
        return self.n_parts * self.h_pad

    def wire_rows(self) -> int:
        """Rows this layout actually ships per exchange, totaled across all
        partitions. Diagonal self-blocks never hit the wire (a real all_to_all
        keeps the self-chunk local; the compact layout has no diagonal at all)."""
        if self.layout == "compact":
            return self.n_parts * self.halo_rows
        return self.n_parts * (self.n_parts - 1) * self.h_pad

    def real_rows(self) -> int:
        """True (unpadded, off-diagonal) halo rows per exchange, all partitions."""
        return int(self.send_mask.sum())

    def real_send_counts(self) -> np.ndarray:
        """(P,) true halo rows sent by each partition."""
        return self.send_mask.reshape(self.n_parts, -1).sum(axis=1)

    def pad_efficiency(self) -> float:
        """Fraction of buffered rows that are real (1.0 = no padding waste)."""
        total = self.send_mask.size
        return float(self.send_mask.sum()) / max(total, 1)


@dataclasses.dataclass
class PartitionedGraph:
    plan: HaloPlan
    part_of: np.ndarray           # (N,) partition of each global node
    global_ids: np.ndarray        # (P, n_local) global id of each local slot (pad=-1)
    node_mask: np.ndarray         # (P, n_local)
    x: np.ndarray                 # (P, n_local, d)
    y: Optional[np.ndarray]       # (P, n_local)
    train_mask: Optional[np.ndarray]
    val_mask: Optional[np.ndarray]
    test_mask: Optional[np.ndarray]
    edges: np.ndarray             # (P, e_pad, 2) int32  [src_ext, dst_local]
    edge_mask: np.ndarray         # (P, e_pad)
    edge_weight: Optional[np.ndarray]  # (P, e_pad)
    pos: Optional[np.ndarray] = None    # (P, n_local, 3)
    edge_attr: Optional[np.ndarray] = None  # (P, e_pad, d_e)
    n_classes: int = 0

    @property
    def n_parts(self) -> int:
        return self.plan.n_parts

    def unpartition(self, h_parts: np.ndarray) -> np.ndarray:
        """Reassemble a (P, n_local, ...) per-partition array into global node order."""
        n = int(self.part_of.shape[0])
        out = np.zeros((n,) + h_parts.shape[2:], dtype=np.asarray(h_parts).dtype)
        ids = self.global_ids[self.node_mask]
        out[ids] = np.asarray(h_parts)[self.node_mask]
        return out


def global_to_slot(pg: PartitionedGraph) -> tuple[np.ndarray, np.ndarray]:
    """``(part_of, slot_of)`` int64 maps: global node id -> (partition, local
    slot). The O(lookup) request-path index of the inference engine."""
    n = int(pg.part_of.shape[0])
    slot_of = np.full(n, -1, dtype=np.int64)
    pi, li = np.nonzero(pg.node_mask)
    slot_of[pg.global_ids[pi, li]] = li
    return pg.part_of.astype(np.int64), slot_of


def assign_parts(g: Graph, n_parts: int, method: str = "block", seed: int = 0) -> np.ndarray:
    """Partition assignment. ``block`` = contiguous id ranges (our synthetic
    generators have id locality, so this approximates a METIS-quality cut);
    ``random`` = hash partition (worst case, used to stress comm volume);
    ``skewed`` = contiguous blocks of geometrically decaying size (stress case
    for per-pair halo imbalance — what the compact layout is built for)."""
    n = g.n_nodes
    if method == "block":
        return (np.arange(n) * n_parts // n).astype(np.int32)
    if method == "random":
        rng = np.random.default_rng(seed)
        return rng.integers(0, n_parts, n).astype(np.int32)
    if method == "skewed":
        w = 0.5 ** np.arange(n_parts)
        bounds = np.ceil(np.cumsum(w / w.sum()) * n).astype(np.int64)
        bounds[-1] = n
        return np.searchsorted(bounds, np.arange(n), side="right").astype(np.int32)
    raise ValueError(method)


def _align_up(x: np.ndarray, a: int) -> np.ndarray:
    return -(-x // a) * a


@obs.timed("setup.partition_s")
def partition_graph(g: Graph, n_parts: int, method: str = "block",
                    edge_weight: Optional[np.ndarray] = None,
                    seed: int = 0, layout: str = "compact",
                    alignment: int = 8) -> PartitionedGraph:
    if layout not in ("dense", "compact"):
        raise ValueError(f"unknown halo layout {layout!r}")
    n = g.n_nodes
    src, dst = g.edge_index[0].astype(np.int64), g.edge_index[1].astype(np.int64)
    part_of = assign_parts(g, n_parts, method, seed)

    # --- local node numbering (padded to equal n_local) ------------------------
    counts = np.bincount(part_of, minlength=n_parts)
    n_local = int(counts.max())
    order = np.argsort(part_of, kind="stable")
    starts = np.zeros(n_parts + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    local_index = np.empty(n, dtype=np.int64)
    for p in range(n_parts):
        local_index[order[starts[p]:starts[p + 1]]] = np.arange(counts[p])
    global_ids = np.full((n_parts, n_local), -1, dtype=np.int64)
    node_mask = np.zeros((n_parts, n_local), dtype=bool)
    for p in range(n_parts):
        ids = order[starts[p]:starts[p + 1]]
        global_ids[p, :counts[p]] = ids
        node_mask[p, :counts[p]] = True

    # --- halo sets: unique (dst_part p, src_part q, node u) with q != p --------
    p_dst = part_of[dst].astype(np.int64)
    p_src = part_of[src].astype(np.int64)
    is_halo = p_src != p_dst
    pairkey = p_dst[is_halo] * n_parts + p_src[is_halo]
    combo = pairkey * n + src[is_halo]
    uniq, inv = np.unique(combo, return_inverse=True)
    u_pair = uniq // n
    u_node = uniq % n
    # slot of each unique halo node within its (p,q) group
    group_start_of = np.searchsorted(u_pair, np.arange(n_parts * n_parts))
    slot = np.arange(uniq.size) - group_start_of[u_pair]
    group_sizes = np.bincount(u_pair, minlength=n_parts * n_parts)
    pair_counts = group_sizes.reshape(n_parts, n_parts)  # [recv p, send q]
    h_pad = max(1, int(group_sizes.max()) if uniq.size else 1)
    q_of = u_pair % n_parts          # owner / sender
    p_of = u_pair // n_parts         # receiver

    bucket_sizes = None
    if layout == "dense":
        send_idx = np.zeros((n_parts, n_parts, h_pad), dtype=np.int64)
        send_mask = np.zeros((n_parts, n_parts, h_pad), dtype=bool)
        send_idx[q_of, p_of, slot] = local_index[u_node]
        send_mask[q_of, p_of, slot] = True
        recv_mask = np.transpose(send_mask, (1, 0, 2)).reshape(
            n_parts, n_parts * h_pad)
        # halo node from q at slot s -> extended index n_local + q*h_pad + s
        halo_ext = n_local + p_src[is_halo] * h_pad + slot[inv]
    else:
        # ring bucket k holds what each p sends to (p+k)%P; sized to the ring
        # max and lane-aligned so every partition shares one static shape.
        ring = np.arange(n_parts)
        ring_counts = np.zeros(n_parts, dtype=np.int64)
        for k in range(1, n_parts):
            ring_counts[k] = pair_counts[(ring + k) % n_parts, ring].max()
        bucket_sizes = np.where(ring_counts > 0,
                                _align_up(ring_counts, max(1, alignment)), 0)
        bucket_sizes[0] = 0          # diagonal self-block: never on the wire
        bstart = np.zeros(n_parts + 1, dtype=np.int64)
        np.cumsum(bucket_sizes, out=bstart[1:])
        rows = int(bucket_sizes.sum())
        k_of = (p_of - q_of) % n_parts
        send_idx = np.zeros((n_parts, rows), dtype=np.int64)
        send_mask = np.zeros((n_parts, rows), dtype=bool)
        pos = bstart[k_of] + slot
        send_idx[q_of, pos] = local_index[u_node]
        send_mask[q_of, pos] = True
        # recv[p][bucket k] = send[(p-k)%P][bucket k]  (the ring exchange)
        recv_mask = np.zeros_like(send_mask)
        for k in range(1, n_parts):
            if bucket_sizes[k] == 0:
                continue
            sl = slice(bstart[k], bstart[k] + bucket_sizes[k])
            recv_mask[:, sl] = np.roll(send_mask[:, sl], k, axis=0)
        # halo node from q at slot s -> n_local + bucket_start[(p-q)%P] + s
        halo_ext = n_local + bstart[(p_dst[is_halo] - p_src[is_halo]) % n_parts] \
            + slot[inv]

    # --- per-partition edge lists (ext src indexing) ---------------------------
    src_ext = np.where(is_halo, 0, local_index[src])
    src_ext[is_halo] = halo_ext
    dst_loc = local_index[dst]

    e_counts = np.bincount(p_dst, minlength=n_parts)
    e_pad = max(1, int(e_counts.max()))
    edges = np.zeros((n_parts, e_pad, 2), dtype=np.int64)
    edge_mask = np.zeros((n_parts, e_pad), dtype=bool)
    ew = None if edge_weight is None else np.zeros((n_parts, e_pad), dtype=np.float32)
    ea = None if g.edge_attr is None else np.zeros(
        (n_parts, e_pad) + g.edge_attr.shape[1:], dtype=g.edge_attr.dtype)
    eorder = np.argsort(p_dst, kind="stable")
    estarts = np.zeros(n_parts + 1, dtype=np.int64)
    np.cumsum(e_counts, out=estarts[1:])
    for p in range(n_parts):
        sel = eorder[estarts[p]:estarts[p + 1]]
        k = sel.size
        edges[p, :k, 0] = src_ext[sel]
        edges[p, :k, 1] = dst_loc[sel]
        edge_mask[p, :k] = True
        if ew is not None:
            ew[p, :k] = edge_weight[sel]
        if ea is not None:
            ea[p, :k] = g.edge_attr[sel]

    def scatter_nodes(arr, fill=0.0):
        if arr is None:
            return None
        out = np.full((n_parts, n_local) + arr.shape[1:], fill, dtype=arr.dtype)
        out[node_mask] = arr[global_ids[node_mask]]
        return out

    plan = HaloPlan(n_parts, n_local, h_pad,
                    send_idx.astype(np.int32), send_mask, recv_mask,
                    layout=layout, bucket_sizes=bucket_sizes,
                    pair_counts=pair_counts,
                    alignment=alignment if layout == "compact" else 1)
    return PartitionedGraph(
        plan=plan, part_of=part_of, global_ids=global_ids, node_mask=node_mask,
        x=scatter_nodes(g.x),
        y=scatter_nodes(g.y) if g.y is not None else None,
        train_mask=scatter_nodes(g.train_mask),
        val_mask=scatter_nodes(g.val_mask),
        test_mask=scatter_nodes(g.test_mask),
        edges=edges.astype(np.int32), edge_mask=edge_mask, edge_weight=ew,
        pos=scatter_nodes(g.pos), edge_attr=ea, n_classes=g.n_classes)


# ---------------------------------------------------------------------------
# Halo-structure introspection: which *global* node each halo-buffer row
# carries, and the k-hop frontier of a seed set. Host-side (numpy), built
# entirely from the partition plan — the serving-time delta refresh
# (repro_torch.serve.delta) plans its per-layer affected sets with these.
# ---------------------------------------------------------------------------
def halo_source_globals(pg: PartitionedGraph) -> np.ndarray:
    """(P, halo_rows) global node id carried by each halo-buffer row of each
    partition (-1 for padding rows). Inverts the exchange: row ``r`` of
    partition ``p``'s *receive* buffer holds the node partition ``q`` gathered
    at the matching slot of its *send* buffer (``q = (p-k) % P`` for compact
    ring bucket ``k``; the block sender for dense)."""
    plan = pg.plan
    n_parts = plan.n_parts
    out = np.full((n_parts, plan.halo_rows), -1, dtype=np.int64)
    if plan.layout == "compact":
        bstart = np.zeros(n_parts + 1, dtype=np.int64)
        np.cumsum(plan.bucket_sizes, out=bstart[1:])
        for p in range(n_parts):
            for k in range(1, n_parts):
                if plan.bucket_sizes[k] == 0:
                    continue
                q = (p - k) % n_parts
                sl = slice(bstart[k], bstart[k + 1])
                idx, m = plan.send_idx[q, sl], plan.send_mask[q, sl]
                row = out[p, sl]
                row[m] = pg.global_ids[q, idx[m]]
    else:
        for p in range(n_parts):
            for q in range(n_parts):
                sl = slice(q * plan.h_pad, (q + 1) * plan.h_pad)
                idx, m = plan.send_idx[q, p], plan.send_mask[q, p]
                row = out[p, sl]
                row[m] = pg.global_ids[q, idx[m]]
    return out


def global_edges(pg: PartitionedGraph) -> tuple[np.ndarray, np.ndarray]:
    """(src_global, dst_global) of every real (unmasked) edge, reconstructed
    from the per-partition extended-index edge lists. Local extended indices
    resolve through ``global_ids``; halo indices through
    :func:`halo_source_globals`."""
    plan = pg.plan
    halo_src = halo_source_globals(pg)
    srcs, dsts = [], []
    for p in range(plan.n_parts):
        m = pg.edge_mask[p]
        se = pg.edges[p, m, 0].astype(np.int64)
        dl = pg.edges[p, m, 1].astype(np.int64)
        local = se < plan.n_local
        sg = np.where(local,
                      pg.global_ids[p, np.where(local, se, 0)],
                      halo_src[p, np.where(local, 0, se - plan.n_local)])
        srcs.append(sg)
        dsts.append(pg.global_ids[p, dl])
    src_g = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst_g = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    assert (src_g >= 0).all() and (dst_g >= 0).all(), \
        "edge list references a padding halo row"
    return src_g, dst_g


def khop_frontier(pg: PartitionedGraph, seed_nodes, k: int,
                  edges: Optional[tuple[np.ndarray, np.ndarray]] = None
                  ) -> np.ndarray:
    """(k+1, N) bool: ``out[h]`` marks the global nodes reachable from
    ``seed_nodes`` within ``h`` *directed* hops (message direction src -> dst;
    ``out[0]`` is the seed set itself, each row a superset of the previous).

    This is the incremental-refresh frontier: when the features of
    ``seed_nodes`` change, the layer-``h`` input embeddings of exactly the
    nodes in ``out[h]`` can change (each GNN layer pulls one hop), so a
    serving-time delta refresh only needs to re-ship layer ``h``'s boundary
    rows inside ``out[h]`` (see ``repro_torch.serve.delta``).

    ``edges`` optionally supplies a precomputed :func:`global_edges` pair —
    callers planning many refreshes over one immutable partition (the
    inference engine) amortize the O(E) reconstruction that way."""
    n = int(pg.part_of.shape[0])
    seeds = np.asarray(seed_nodes, dtype=np.int64).reshape(-1)
    if seeds.size and (seeds.min() < 0 or seeds.max() >= n):
        raise ValueError(f"seed node ids must be in [0, {n})")
    out = np.zeros((k + 1, n), dtype=bool)
    out[0, seeds] = True
    if k == 0:
        return out
    src_g, dst_g = global_edges(pg) if edges is None else edges
    for h in range(k):
        nxt = out[h].copy()
        nxt[dst_g[out[h][src_g]]] = True
        out[h + 1] = nxt
    return out


# ---------------------------------------------------------------------------
# Analytic plan *shapes* (no graph is materialized): the sizes of a cell's
# static buffers for launch/cells.py. They size the dense layout (the
# conservative upper bound).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PartitionShapeSpec:
    n_parts: int
    n_local: int
    e_pad: int
    h_pad: int

    @property
    def halo_rows(self) -> int:
        return self.n_parts * self.h_pad


def analytic_partition_spec(n_nodes: int, n_edges: int, n_parts: int,
                            halo_frac: float = 0.5, pair_imbalance: float = 4.0,
                            edge_imbalance: float = 1.15) -> PartitionShapeSpec:
    """Size the static buffers for a hypothetical good (METIS-quality)
    partition.

    ``halo_frac``: halo nodes per partition as a fraction of local nodes
    (0.3-1.0 for locality-aware cuts of power-law graphs at this
    parallelism). ``pair_imbalance``: max/mean ratio of per-pair halo counts
    (the padding factor)."""
    n_local = math.ceil(n_nodes / n_parts)
    e_pad = max(1, math.ceil(n_edges / n_parts * edge_imbalance))
    halo_total = halo_frac * n_local
    h_pad = max(1, math.ceil(halo_total * pair_imbalance / max(1, n_parts - 1)))
    return PartitionShapeSpec(n_parts, n_local, e_pad, h_pad)
