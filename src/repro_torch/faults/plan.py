"""Seeded fault schedules and their expansion to per-row wire masks, as
``repro.faults.plan``.

Two halves:

* **scheduling is host-side and exactly reproducible** — a :class:`FaultPlan`
  is a frozen bag of rates plus a seed; ``plan.events(epoch, ...)`` draws the
  epoch's fault set from ``np.random.default_rng([seed, epoch])``, keyed on
  (site, direction, src partition, dst partition). This is host numpy in
  both packages, so the port draws exactly the reference's events: same
  plan, same epoch, the same faults, in any process — what the chaos tests
  and the kill-and-resume harness rely on.
* **injection is data** — an epoch's events are expanded on the host into
  per-site boolean row masks over the wire buffers (:class:`SiteFaults` /
  :class:`FaultCtl`) that ride into the step in ``GNNTrainState.faults``;
  the fault-free case (``faults=None``) runs the clean primitives.

Fault taxonomy (DESIGN.md §12): ``drop`` (message lost: the receiver reuses
its stale cached halo), ``corrupt`` (payload bit-flipped on the wire:
detected by the per-row checksum of ``faults/wire.py`` and handled exactly
like a drop), ``delay`` (delivered but late: modeled, see
:meth:`FaultEvents.stall_s`) and ``preempt`` (a whole partition down for the
epoch: every message to or from it folds into ``drop``).

Geometry: an event names an ordered message ``src -> dst``; the masks land on
the *rows* of each partition's send and recv buffers, which differ by layout
(dense pairwise blocks vs compact ring buckets) and by direction (the
backward gradient exchange runs the rings in reverse, so its send buffer has
recv geometry and vice versa). :class:`RowGeometry` owns those maps.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

# direction indices into the (S, 2, P, P) event arrays
FWD, BWD = 0, 1


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, rate-parameterized chaos schedule (frozen and hashable).

    Rates are per ordered (site, direction, src, dst) message per epoch.
    ``escalate_after`` is the staleness-as-recovery threshold: a site faulted
    for that many *consecutive* epochs forces one clean full-precision
    synchronous retry epoch (the trainer suppresses that epoch's schedule and
    counts its units as ``forced_syncs``). ``warmup_clean`` keeps epoch 0
    fault-free — the halo caches a drop falls back to do not exist before
    the first synchronous epoch."""

    seed: int = 0
    drop_rate: float = 0.0
    corrupt_rate: float = 0.0
    delay_rate: float = 0.0
    delay_s: float = 0.05
    preempt_rate: float = 0.0
    escalate_after: int = 3
    warmup_clean: bool = True

    def events(self, epoch: int, n_sites: int, n_parts: int) -> "FaultEvents":
        """The epoch's fault set — deterministic in (seed, epoch) alone."""
        shape = (n_sites, 2, n_parts, n_parts)
        if epoch == 0 and self.warmup_clean:
            return FaultEvents(drop=np.zeros(shape, bool),
                               corrupt=np.zeros(shape, bool),
                               delay=np.zeros(shape, bool),
                               preempted=np.zeros(n_parts, bool))
        rng = np.random.default_rng([int(self.seed), int(epoch)])
        drop = rng.random(shape) < self.drop_rate
        preempted = rng.random(n_parts) < self.preempt_rate
        if preempted.any():
            # a preempted partition neither sends nor receives this epoch
            drop[:, :, preempted, :] = True
            drop[:, :, :, preempted] = True
        # corrupt/delay are drawn over all pairs but made disjoint from drop:
        # a lost message cannot also arrive corrupted or late, and the
        # accounting (faults_injected == halos_reused + forced_syncs) counts
        # each message unit at most once.
        corrupt = (rng.random(shape) < self.corrupt_rate) & ~drop
        delay = (rng.random(shape) < self.delay_rate) & ~drop
        off_diag = ~np.eye(n_parts, dtype=bool)
        return FaultEvents(drop=drop & off_diag, corrupt=corrupt & off_diag,
                           delay=delay & off_diag, preempted=preempted)

    @staticmethod
    def n_units(n_sites: int, n_parts: int) -> int:
        """Message units per epoch: ordered off-diagonal pairs, both
        directions, every site — the denominator of a drop-fraction claim."""
        return n_sites * 2 * n_parts * (n_parts - 1)


@dataclasses.dataclass(frozen=True)
class FaultEvents:
    """One epoch's fault set, keyed (site, direction, src, dst). Host arrays."""

    drop: np.ndarray        # (S, 2, P, P) bool — message lost
    corrupt: np.ndarray     # (S, 2, P, P) bool — payload bit-flipped (≠ drop)
    delay: np.ndarray       # (S, 2, P, P) bool — delivered late (≠ drop)
    preempted: np.ndarray   # (P,) bool — partition down this epoch

    @property
    def n_injected(self) -> int:
        """Injected fault units this epoch (drops + corruptions; a corrupted
        payload is detected and recovered exactly like a drop)."""
        return int(self.drop.sum() + self.corrupt.sum())

    def faulty_sites(self) -> np.ndarray:
        """(S,) bool — sites with at least one injected fault this epoch."""
        return (self.drop | self.corrupt).any(axis=(1, 2, 3))

    def stall_s(self, delay_s: float) -> float:
        """Modeled straggler stall: every partition waits for its slowest
        inbound edge, so the epoch extends by ``delay_s`` times the deepest
        per-destination pile-up of delayed messages (the critical path)."""
        if not self.delay.any():
            return 0.0
        per_dst = self.delay.sum(axis=(0, 1, 2))
        return float(delay_s) * float(per_dst.max())


@dataclasses.dataclass(frozen=True)
class RowGeometry:
    """Host-side map from (src, dst) message pairs to wire-buffer rows.

    Both layouts reduce to two ``(P, rows)`` peer tables:

    * ``peer_recv[p, r]`` — the partition row ``r`` of ``p``'s *recv* buffer
      arrived from (dense: the block index ``r // h_pad``; compact:
      ``(p - k) % P`` for bucket ``k``);
    * ``peer_send[p, r]`` — where row ``r`` of ``p``'s *send* buffer goes
      (dense: the block index again; compact: ``(p + k) % P``)."""

    n_parts: int
    halo_rows: int
    h_pad: int
    bucket_sizes: Optional[tuple[int, ...]]

    @staticmethod
    def from_plan(plan) -> "RowGeometry":
        """From a ``PlanArrays`` (or a host ``HaloPlan``)."""
        buckets = getattr(plan, "bucket_sizes", None)
        if getattr(plan, "layout", "compact") == "dense":
            buckets = None
        return RowGeometry(
            n_parts=int(plan.n_parts), halo_rows=int(plan.halo_rows),
            h_pad=int(plan.h_pad),
            bucket_sizes=None if buckets is None
            else tuple(int(b) for b in buckets))

    def peers(self) -> tuple[np.ndarray, np.ndarray]:
        """(peer_recv, peer_send), each ``(P, rows)`` int64. Cached — the
        trainer expands masks against the same geometry every epoch."""
        return _peers_cached(self)

    def _peers(self) -> tuple[np.ndarray, np.ndarray]:
        p, rows = self.n_parts, self.halo_rows
        if self.bucket_sizes is None:
            block = np.arange(rows, dtype=np.int64) // self.h_pad
            peer = np.broadcast_to(block, (p, rows))
            return peer, peer
        offsets = np.concatenate(
            [np.full(b, k, dtype=np.int64)
             for k, b in enumerate(self.bucket_sizes)]
        ) if sum(self.bucket_sizes) else np.zeros(0, np.int64)
        part = np.arange(p, dtype=np.int64)[:, None]
        peer_recv = (part - offsets[None, :]) % p
        peer_send = (part + offsets[None, :]) % p
        return peer_recv, peer_send


@functools.lru_cache(maxsize=64)
def _peers_cached(geom: RowGeometry) -> tuple[np.ndarray, np.ndarray]:
    return geom._peers()


@dataclasses.dataclass
class SiteFaults:
    """One exchange site's fault masks over the wire buffers, (P, rows) bool:

    * ``drop_fwd`` — on the *recv* buffer: rows whose forward message was
      lost; the receiver keeps its cached halo row;
    * ``corrupt_fwd`` — on the *send* buffer: rows whose forward payload is
      bit-flipped before the exchange;
    * ``drop_bwd`` — on the *send* buffer (returned gradients align with
      send rows): backward messages lost;
    * ``corrupt_bwd`` — on the *recv* buffer (outgoing gradients align with
      recv rows): backward payloads bit-flipped."""

    drop_fwd: torch.Tensor
    corrupt_fwd: torch.Tensor
    drop_bwd: torch.Tensor
    corrupt_bwd: torch.Tensor


@dataclasses.dataclass
class FaultCtl:
    """The per-epoch fault control block, carried in ``GNNTrainState.faults``:
    every site's masks stacked into one ``(P, S, 4, rows)`` bool tensor (the
    4-axis is [drop_fwd, corrupt_fwd, drop_bwd, corrupt_bwd]), so an epoch's
    masks reach the device in one copy. An all-false :meth:`clean` block (a
    suppressed recovery epoch) runs the very same code as a faulty one."""

    masks: torch.Tensor

    @property
    def sites(self) -> tuple:
        """Per-site :class:`SiteFaults` views of the one tensor."""
        return tuple(
            SiteFaults(drop_fwd=self.masks[:, s, 0],
                       corrupt_fwd=self.masks[:, s, 1],
                       drop_bwd=self.masks[:, s, 2],
                       corrupt_bwd=self.masks[:, s, 3])
            for s in range(self.masks.shape[1]))

    @staticmethod
    def expand(events: FaultEvents, geom: RowGeometry, n_sites: int,
               device=None, part: Optional[int] = None) -> "FaultCtl":
        """Pairwise (S, 2, P, P) events -> per-row wire masks, per layout,
        on ``device``: the whole stack's, or (``part``, a sharded runtime's
        rank) that partition's row of them."""
        peer_recv, peer_send = geom.peers()
        parts = np.arange(geom.n_parts, dtype=np.int64)[:, None]
        # vectorized over sites: A[:, X, Y] with X, Y (P, rows) / (P, 1)
        # broadcasts to (S, P, rows)
        stacked = np.stack([
            events.drop[:, FWD][:, peer_recv, parts],
            events.corrupt[:, FWD][:, parts, peer_send],
            events.drop[:, BWD][:, peer_send, parts],
            events.corrupt[:, BWD][:, parts, peer_recv],
        ], axis=1)                                   # (S, 4, P, rows)
        masks = stacked.transpose(2, 0, 1, 3)
        if part is not None:
            masks = masks[part:part + 1]
        return FaultCtl(masks=torch.from_numpy(
            np.ascontiguousarray(masks)).to(device))

    @staticmethod
    def clean(geom: RowGeometry, n_sites: int, device=None,
              part: Optional[int] = None) -> "FaultCtl":
        """All-false masks — same structure, zero faults (recovery epochs)."""
        return FaultCtl(masks=torch.zeros(
            (geom.n_parts if part is None else 1, n_sites, 4,
             geom.halo_rows), dtype=torch.bool, device=device))
