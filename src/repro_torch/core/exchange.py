"""Halo exchange primitives: boundary gather + the exchange entry points.

All GNN runtime code operates on *stacked* tensors with a leading partition
axis — e.g. node features ``(P, n_local, d)`` on the simulated stack, a
process's own ``(1, n_local, d)`` under a sharded runtime. Which collective
moves the halo buffers is the backend's decision
(``repro_torch.dist.backend``); this module is the seam. Two buffer layouts exist (see ``graph/partition.py``):

* dense pairwise blocks ``(P, P*h_pad, ...)`` — the exchange is a transpose,
  its own inverse;
* compact ring buckets ``(P, R, ...)`` with ``R = sum(bucket_sizes)`` — bucket
  ``k`` moves ``p -> (p+k) % P``; ``reverse=True`` runs the inverted rings.

The backward's scatter of received boundary gradients onto their owner rows
(:func:`scatter_boundary_grad`) is a fixed 0/1 matrix from send slots to
owners, built once on the host with the plan (``PlanArrays.scatter``) and
applied by the SpMM kernel: no atomics, the adds in slot order.

Tracing (``repro_torch.obs``): every exchange site's work in each direction
runs inside a :func:`halo_span`, and the entry points below that hand
buffers to the backend add their bytes (``nbytes`` of the payload and of
the scale/zero, host metadata) to the innermost open one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..dist.backend import Inflight, as_backend
from ..kernels.spmm.ops import spmm
from ..kernels.spmm.ref import CSR, csr_from_edges
from .quantization import QuantizedTensor, comm_bytes


@dataclasses.dataclass(frozen=True)
class PlanArrays:
    """Device-side halo plan (stacked, leading axis P; a sharded runtime's
    holds its own partition's row, leading axis 1, and keeps ``n_parts`` =
    P). See graph/partition.py.

    ``bucket_sizes`` is ``None`` for the dense layout and the per-ring-offset
    row counts for the compact layout. ``wire_rows`` / ``real_rows`` are
    exchange-accounting constants (totals across partitions): rows the layout
    ships vs. true unpadded off-diagonal halo rows. ``scatter`` is the CSR of
    :func:`scatter_csr` (``None`` on a plan built by hand)."""

    send_idx: torch.Tensor   # (P, rows) int64 — local rows to send
    send_mask: torch.Tensor  # (P, rows) bool
    recv_mask: torch.Tensor  # (P, rows) bool
    n_local: int
    h_pad: int
    n_parts: int
    bucket_sizes: Optional[tuple[int, ...]] = None
    wire_rows: int = 0
    real_rows: int = 0
    scatter: Optional[CSR] = None

    @property
    def halo_rows(self) -> int:
        """Rows of one partition's halo buffer (dense: P*h_pad; compact: R)."""
        return int(self.send_idx.shape[1])

    @staticmethod
    def from_spec(spec) -> "PlanArrays":
        """The plan of an analytic ``PartitionShapeSpec`` (no graph): its
        index and mask tensors on the ``meta`` device, so nothing is
        allocated. Analytic specs size the dense layout; wire and real rows
        are the off-diagonal dense count ``P*(P-1)*h_pad`` (no masks exist
        to count real rows)."""
        s = spec
        rows = s.n_parts * s.h_pad
        wire = s.n_parts * (s.n_parts - 1) * s.h_pad
        meta = torch.device("meta")
        return PlanArrays(
            send_idx=torch.empty((s.n_parts, rows), dtype=torch.int64,
                                 device=meta),
            send_mask=torch.empty((s.n_parts, rows), dtype=torch.bool,
                                  device=meta),
            recv_mask=torch.empty((s.n_parts, rows), dtype=torch.bool,
                                  device=meta),
            n_local=int(s.n_local), h_pad=int(s.h_pad),
            n_parts=int(s.n_parts), bucket_sizes=None, wire_rows=wire,
            real_rows=wire)

    @staticmethod
    def from_plan(plan, device=None, part: Optional[int] = None
                  ) -> "PlanArrays":
        """The host plan on ``device``: the whole stack, or partition
        ``part``'s row of every array (the byte-accounting totals stay the
        whole graph's)."""
        p = plan
        buckets = None
        if getattr(p, "layout", "dense") == "compact":
            buckets = tuple(int(b) for b in p.bucket_sizes)
        rows = slice(None) if part is None else slice(part, part + 1)
        send_idx = np.asarray(p.send_idx).reshape(p.n_parts, -1)[rows]
        send_mask = np.asarray(p.send_mask).reshape(p.n_parts, -1)[rows]
        return PlanArrays(
            send_idx=torch.as_tensor(send_idx, dtype=torch.int64,
                                     device=device),
            send_mask=torch.as_tensor(send_mask, device=device),
            recv_mask=torch.as_tensor(np.asarray(p.recv_mask)[rows],
                                      device=device),
            n_local=int(p.n_local), h_pad=int(p.h_pad), n_parts=int(p.n_parts),
            bucket_sizes=buckets, wire_rows=int(p.wire_rows()),
            real_rows=int(p.real_rows()),
            scatter=scatter_csr(send_idx, send_mask, int(p.n_local)).to(
                device))


def scatter_csr(send_idx: np.ndarray, send_mask: np.ndarray,
                n_local: int) -> CSR:
    """Host-side: the boundary-gradient scatter as a CSR over the stack.
    Row ``p*n_local + send_idx[p, s]`` (the owner) gathers column ``p*rows +
    s`` (the send slot) with weight 1 for every live slot, in slot order."""
    n_parts, rows = send_idx.shape
    part, slot = np.nonzero(send_mask)            # partition-major, slot order
    return csr_from_edges(part * rows + slot,
                          part * n_local + send_idx[part, slot],
                          np.ones(part.size, np.float32), n_parts * n_local,
                          n_parts * rows)


def gather_boundary(h: torch.Tensor, plan: PlanArrays) -> torch.Tensor:
    """(P, n_local, d) -> (P, rows, d) packed send buffer (masked rows zero)."""
    idx = plan.send_idx[..., None].expand(-1, -1, h.shape[-1])
    buf = torch.gather(h, 1, idx)
    return torch.where(plan.send_mask[..., None], buf, 0.0)


def scatter_boundary_grad(g: torch.Tensor, plan: PlanArrays) -> torch.Tensor:
    """(P, rows, d) received grads -> (P, n_local, d) sums onto the owners.

    A node sent to several partitions accumulates all their gradients
    (Alg. 2 line 13); masked slots add nothing. One SpMM over
    ``plan.scatter``: the kernel on CUDA, its plain version on the CPU."""
    p, rows, d = g.shape
    out = spmm(g.reshape(p * rows, d).contiguous(), plan.scatter)
    return out.reshape(p, plan.n_local, d)


def halo_span(site: Optional[int], direction: str, kind: str, device):
    """The ``halo`` span of exchange site ``site``'s work in ``direction``
    (``"fwd"`` | ``"bwd"``), timed on ``device``. ``kind`` names the
    exchange's path, not its precision: ``"quantized"`` (a synchronous
    exchange through the quantize/dequantize round trip at the site's bits,
    32 included: vanilla's float32 exchange is one), ``"stale"`` (Sylvie-A's
    backward: the outgoing gradients and the stale ``grad_in`` scattered),
    ``"fresh"`` (Sylvie-A's forward: the next step's halo) or ``"faulty"``
    (a fault-armed site).
    ``bytes`` sums what its exchanges hand to the backend.
    ``obs.NULL_SPAN``, with no args built, when tracing is off."""
    if not obs.enabled():
        return obs.NULL_SPAN
    return obs.span("halo", {"site": site, "dir": direction, "kind": kind,
                             "bytes": 0}, device)


def _handed(*tensors: torch.Tensor) -> None:
    """Count the bytes of the buffers handed to the backend in the open
    ``halo`` span."""
    if obs.enabled():
        obs.add_arg("halo", "bytes",
                    sum(t.numel() * t.element_size() for t in tensors))


def exchange(x: torch.Tensor, backend=None) -> torch.Tensor:
    """The dense halo all-to-all of a pairwise-blocked buffer ``x`` (P_local,
    P*h_pad, ...), through ``backend`` (``None``: the simulated stacked
    transpose)."""
    return as_backend(backend).exchange(x)


def exchange_quantized(qt: QuantizedTensor, backend=None) -> QuantizedTensor:
    """Exchange a dense quantized payload: data + error compensation (scale,
    zero) move together (paper §3.2 Communicator)."""
    return as_backend(backend).exchange_quantized(qt)


def exchange_halo(x: torch.Tensor, plan: PlanArrays, backend=None,
                  reverse: bool = False) -> torch.Tensor:
    """Layout-dispatching halo exchange. Dense plans use the transpose
    (``reverse`` ignored); compact plans run the ring buckets, reversed for
    the backward communication."""
    be = as_backend(backend)
    _handed(x)
    if plan.bucket_sizes is None:
        return be.exchange(x)
    return be.exchange_compact(x, plan.bucket_sizes, reverse=reverse)


def exchange_quantized_halo(qt: QuantizedTensor, plan: PlanArrays,
                            backend=None,
                            reverse: bool = False) -> QuantizedTensor:
    """Layout-dispatching quantized exchange (payload + scale/zero together)."""
    be = as_backend(backend)
    _handed(qt.data, qt.scale, qt.zero)
    if plan.bucket_sizes is None:
        return be.exchange_quantized(qt)
    return be.exchange_quantized_compact(qt, plan.bucket_sizes,
                                         reverse=reverse)


def issue_quantized_halo(qt: QuantizedTensor, plan: PlanArrays, backend=None,
                         reverse: bool = False) -> Inflight:
    """Start the layout's quantized exchange; ``backend.fence`` lands it."""
    _handed(qt.data, qt.scale, qt.zero)
    return as_backend(backend).issue_quantized(qt, plan.bucket_sizes,
                                               reverse=reverse)


def exchange_bytes(plan: PlanArrays, d: int, bits: int,
                   scale_dtype=torch.bfloat16) -> tuple[int, int]:
    """(payload, error-compensation) *true wire* bytes per exchange, totaled
    across partitions: diagonal self-blocks and padding rows excluded."""
    return comm_bytes(plan.real_rows, d, bits, scale_dtype)


def wire_bytes(plan: PlanArrays, d: int, bits: int,
               scale_dtype=torch.bfloat16) -> tuple[int, int]:
    """(payload, error-compensation) bytes this plan's layout actually ships
    per exchange, totaled across partitions (alignment tails or pairwise
    padding included, the diagonal never)."""
    return comm_bytes(plan.wire_rows, d, bits, scale_dtype)
