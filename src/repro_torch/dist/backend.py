"""Halo-exchange backends (the paper's Communicator, §3.2), behind the
:class:`HaloBackend` protocol, as ``repro.dist.backend``.

Two backends speak the same two buffer layouts:

* :class:`SimulatedBackend` keeps the whole partition stack ``(P, ...)`` on
  one device and moves halo buffers by reindexing it;
* :class:`ProcessGroupBackend` is one partition per process over
  ``torch.distributed`` (the counterpart of the reference's
  ``ShardMapBackend``): every process holds its own slice ``[r:r+1]`` of the
  stack, the leading axis of size 1 that one partition sees inside
  ``jax.shard_map``.

The layouts:

* dense pairwise blocks ``(P, P*h_pad, ...)`` — ``exchange`` is the transpose
  ``out[p, q*h+s] = in[q, p*h+s]`` (an involution): a reshape on the stack,
  one tiled ``all_to_all_single`` across processes;
* compact ring buckets ``(P, sum(bucket_sizes), ...)`` — ``exchange_compact``
  moves bucket ``k`` from ``p`` to ``(p+k) % P`` (one ``torch.roll`` per
  bucket on the stack; one ``all_to_all_single`` with uneven splits across
  processes); ``reverse=True`` runs the inverted rings (backward
  communication).

Quantized exchanges move the payload and its error compensation (scale,
zero) together. ``psum`` is the all-reduce of Alg. 2 line 16: the identity
on the stack (the stacked axis is already global), an ``all_reduce`` across
processes whose transpose is the identity (its output is replicated).
``axis_index`` is ``None`` on the stack (the whole stack is present) and the
rank across processes.

The overlap schedule (``dist/overlap.py``) issues an exchange on a side
CUDA stream that the backend owns (``side_stream``, one per device) and gets
an :class:`Inflight` back from ``issue_quantized``; ``fence`` lands it: the
consuming stream waits on the event the side stream recorded (and, across
processes, on the collective's ``Work``), and the received tensors are
marked as used there (``record_stream``), so the caching allocator cannot
hand their memory to the side stream while the consumer still reads it. On
the CPU there is no event.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import torch
import torch.distributed as dist

from ..core.quantization import QuantizedTensor


@runtime_checkable
class HaloBackend(Protocol):
    """What the Sylvie runtime needs from a communicator (the reference's
    protocol, less its jit-era ``device_put`` / ``shard``: placement is the
    runtime's, and PyTorch runs eagerly).

    * ``exchange(buf)`` — the halo all-to-all on a pairwise-blocked buffer
      ``(P_local, P*h_pad, ...)``; an involution;
    * ``exchange_compact(buf, bucket_sizes, reverse)`` — the ragged ring
      exchange on a compacted buffer ``(P_local, sum(bucket_sizes), ...)``;
    * ``exchange_quantized(qt)`` / ``exchange_quantized_compact(qt, ...)`` —
      payload and error compensation together;
    * ``issue_quantized(qt, bucket_sizes, reverse)`` — start a quantized
      exchange and return an :class:`Inflight` (``bucket_sizes`` ``None``:
      dense); ``fence(tree)`` lands every :class:`Inflight` in ``tree``;
    * ``side_stream(device)`` — the CUDA stream overlapped exchanges run on;
    * ``psum(x)`` — all-reduce across partitions (Alg. 2 line 16), with the
      identity as its transpose;
    * ``axis_index()`` — this process's partition, or ``None`` when the
      whole stack is present."""

    def exchange(self, buf: torch.Tensor) -> torch.Tensor: ...

    def exchange_compact(self, buf: torch.Tensor,
                         bucket_sizes: tuple[int, ...],
                         reverse: bool = False) -> torch.Tensor: ...

    def exchange_quantized(self, qt: QuantizedTensor) -> QuantizedTensor: ...

    def exchange_quantized_compact(self, qt: QuantizedTensor,
                                   bucket_sizes: tuple[int, ...],
                                   reverse: bool = False
                                   ) -> QuantizedTensor: ...

    def issue_quantized(self, qt: QuantizedTensor,
                        bucket_sizes: Optional[tuple[int, ...]] = None,
                        reverse: bool = False) -> "Inflight": ...

    def fence(self, tree: Any) -> Any: ...

    def side_stream(self, device) -> torch.cuda.Stream: ...

    def psum(self, x: torch.Tensor) -> torch.Tensor: ...

    def axis_index(self) -> Optional[int]: ...


def _exchange_quantized(exch: Callable, qt: QuantizedTensor) -> QuantizedTensor:
    return QuantizedTensor(
        data=exch(qt.data),
        scale=exch(qt.scale) if qt.scale.numel() else qt.scale,
        zero=exch(qt.zero) if qt.zero.numel() else qt.zero,
        bits=qt.bits, feat_dim=qt.feat_dim)


def _bucket_slices(bucket_sizes: tuple[int, ...]):
    """(ring offset k, start, stop) for each non-empty bucket."""
    out, start = [], 0
    for k, b in enumerate(bucket_sizes):
        if b:
            out.append((k, start, start + b))
        start += b
    return out


@dataclasses.dataclass
class Inflight:
    """An issued halo exchange: the received payload (across processes, the
    raw receive buffers until :meth:`land`), and what landing waits for —
    on CUDA the event the side stream recorded after enqueueing the
    exchange, across processes the collectives' ``Work`` handles and the
    reordering of the received rows (``finish``). On the CPU of the
    simulated stack there is nothing to wait for."""

    qt: QuantizedTensor
    event: Optional[torch.cuda.Event] = None
    works: tuple = ()
    finish: Optional[Callable[[QuantizedTensor], QuantizedTensor]] = None

    def land(self) -> "Inflight":
        """Wait for the exchange on the current stream and return it landed:
        the ``Work`` handles waited on (gloo blocks the host here until the
        staged copy has arrived; the current stream then waits for the
        copy to the card), the side stream's event waited on, the received
        tensors recorded on the current stream; then, if the rows need
        reordering, a new :class:`Inflight` of them in order (else this
        one)."""
        for w in self.works:
            w.wait()
        qt = self.qt
        if self.event is not None:
            stream = torch.cuda.current_stream(qt.data.device)
            stream.wait_event(self.event)
            for t in (qt.data, qt.scale, qt.zero):
                if t.numel():
                    t.record_stream(stream)
        return self if self.finish is None else Inflight(self.finish(qt))


def _fence(tree: Any) -> Any:
    """Land every :class:`Inflight` in ``tree`` (one, or a tuple)."""
    if isinstance(tree, tuple):
        return tuple(x.land() if isinstance(x, Inflight) else x for x in tree)
    return tree.land() if isinstance(tree, Inflight) else tree


def _side_stream(cache: dict, device) -> torch.cuda.Stream:
    dev = torch.device(device)
    if dev not in cache:
        cache[dev] = torch.cuda.Stream(dev)
    return cache[dev]


@dataclasses.dataclass(frozen=True)
class SimulatedBackend:
    """Stacked single-device semantics (``P`` partitions, one device).
    ``n_parts`` is optional metadata; the exchange reads ``P`` off the buffer.
    ``_side`` holds the side stream of each device, made at first use."""

    n_parts: Optional[int] = None
    _side: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    def exchange(self, buf: torch.Tensor) -> torch.Tensor:
        p = buf.shape[0]
        h = buf.shape[1] // p
        y = buf.reshape((p, p, h) + tuple(buf.shape[2:])).transpose(0, 1)
        return y.reshape((p, p * h) + tuple(buf.shape[2:]))

    def exchange_compact(self, buf: torch.Tensor,
                         bucket_sizes: tuple[int, ...],
                         reverse: bool = False) -> torch.Tensor:
        """Bucket k rolls k partitions forward (out[p] = in[(p-k) % P]), or
        backward when reversed."""
        parts = [torch.roll(buf[:, s0:s1], -k if reverse else k, dims=0)
                 for k, s0, s1 in _bucket_slices(bucket_sizes)]
        return torch.cat(parts, dim=1) if parts else buf

    def exchange_quantized(self, qt: QuantizedTensor) -> QuantizedTensor:
        return _exchange_quantized(self.exchange, qt)

    def exchange_quantized_compact(self, qt: QuantizedTensor,
                                   bucket_sizes: tuple[int, ...],
                                   reverse: bool = False) -> QuantizedTensor:
        return _exchange_quantized(
            lambda b: self.exchange_compact(b, bucket_sizes, reverse), qt)

    def issue_quantized(self, qt: QuantizedTensor,
                        bucket_sizes: Optional[tuple[int, ...]] = None,
                        reverse: bool = False) -> Inflight:
        """The exchange, enqueued on the current stream (a reindexing of the
        stack has nothing to wait for but its stream)."""
        if bucket_sizes is None:
            return Inflight(self.exchange_quantized(qt))
        return Inflight(self.exchange_quantized_compact(qt, bucket_sizes,
                                                        reverse))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def side_stream(self, device) -> torch.cuda.Stream:
        """The side CUDA stream of ``device`` that overlapped exchanges are
        issued on (one per device, made at first use)."""
        return _side_stream(self._side, device)

    def fence(self, tree: Any) -> Any:
        """Land every :class:`Inflight` in ``tree`` (one, or a tuple): the
        current stream waits on its event and its received tensors are
        recorded on that stream. Identity on values."""
        return _fence(tree)

    def axis_index(self) -> None:
        return None


class _ReplicatedSum(torch.autograd.Function):
    """``all_reduce(SUM)`` whose output is replicated: the cotangent of a
    replicated value is itself replicated, so the transpose is the identity
    (the reference's ``_rep_psum``). ``torch.distributed.nn``'s all-reduce
    transposes to another all-reduce and would count weight gradients P
    times."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True)
class ProcessGroupBackend:
    """One partition per process of ``group`` (``None``: the default
    group), rank ``r`` holding partition ``r`` — the counterpart of the
    reference's ``ShardMapBackend``. Every buffer is the process's slice
    ``(1, rows, ...)`` of the stack.

    * ``exchange``: one tiled ``all_to_all_single`` over the ``P*h_pad``
      rows (equal splits: block ``q`` goes to rank ``q``).
    * ``exchange_compact``: **one** ``all_to_all_single`` with uneven splits
      for all the buckets. Bucket ``k`` goes to ``(r+k) % P`` (``(r-k) % P``
      reversed), a different rank for each ``k``, so the buckets placed at
      their destination ranks are the collective's input splits; the rows
      received, in source-rank order, are put back in bucket order. The
      reference runs one ``ppermute`` per bucket; one collective here costs
      one launch and one host-staged copy per exchange instead of ``P - 1``,
      which is what a host-staged ``gloo`` exchange pays for. It uses no
      ``send`` / ``recv``: ``gloo`` stages a CUDA tensor through the host
      for its collectives, while its ``send`` hands the tensor's device
      pointer to the TCP transport as it is.
    * ``psum``: :class:`_ReplicatedSum`; ``axis_index``: the rank.
    * ``issue_quantized``: the same collectives with ``async_op=True``; the
      :class:`Inflight` carries their ``Work`` handles, and ``fence`` waits
      on them. With ``gloo`` that wait blocks the host until the staged copy
      has landed.

    ``gloo`` and ``nccl`` both serve: which one is the process group's
    (``dist.spawn``'s caller chooses)."""

    group: Any = None
    _side: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    @property
    def n_parts(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    def _start(self, buf: torch.Tensor, bucket_sizes, reverse: bool,
               async_op: bool):
        """Start one exchange of this process's ``(1, rows, ...)`` buffer:
        ``(received rows, Work or None, finish)`` with ``finish`` mapping the
        received rows to the ``(1, rows, ...)`` result. A buffer without
        elements (the same on every rank) moves nothing."""
        if buf.shape[0] != 1:
            raise ValueError("a process holds one partition: expected a "
                             f"(1, ...) buffer, got {tuple(buf.shape)}")
        x = buf[0]
        if x.numel() == 0:
            return x, None, lambda o: o[None]
        if bucket_sizes is None:
            x = x.contiguous()
            out = torch.empty_like(x)
            work = dist.all_to_all_single(out, x, group=self.group,
                                          async_op=async_op)
            return out, work, lambda o: o[None]
        p, r = self.n_parts, self.rank
        sizes = tuple(int(b) for b in bucket_sizes)
        if len(sizes) != p:
            raise ValueError(f"{len(sizes)} ring buckets for {p} ranks")
        start = (0,) + tuple(itertools.accumulate(sizes))
        sign = -1 if reverse else 1
        # rank d receives bucket (sign*(d-r)) % P from here; the rows from
        # rank s are its bucket (sign*(r-s)) % P
        send = [(sign * (d - r)) % p for d in range(p)]
        recv = [(sign * (r - s)) % p for s in range(p)]
        x = torch.cat([x[start[k]:start[k + 1]] for k in send])
        out_splits = [sizes[k] for k in recv]
        off = (0,) + tuple(itertools.accumulate(out_splits))
        out = x.new_empty((off[-1],) + tuple(x.shape[1:]))
        work = dist.all_to_all_single(out, x, out_splits,
                                      [sizes[k] for k in send],
                                      group=self.group, async_op=async_op)
        order = [(r - sign * k) % p for k in range(p)]

        def finish(o):
            return torch.cat([o[off[s]:off[s + 1]] for s in order])[None]

        return out, work, finish

    def _exchange(self, buf, bucket_sizes, reverse) -> torch.Tensor:
        out, _, finish = self._start(buf, bucket_sizes, reverse, False)
        return finish(out)

    def exchange(self, buf: torch.Tensor) -> torch.Tensor:
        return self._exchange(buf, None, False)

    def exchange_compact(self, buf: torch.Tensor,
                         bucket_sizes: tuple[int, ...],
                         reverse: bool = False) -> torch.Tensor:
        return self._exchange(buf, bucket_sizes, reverse)

    def exchange_quantized(self, qt: QuantizedTensor) -> QuantizedTensor:
        return _exchange_quantized(self.exchange, qt)

    def exchange_quantized_compact(self, qt: QuantizedTensor,
                                   bucket_sizes: tuple[int, ...],
                                   reverse: bool = False) -> QuantizedTensor:
        return _exchange_quantized(
            lambda b: self.exchange_compact(b, bucket_sizes, reverse), qt)

    def issue_quantized(self, qt: QuantizedTensor,
                        bucket_sizes: Optional[tuple[int, ...]] = None,
                        reverse: bool = False) -> Inflight:
        """Start the payload's and scale/zero's collectives asynchronously;
        ``fence`` waits for them and reorders the received rows."""
        started = {name: self._start(t, bucket_sizes, reverse, True)
                   for name, t in (("data", qt.data), ("scale", qt.scale),
                                   ("zero", qt.zero)) if t.numel()}
        raw = dataclasses.replace(
            qt, **{name: out for name, (out, _, _) in started.items()})

        def finish(q: QuantizedTensor) -> QuantizedTensor:
            return dataclasses.replace(q, **{
                name: fin(getattr(q, name))
                for name, (_, _, fin) in started.items()})

        works = tuple(w for _, w, _ in started.values() if w is not None)
        return Inflight(raw, works=works, finish=finish)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return _ReplicatedSum.apply(x, self.group)

    def side_stream(self, device) -> torch.cuda.Stream:
        return _side_stream(self._side, device)

    def fence(self, tree: Any) -> Any:
        return _fence(tree)

    def axis_index(self) -> int:
        return self.rank


def as_backend(b: Any) -> HaloBackend:
    """Normalize a communicator designator to a backend: ``None`` ->
    :class:`SimulatedBackend`; a backend passes through."""
    if b is None:
        return SimulatedBackend()
    if not isinstance(b, HaloBackend):
        raise TypeError(f"not a HaloBackend: {b!r} (pass a backend, or None "
                        "for the simulated stack)")
    return b
