"""The census of one call: what it sent through the halo backend, which
``torch.distributed`` collectives it made and which kernels it launched.

The port runs eagerly, so where the reference traces an entry point to a
jaxpr and walks it (``repro.analysis.jaxpr_checks.summarize``), the census
records what one call actually does, at three seams:

1. the :class:`~repro_torch.dist.backend.HaloBackend` methods, through
   :class:`CountingBackend` (one :class:`BackendEvent` per call: method,
   ``reverse``, ``bucket_sizes`` and each array's dtype and shape;
   ``issue_quantized`` and ``fence`` are events of their own);
2. the ``torch.distributed`` collectives of :data:`COLLECTIVES`, wrapped
   for the length of the call by :func:`collectives` (one
   :class:`CollectiveEvent` each: name, dtype, shape, ``async_op``, input
   and output splits); only calls made through the ``torch.distributed``
   module are seen, as the port makes them;
3. every kernel's ``Kernel.launches`` before and after, on CUDA.

:func:`census` does all three and fills a :class:`Census`, which compares
with ``==``. ``ProcessGroupBackend`` sends each array of a compact exchange
as one ``all_to_all_single`` with uneven splits, where the reference sends
one ``ppermute`` per ring bucket; :func:`shift_census` reads each bucket's
ring shift and rows back from the splits, the counterpart of the
reference's ``expected_shift_census`` fingerprint.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import inspect
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from ..dist.backend import HaloBackend
from ..dist.runtime import resolve_device

# the backend methods that move one raw array, and those that move a
# quantized tensor's arrays (payload, and scale and zero where not empty)
RAW_METHODS = ("exchange", "exchange_compact")
QUANTIZED_METHODS = ("exchange_quantized", "exchange_quantized_compact",
                     "issue_quantized")
# the torch.distributed collectives the census wraps
COLLECTIVES = ("all_to_all_single", "all_reduce", "all_gather", "broadcast",
               "broadcast_object_list")
# the argument that carries the tensor a collective sends
_SENT = {"all_to_all_single": "input", "all_reduce": "tensor",
         "all_gather": "tensor", "broadcast": "tensor"}

Array = tuple[str, tuple[int, ...]]      # (dtype name, shape)


def _array(t: torch.Tensor) -> Array:
    return str(t.dtype).removeprefix("torch."), tuple(t.shape)


@dataclasses.dataclass(frozen=True)
class BackendEvent:
    """One call of a halo-backend method. ``arrays`` are the arrays it moves
    (a quantized tensor's empty scale and zero move nothing and are left
    out); ``reverse`` is ``None`` where the method has no direction."""

    method: str
    reverse: Optional[bool] = None
    bucket_sizes: Optional[tuple[int, ...]] = None
    arrays: tuple[Array, ...] = ()


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One ``torch.distributed`` collective. ``dtype`` / ``shape`` are the
    sent tensor's (``None`` for ``broadcast_object_list``); the splits are
    ``all_to_all_single``'s, ``None`` for equal splits."""

    name: str
    dtype: Optional[str] = None
    shape: Optional[tuple[int, ...]] = None
    async_op: bool = False
    in_splits: Optional[tuple[int, ...]] = None
    out_splits: Optional[tuple[int, ...]] = None


@dataclasses.dataclass
class Census:
    """What one call did: its backend events, its collectives and, on CUDA,
    each kernel's launches during it (``(name, launches)`` for every
    kernel of the port, empty on the CPU)."""

    backend: list = dataclasses.field(default_factory=list)
    collectives: list = dataclasses.field(default_factory=list)
    launches: list = dataclasses.field(default_factory=list)

    def methods(self, *names: str) -> list:
        return [e for e in self.backend if e.method in names]

    def calls(self, *names: str) -> list:
        return [e for e in self.collectives if e.name in names]

    def launched(self) -> dict:
        """``{kernel: launches}`` of the kernels that launched."""
        return {k: n for k, n in self.launches if n}


def _qt_arrays(qt) -> tuple[Array, ...]:
    return tuple(_array(t) for t in (qt.data, qt.scale, qt.zero)
                 if t.numel())


def _ints(xs) -> Optional[tuple[int, ...]]:
    return None if xs is None else tuple(int(x) for x in xs)


@dataclasses.dataclass(frozen=True)
class CountingBackend:
    """A delegating :class:`HaloBackend` (in the style of
    ``faults.FaultyBackend``) that records one :class:`BackendEvent` per
    method call in ``events`` and then hands the call to ``base``
    unchanged. ``side_stream`` and ``axis_index`` are not events."""

    base: HaloBackend
    events: list = dataclasses.field(default_factory=list, compare=False,
                                     repr=False)

    @property
    def n_parts(self):
        return self.base.n_parts

    def _log(self, method: str, arrays=(), reverse=None, bucket_sizes=None):
        self.events.append(BackendEvent(method, reverse,
                                        _ints(bucket_sizes),
                                        tuple(arrays)))

    def exchange(self, buf):
        self._log("exchange", (_array(buf),))
        return self.base.exchange(buf)

    def exchange_compact(self, buf, bucket_sizes, reverse=False):
        self._log("exchange_compact", (_array(buf),), bool(reverse),
                  bucket_sizes)
        return self.base.exchange_compact(buf, bucket_sizes, reverse=reverse)

    def exchange_quantized(self, qt):
        self._log("exchange_quantized", _qt_arrays(qt))
        return self.base.exchange_quantized(qt)

    def exchange_quantized_compact(self, qt, bucket_sizes, reverse=False):
        self._log("exchange_quantized_compact", _qt_arrays(qt),
                  bool(reverse), bucket_sizes)
        return self.base.exchange_quantized_compact(qt, bucket_sizes,
                                                    reverse=reverse)

    def issue_quantized(self, qt, bucket_sizes=None, reverse=False):
        self._log("issue_quantized", _qt_arrays(qt),
                  None if bucket_sizes is None else bool(reverse),
                  bucket_sizes)
        return self.base.issue_quantized(qt, bucket_sizes, reverse=reverse)

    def fence(self, tree):
        self._log("fence")
        return self.base.fence(tree)

    def psum(self, x):
        self._log("psum", (_array(x),))
        return self.base.psum(x)

    def side_stream(self, device):
        return self.base.side_stream(device)

    def axis_index(self):
        return self.base.axis_index()


def _recorder(name: str, real, log: list):
    sig = inspect.signature(real)

    def call(*args, **kwargs):
        a = sig.bind(*args, **kwargs).arguments
        t = a.get(_SENT.get(name, ""))
        log.append(CollectiveEvent(
            name, *(_array(t) if torch.is_tensor(t) else (None, None)),
            async_op=bool(a.get("async_op", False)),
            in_splits=_ints(a.get("input_split_sizes")),
            out_splits=_ints(a.get("output_split_sizes"))))
        return real(*args, **kwargs)
    return call


@contextlib.contextmanager
def collectives(log: list) -> Iterator[list]:
    """Record in ``log`` every collective of :data:`COLLECTIVES` called
    through the ``torch.distributed`` module while the block runs; the real
    functions are restored on exit."""
    real = {n: getattr(dist, n) for n in COLLECTIVES}
    for n, fn in real.items():
        setattr(dist, n, _recorder(n, fn, log))
    try:
        yield log
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)


def kernels() -> dict:
    """Every kernel of the port (``kernels.build.Kernel``), by name."""
    from ..kernels.build import Kernel
    from ..kernels.flash import ops as flash_ops
    from ..kernels.gat import ops as gat_ops
    from ..kernels.quant import ops as quant_ops
    from ..kernels.seg import ops as seg_ops
    from ..kernels.spmm import ops as spmm_ops
    return {k.name: k for m in (quant_ops, spmm_ops, gat_ops, flash_ops,
                                seg_ops)
            for k in vars(m).values() if isinstance(k, Kernel)}


@contextlib.contextmanager
def census(*backends: CountingBackend, device=None) -> Iterator[Census]:
    """The census of the block: ``backends``' events (cleared on entry),
    its collectives and, on CUDA, its kernel launches, in the
    :class:`Census` yielded (filled on exit). ``device`` is the device the
    block runs on: ``None`` means CUDA, and without a card that raises."""
    dev = resolve_device(device)
    out = Census()
    for b in backends:
        b.events.clear()
    table = kernels() if dev.type == "cuda" else {}
    before = {n: k.launches for n, k in table.items()}
    with collectives(out.collectives):
        yield out
    out.backend.extend(e for b in backends for e in b.events)
    out.launches.extend((n, k.launches - before[n]) for n, k in table.items())


def shift_census(c: Census, rank: int, n_parts: int) -> collections.Counter:
    """The multiset of ``((d - rank) % n_parts, rows)`` over every
    ``all_to_all_single`` input split to a rank ``d != rank`` that is not
    empty: each compact bucket's ring shift and rows, as the reference's
    ``expected_shift_census`` counts them (self-splits and empty buckets
    never reach the wire)."""
    out: collections.Counter = collections.Counter()
    for e in c.calls("all_to_all_single"):
        for d, rows in enumerate(e.in_splits or ()):
            if d != rank and rows:
                out[((d - rank) % n_parts, rows)] += 1
    return out
