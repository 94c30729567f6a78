"""Halo-exchange backend (the paper's Communicator, §3.2): the simulated stack.

:class:`SimulatedBackend` keeps the whole partition stack ``(P, ...)`` on one
device and moves halo buffers by reindexing it:

* dense pairwise blocks ``(P, P*h_pad, ...)`` — ``exchange`` is the transpose
  ``out[p, q*h+s] = in[q, p*h+s]`` (an involution);
* compact ring buckets ``(P, sum(bucket_sizes), ...)`` — ``exchange_compact``
  moves bucket ``k`` from ``p`` to ``(p+k) % P`` (one ``torch.roll`` per
  bucket); ``reverse=True`` runs the inverted rings (backward communication).

Quantized exchanges move the payload and its error compensation (scale,
zero) together. ``psum`` is the identity (the stacked axis is already
global), ``fence`` lands an in-flight exchange (identity: PyTorch runs in
order on one stream) and ``axis_index`` is ``None`` (the whole stack is
present). A multi-process backend over ``torch.distributed`` is later work.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..core.quantization import QuantizedTensor


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


@dataclasses.dataclass(frozen=True)
class SimulatedBackend:
    """Stacked single-device semantics (``P`` partitions, one device).
    ``n_parts`` is optional metadata; the exchange reads ``P`` off the buffer."""

    n_parts: Optional[int] = None

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

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def fence(self, tree: Any) -> Any:
        return tree

    def axis_index(self) -> None:
        return None
