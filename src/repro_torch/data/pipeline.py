"""Host-side data pipeline: background prefetch, the synthetic token stream
and the synthetic Criteo stream, as ``repro/data/pipeline.py``.

``Prefetcher`` overlaps host batch construction with device compute: a
background thread pulls host batches (numpy arrays, or tuples, lists and
dicts of them), copies each array into pinned host memory and from there to
the device with ``non_blocking=True``, and keeps at most ``depth`` finished
batches in a bounded queue. The copies run on the device's default stream,
the stream the consumer computes on, so a batch is ready before any kernel
that reads it. On the CPU the arrays become tensors without a copy of
their own. The error contract is the reference's: every batch the producer
finished is delivered in order, then its error is raised once, then
``StopIteration``.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..dist.runtime import resolve_device


def to_device(batch, device: torch.device):
    """``batch`` with every numpy array a tensor on ``device`` and every
    tensor moved there (pinned and copied without blocking on CUDA), also
    inside dataclasses (DLRM's ``IdPlan``); other leaves pass through."""
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if torch.is_tensor(batch):
        if device.type == "cuda" and batch.device.type == "cpu":
            batch = batch.pin_memory().to(device, non_blocking=True)
        return batch.to(device)
    if dataclasses.is_dataclass(batch) and not isinstance(batch, type):
        return dataclasses.replace(batch, **{
            f.name: to_device(getattr(batch, f.name), device)
            for f in dataclasses.fields(batch)})
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    return batch


class Prefetcher:
    """Wrap a host-batch iterator; keeps ``depth`` batches ready on
    ``device`` (``None``: the CUDA card, as every entry point of the port;
    ``"cpu"`` for the CPU)."""

    def __init__(self, it: Iterator, depth: int = 2, device=None):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._finished = False

        def work():
            try:
                if dev.type == "cuda":      # the thread's current device
                    torch.cuda.set_device(dev)
                for batch in it:
                    self._q.put(to_device(batch, self.device))
            except BaseException as e:       # surfaced on the next __next__
                self._err = e
            finally:
                self._q.put(self._done)

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:               # don't block on the drained queue
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._finished = True
            if self._err is not None:
                # the producer died mid-stream: every batch it finished was
                # delivered above; the error surfaces exactly once here
                # (generator semantics: a later next() is StopIteration)
                raise self._err
            raise StopIteration
        return item


def token_stream(vocab: int, batch: int, seq: int, seed: int = 0,
                 n_batches: Optional[int] = None):
    """Synthetic LM batches: (tokens, labels), int32 (batch, seq), with a
    learnable bigram bias (labels = tokens shifted; every even position
    repeats the one before it), so a few hundred steps show a real loss
    drop. The reference's arrays for the same arguments."""
    rng = np.random.default_rng(seed)
    i = 0
    while n_batches is None or i < n_batches:
        base = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
        base[:, 2::2] = base[:, 1:-1:2]
        yield base[:, :-1], base[:, 1:]
        i += 1


def criteo_stream(cfg, batch: int, seed: int = 0,
                  n_batches: Optional[int] = None):
    """Synthetic Criteo-like batches for DLRM: ``(dense, flat_ids, label)``
    with dense (batch, n_dense) float32 normals, flat ids (batch *
    total_ids,) int32 drawn per field as ``pareto(1.5) % size`` (numpy's
    Lomax: id 0 of every table takes ~64.6% of the draws) plus the field's
    row offset, and labels from a hidden linear model of the dense
    features, so that training converges. The reference's arrays for the
    same arguments."""
    rng = np.random.default_rng(seed)
    offs = cfg.row_offsets
    w = rng.normal(0, 1, cfg.n_dense)
    i = 0
    while n_batches is None or i < n_batches:
        dense = rng.normal(0, 1, (batch, cfg.n_dense)).astype(np.float32)
        ids = []
        for f, h in enumerate(cfg.hots):
            size = int(offs[f + 1] - offs[f])
            r = rng.pareto(1.5, (batch, h)).astype(np.int64) % size
            ids.append(offs[f] + r)
        flat = np.concatenate(ids, axis=1).reshape(-1).astype(np.int32)
        label = (dense @ w + rng.normal(0, 0.5, batch) > 0).astype(np.float32)
        yield dense, flat, label
        i += 1
