"""The tracer's default device clock: CUDA timing events.

Loaded by :mod:`.spans` at the first span given a CUDA device, so that
importing :mod:`repro_torch.obs` never imports ``torch``. A mark is a
``torch.cuda.Event(enable_timing=True)`` recorded on the device's current
stream (inside ``torch.cuda.stream(side)`` the side stream's; in an
autograd backward the stream of its forward); two marks are compared with
``elapsed_time`` once both have completed, which the tracer's drain makes
sure of.
"""
from __future__ import annotations

import torch


class CudaClock:
    """CUDA events as the device clock of :class:`~.spans.DeviceTimer`."""

    def times(self, device) -> bool:
        return getattr(device, "type", None) == "cuda"

    def key(self, device) -> int:
        """The card's index (``cuda`` and ``cuda:0`` are one card)."""
        index = torch.device(device).index
        return torch.cuda.current_device() if index is None else index

    def synchronize(self, device) -> None:
        torch.cuda.synchronize(device)

    def record(self, device) -> torch.cuda.Event:
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event

    def elapsed(self, a: torch.cuda.Event, b: torch.cuda.Event) -> float:
        return a.elapsed_time(b) * 1e-3
