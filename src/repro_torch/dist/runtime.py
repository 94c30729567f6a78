"""The Runtime facade: one object that fixes the execution mode and the device.

    Runtime.simulated(n_parts=4)                 # whole stack on the CUDA card
    Runtime.simulated(n_parts=4, device="cpu")   # plain PyTorch versions, CPU

The device is decided here and nowhere else (:func:`resolve_device`, which
the LM entry point uses too): ``device=None`` means ``torch.device("cuda")``,
and asking for CUDA without a card raises — nothing falls back to the CPU
quietly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..train.optimizer import tree_map
from .backend import SimulatedBackend


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA; without a card
    that raises unless the caller asks for ``"cpu"``. On CUDA, float32
    products run in full float32 (the JAX reference's precision): TF32 is
    turned off for matmul and cuDNN."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution-mode facade: a backend + the device it runs on."""

    backend: SimulatedBackend
    device: torch.device

    @staticmethod
    def simulated(n_parts: Optional[int] = None, device=None) -> "Runtime":
        """Whole partition stack in one program on one device.

        ``Runtime.simulated(4)`` commits to 4 partitions on the CUDA card;
        ``Runtime.simulated()`` accepts any partitioned graph."""
        dev = resolve_device(device)
        return Runtime(SimulatedBackend(n_parts), dev)

    @property
    def n_parts(self) -> Optional[int]:
        """Partition count this runtime is committed to (None = any)."""
        return self.backend.n_parts

    def shard_serve_fn(self, sweep_fn: Callable) -> Callable:
        """The inference-engine sweep for this runtime: a plain call (PyTorch
        runs eagerly; the simulated stack needs no sharding)."""
        return sweep_fn

    def place(self, tree):
        """A tree (nested dicts, tuples, dataclasses) of arrays or tensors as
        tensors on this runtime's device, dtypes kept."""
        return tree_map(lambda a: torch.as_tensor(a, device=self.device),
                        tree)
