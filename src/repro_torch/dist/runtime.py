"""The Runtime facade: one object that fixes the execution mode and the device.

    Runtime.simulated(n_parts=4)                 # whole stack on the CUDA card
    Runtime.simulated(n_parts=4, device="cpu")   # plain PyTorch versions, CPU
    Runtime.sharded(4)                           # one partition per process
    Runtime.sharded(4, device="cuda:0")          # ... all on one card (gloo)

``Runtime.sharded`` (and ``Runtime.from_process_group``) is the
multi-process runtime, the counterpart of the reference's
``Runtime.from_mesh``: it runs inside a process of an initialized
``torch.distributed`` group (``dist.spawn`` starts one), holds partition
``rank`` and exchanges over a
:class:`~repro_torch.dist.backend.ProcessGroupBackend`.

The device is decided here and nowhere else (:func:`resolve_device`, which
the LM entry point uses too): ``device=None`` means ``torch.device("cuda")``
(``cuda:<LOCAL_RANK>`` for a sharded runtime), and asking for CUDA without a
card raises — nothing falls back to the CPU quietly.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch

from .. import obs
from ..train.optimizer import tree_map
from . import api
from .backend import HaloBackend, ProcessGroupBackend, SimulatedBackend


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

    backend: HaloBackend
    device: torch.device

    @staticmethod
    def simulated(n_parts: Optional[int] = None, device=None) -> "Runtime":
        """Whole partition stack in one program on one device.

        ``Runtime.simulated(4)`` commits to 4 partitions on the CUDA card;
        ``Runtime.simulated()`` accepts any partitioned graph."""
        dev = resolve_device(device)
        return Runtime(SimulatedBackend(n_parts), dev)

    @staticmethod
    def from_process_group(group=None, device=None) -> "Runtime":
        """One partition per process of ``group`` (``None``: the default
        group, as ``Runtime.sharded`` passes), this process holding
        partition ``rank``. ``device=None`` is ``cuda:<LOCAL_RANK>``."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "Runtime.sharded needs an initialized torch.distributed "
                "group: run the program in repro_torch.dist.spawn.spawn "
                "(one process per partition)")
        if device is None:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        return Runtime(ProcessGroupBackend(group), resolve_device(device))

    @staticmethod
    def sharded(n_parts: Optional[int] = None, device=None) -> "Runtime":
        """One partition per process of the default group, which must exist
        (``dist.spawn`` makes it) and, when ``n_parts`` is given, have that
        many processes."""
        rt = Runtime.from_process_group(None, device)
        if n_parts is not None and n_parts != rt.n_parts:
            raise ValueError(f"Runtime.sharded({n_parts}) in a group of "
                             f"{rt.n_parts} processes: one partition per "
                             "process")
        return rt

    @property
    def is_sharded(self) -> bool:
        """One partition per process (the stack is sliced)?"""
        return self.rank is not None

    @property
    def rank(self) -> Optional[int]:
        """This process's partition; ``None`` when the whole stack is here."""
        return self.backend.axis_index()

    @property
    def n_parts(self) -> Optional[int]:
        """Partition count this runtime is committed to (None = any)."""
        return self.backend.n_parts

    def stacked_parts(self, n_parts: int) -> int:
        """Rows of a stacked array's leading axis under this runtime."""
        return 1 if self.is_sharded else n_parts

    def device_put_gnn(self, state):
        """A whole-stack training state -> this runtime's: moved to the
        device and, sharded, its stacked fields sliced to this rank (the
        replicated ones kept whole). The counterpart of the reference's
        ``device_put_gnn`` for the state alone: the block is built for the
        rank by ``build_block(pg, device, part=rank)`` and the per-node
        arrays by ``dist.api.gnn_data``."""
        return self.place(api.slice_state(state, self.rank))

    def gather_state(self, state):
        """This runtime's training state -> the whole stack's (a collective
        under a sharded runtime; the identity otherwise)."""
        if not self.is_sharded:
            return state
        return api.gather_state(state, self.backend.group)

    def gather_stacked(self, *tensors: torch.Tensor) -> tuple:
        """This runtime's slices of stacked tensors -> the whole stack's,
        in rank order: under a sharded runtime an ``all_gather`` of each
        (a collective every rank joins), recorded together as the ``obs``
        span ``gather``; the identity otherwise."""
        if not self.is_sharded:
            return tensors
        with obs.span("gather"):
            return tuple(api.gather_stacked(t, self.backend.group)
                         for t in tensors)

    def shard_serve_fn(self, sweep_fn: Callable) -> Callable:
        """The inference-engine sweep for this runtime: a plain call (PyTorch
        runs eagerly; the simulated stack needs no sharding)."""
        return sweep_fn

    def place(self, tree):
        """A tree (nested dicts, tuples, dataclasses) of arrays or tensors as
        tensors on this runtime's device, dtypes kept."""
        return tree_map(lambda a: torch.as_tensor(a, device=self.device),
                        tree)
