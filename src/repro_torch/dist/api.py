"""Which parts of a GNN run are replicated and which are stacked, as slicing
— the counterpart of the reference's spec derivation (``repro.dist.api``:
``gnn_state_specs``, ``gnn_block_spec``, ``gnn_data_spec``,
``device_put_gnn``).

Under a multi-process runtime every rank runs the same trainer on its own
slice ``[r:r+1]`` of every stacked array — what one partition sees inside
the reference's ``shard_map``, where the leading axis has local size 1:

* **replicated**: model parameters, optimizer state,
  the step counter, the EF21 state and the all-reduced per-site stats;
  every rank holds the whole of them, and every rank's step keeps them
  equal (the gradients are all-reduced before the optimizer);
* **stacked** (:data:`STACKED`, plus the graph block and the per-node
  arrays x / y / masks): the halo caches and the epoch's fault masks; rank
  ``r`` holds ``[r:r+1]``.

A checkpoint stores the whole stack in either runtime: :func:`gather_state`
gathers the stacked leaves back (``all_gather``, a collective every rank
joins), :func:`slice_state` takes a rank's slice of a restored one.

Serving (``repro_torch.serve.engine``) slices the same way: a rank holds the
features of its partition (:func:`serve_data`) and its halo caches, and
:func:`gather_stacked` brings a stacked result (the logits, the cached
embeddings) back to the whole stack. Rank 0 leads the lockstep of the
serving ranks: :func:`broadcast_command` sends each operation to the others
before it runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..train.optimizer import tree_map

# the GNNTrainState fields that are stacked (the others are replicated)
STACKED = ("halo", "faults")
# PartitionedGraph arrays a rank slices: features, labels and masks
DATA = ("x", "y", "train_mask", "val_mask", "test_mask")


def local_slice(a, rank: Optional[int]):
    """Rank ``rank``'s ``[r:r+1]`` of a stacked array (``None``: all)."""
    return a if rank is None else a[rank:rank + 1]


def gnn_data(pg, rank: Optional[int], device) -> tuple:
    """``(x, y, train_mask, val_mask, test_mask)`` of ``rank``'s partition
    (all of them for ``None``) as tensors on ``device``."""
    return tuple(torch.as_tensor(local_slice(np.asarray(getattr(pg, k)),
                                             rank), device=device)
                 for k in DATA)


def serve_data(pg, rank: Optional[int], device) -> torch.Tensor:
    """The float32 features of ``rank``'s partition (all of them for
    ``None``) as a tensor on ``device``, copied: the serving engine writes
    feature updates into it."""
    x = local_slice(np.asarray(pg.x, dtype=np.float32), rank)
    return torch.tensor(x, device=device)


def slice_state(state, rank: Optional[int]):
    """A whole-stack training state -> ``rank``'s: the stacked fields
    sliced, the replicated ones kept."""
    if rank is None:
        return state
    return dataclasses.replace(state, **{
        f: tree_map(lambda a: local_slice(a, rank), getattr(state, f))
        for f in STACKED})


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(wire)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts).to(t.dtype)


def gather_stacked(t: torch.Tensor, group) -> torch.Tensor:
    """A rank's ``(1, ...)`` slice of a stacked array -> the whole stack
    ``(P, ...)`` in rank order (a collective: every rank of ``group`` calls
    it, and gets the result)."""
    if t.shape[0] != 1:
        raise ValueError("a process holds one partition: expected a "
                         f"(1, ...) slice, got {tuple(t.shape)}")
    return _all_gather(t, group)


def broadcast_command(command, group):
    """Rank 0 of ``group`` sends ``command`` (a picklable object, the serving
    engine's ``(op, args)``); every rank returns it (the others pass
    ``None``). A collective: every rank of ``group`` calls it."""
    import torch.distributed as dist
    box = [command]
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def gather_state(state, group):
    """A rank's training state -> the whole stack's: every ``(1, ...)``
    stacked leaf gathered to ``(P, ...)`` in rank order (a collective:
    every rank of ``group`` calls it, and gets the result)."""
    return dataclasses.replace(state, **{
        f: tree_map(lambda a: _all_gather(a, group), getattr(state, f))
        for f in STACKED})
