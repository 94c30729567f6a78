"""Staleness state for Sylvie-A + the Bounded Staleness Adaptor schedule.

``HaloState`` carries, per exchange site (one per GNN layer):

* ``feats[i]`` — the dequantized halo features received during the previous
  pass (the inference engine keeps it as its per-layer halo cache);
* ``grads[i]`` — the dequantized boundary gradients received during the
  previous step's backward pass (pre-scatter, in the halo buffer's layout).

Both are leaves of the training state: they checkpoint under the JAX
package's paths (``halo/feats/0``, ``halo/grads/0``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .exchange import PlanArrays


@dataclasses.dataclass
class HaloState:
    feats: tuple
    grads: tuple = ()

    @staticmethod
    def zeros(plan: PlanArrays, dims: Sequence[int], dtype=torch.float32,
              stacked_parts: Optional[int] = None, device=None) -> "HaloState":
        p = stacked_parts if stacked_parts is not None else plan.n_parts
        rows = plan.halo_rows
        feats = tuple(torch.zeros((p, rows, d), dtype=dtype, device=device)
                      for d in dims)
        return HaloState(feats=feats,
                         grads=tuple(torch.zeros_like(f) for f in feats))


def use_sync_step(epoch: int, eps_s: Optional[int]) -> bool:
    """Bounded Staleness Adaptor schedule (paper §3.3): one synchronous epoch
    every ``eps_s`` epochs (``None`` = pure Sylvie-A; 1 = always synchronous).
    Epoch 0 is always synchronous — it doubles as the cache warmup. The
    ``BoundedStaleness`` policy delegates here."""
    if epoch == 0:
        return True
    if eps_s is None:
        return False
    return epoch % eps_s == 0
