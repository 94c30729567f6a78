"""Per-site halo state.

``HaloState.feats[i]`` is the dequantized halo received at exchange site
``i`` during the previous pass; the inference engine keeps it as its
per-layer halo cache. (Training adds the received boundary gradients,
``grads``, with the Sylvie-A step.)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .exchange import PlanArrays


@dataclasses.dataclass
class HaloState:
    feats: tuple

    @staticmethod
    def zeros(plan: PlanArrays, dims: Sequence[int], dtype=torch.float32,
              stacked_parts: int | None = None, device=None) -> "HaloState":
        p = stacked_parts if stacked_parts is not None else plan.n_parts
        rows = plan.halo_rows
        return HaloState(feats=tuple(
            torch.zeros((p, rows, d), dtype=dtype, device=device)
            for d in dims))
