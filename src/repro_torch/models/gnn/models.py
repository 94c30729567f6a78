"""GNN models (the paper's GCN; GraphSAGE and GAT are not ported yet).

Uniform contract, as in the JAX package::

    model.comm_dims()                    -> feature width at each exchange site
    model.apply(params, block, x, comm)  -> (P, n_local, d_out)
    model(block, x, comm)                -> the same with the module's own
                                            parameters (``param_tree()``)

``comm`` provides ``comm.halo(h)``; every layer calls it exactly once per
site, in ``comm_dims`` order. Parameters are named like the JAX parameter
tree (``layer0.w`` is ``params["layer0"]["w"]``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn import Linear, linear
from . import blocks as B


class GCN(nn.Module):
    """Kipf-Welling GCN, Alg. 1 form: H^{l} = sigma(A_hat^T H~^{l-1} W^{l}).
    Each layer aggregates with one SpMM over the stack (``blocks.aggregate``)."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, n_layers: int = 2,
                 *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.d_in, self.d_hidden, self.d_out = d_in, d_hidden, d_out
        self.n_layers = n_layers
        dims = [d_in] + [d_hidden] * (n_layers - 1) + [d_out]
        for i in range(n_layers):
            self.add_module(f"layer{i}", Linear(dims[i], dims[i + 1],
                                                generator=generator,
                                                device=device))

    def comm_dims(self):
        return [self.d_in] + [self.d_hidden] * (self.n_layers - 1)

    def param_tree(self) -> dict:
        """The parameters as the JAX tree ``{"layer0": {"w", "b"}, ...}``."""
        return {f"layer{i}": dict(getattr(self, f"layer{i}").named_parameters())
                for i in range(self.n_layers)}

    def apply(self, params: dict, block: B.GraphBlock, x: torch.Tensor,
              comm) -> torch.Tensor:
        h = x
        for i in range(self.n_layers):
            table = B.halo_table(h, comm.halo(h))
            h = linear(params[f"layer{i}"], B.aggregate(block, table))
            if i < self.n_layers - 1:
                h = torch.relu(h)
        return h

    def forward(self, block: B.GraphBlock, x: torch.Tensor, comm) -> torch.Tensor:
        return self.apply(self.param_tree(), block, x, comm)
