"""GNN models: the paper's GCN, GraphSAGE and GAT (Sylvie §4).

Uniform contract, as in the JAX package::

    model.comm_dims()                    -> feature width at each exchange site
    model.apply(params, block, x, comm)  -> (P, n_local, d_out)
    model(block, x, comm)                -> the same with the module's own
                                            parameters (``param_tree()``)

``comm`` provides ``comm.halo(h)``; every layer calls it exactly once per
site, in ``comm_dims`` order. Parameters are named like the JAX parameter
tree (``layer0.w`` is ``params["layer0"]["w"]``; GAT's ``layer0.w.w`` is
``params["layer0"]["w"]["w"]``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn import Linear, linear
from . import blocks as B


def elu(h: torch.Tensor) -> torch.Tensor:
    """ELU, with ``expm1`` taken in float64 and rounded to float32: PyTorch's
    CPU loop takes a tensor's last, partial vector with the scalar function,
    which may differ by an ulp from the vectorized one, so in float32 a
    row's value would depend on how many rows (partitions) the tensor
    holds; rounded from float64 it does not."""
    return torch.where(h > 0, h, torch.expm1(h.to(torch.float64))
                       .to(h.dtype))


def param_tree(module: nn.Module) -> dict:
    """``module``'s parameters as the JAX tree: ``layer0.w`` ->
    ``{"layer0": {"w": ...}}``."""
    tree: dict = {}
    for name, param in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = param
    return tree


class _Model(nn.Module):
    def param_tree(self) -> dict:
        """The parameters as the JAX tree (``{"layer0": {"w", "b"}, ...}``)."""
        return param_tree(self)

    def forward(self, block: B.GraphBlock, x: torch.Tensor, comm
                ) -> torch.Tensor:
        return self.apply(self.param_tree(), block, x, comm)


class GCN(_Model):
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

    def apply(self, params: dict, block: B.GraphBlock, x: torch.Tensor,
              comm) -> torch.Tensor:
        h = x
        for i in range(self.n_layers):
            table = B.halo_table(h, comm.halo(h))
            h = linear(params[f"layer{i}"], B.aggregate(block, table))
            if i < self.n_layers - 1:
                h = torch.relu(h)
        return h


class GraphSAGE(_Model):
    """SAGE-mean: h' = sigma(W_self h + W_nb mean_{u in N(v)} h_u), the mean
    as the unit-weight SpMM over the stack (``blocks.agg_mean``). Parameters
    ``{"layer{i}": {"self": {"w", "b"}, "nb": {"w"}}}``."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, n_layers: int = 2,
                 *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.d_in, self.d_hidden, self.d_out = d_in, d_hidden, d_out
        self.n_layers = n_layers
        dims = [d_in] + [d_hidden] * (n_layers - 1) + [d_out]
        for i in range(n_layers):
            layer = nn.Module()
            layer.add_module("self", Linear(dims[i], dims[i + 1],
                                            generator=generator,
                                            device=device))
            layer.add_module("nb", Linear(dims[i], dims[i + 1], bias=False,
                                          generator=generator, device=device))
            self.add_module(f"layer{i}", layer)

    def comm_dims(self):
        return [self.d_in] + [self.d_hidden] * (self.n_layers - 1)

    def apply(self, params: dict, block: B.GraphBlock, x: torch.Tensor,
              comm) -> torch.Tensor:
        h = x
        for i in range(self.n_layers):
            lp = params[f"layer{i}"]
            agg = B.agg_mean(block, B.halo_table(h, comm.halo(h)))
            h = linear(lp["self"], h) + linear(lp["nb"], agg)
            if i < self.n_layers - 1:
                h = torch.relu(h)
        return h


class GAT(_Model):
    """Multi-head GAT. The exchange carries the *projected* features
    ``hw = h @ w`` (width H*dh); the scores use the split form ``a = [a_src ;
    a_dst]``, so each side is a local dot product, and every layer
    aggregates through ``blocks.gat_aggregate``. ELU between layers, then
    the ``out`` linear. Parameters ``{"layer{i}": {"w": {"w"}, "a_src",
    "a_dst"}, "out": {"w", "b"}}``, ``a_*`` shaped (H, dh)."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, n_layers: int = 2,
                 heads: int = 4, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.d_in, self.d_hidden, self.d_out = d_in, d_hidden, d_out
        self.n_layers, self.heads = n_layers, heads
        d = d_in
        for i in range(n_layers):
            layer = nn.Module()
            layer.add_module("w", Linear(d, heads * d_hidden, bias=False,
                                         generator=generator, device=device))
            for name in ("a_src", "a_dst"):
                a = torch.randn((heads, d_hidden), generator=generator) * 0.1
                layer.register_parameter(name, nn.Parameter(a.to(device)))
            self.add_module(f"layer{i}", layer)
            d = heads * d_hidden
        self.add_module("out", Linear(d, d_out, generator=generator,
                                      device=device))

    def comm_dims(self):
        return [self.d_hidden * self.heads] * self.n_layers

    def apply(self, params: dict, block: B.GraphBlock, x: torch.Tensor,
              comm) -> torch.Tensor:
        h = x
        nh, dh = self.heads, self.d_hidden
        for i in range(self.n_layers):
            lp = params[f"layer{i}"]
            hw = linear(lp["w"], h)                        # (P, n, H*dh)
            table = B.halo_table(hw, comm.halo(hw))
            # the scores as a product and a sum over each row's dh: a row's
            # bits do not depend on how many rows (partitions) the tensor
            # holds, as an einsum's batched product's do
            s_src = (table.reshape(table.shape[:-1] + (nh, dh))
                     * lp["a_src"]).sum(-1)
            s_dst = (hw.reshape(hw.shape[:-1] + (nh, dh))
                     * lp["a_dst"]).sum(-1)
            h = B.gat_aggregate(block, table, s_src, s_dst)
            if i < self.n_layers - 1:
                h = elu(h)
        return linear(params["out"], h)


# The paper's three architectures at the reference's benchmark widths
# (``repro.models.gnn.models.PAPER_ARCHS``: GCN and GraphSAGE 64 x 2, GAT 4
# heads x 16, 2 layers). The scenario runner and the chaos harness resolve
# "gcn" / "graphsage" / "gat" through it, so a port report and a reference
# report of one cell are one model. (The registry's ``configs/paper_gnn.py``
# holds the paper's own widths, 256 and 4 x 64.) Keywords (``generator=``,
# ``device=``) go to the constructor.
PAPER_ARCHS = {
    "gcn": lambda d_in, d_out, **kw: GCN(d_in, 64, d_out, n_layers=2, **kw),
    "graphsage": lambda d_in, d_out, **kw: GraphSAGE(d_in, 64, d_out,
                                                     n_layers=2, **kw),
    "gat": lambda d_in, d_out, **kw: GAT(d_in, 16, d_out, n_layers=2,
                                         heads=4, **kw),
}
