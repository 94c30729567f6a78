"""GNN models: the paper's GCN, GraphSAGE and GAT (Sylvie §4), and PNA,
MeshGraphNet and SchNet of the JAX package's zoo.

Uniform contract, as in the JAX package::

    model.comm_dims()                    -> feature width at each exchange site
    model.apply(params, block, x, comm)  -> (P, n_local, d_out)
    model(block, x, comm)                -> the same with the module's own
                                            parameters (``param_tree()``)

``comm`` provides ``comm.halo(h)``; every layer calls it exactly once per
site, in ``comm_dims`` order. Parameters are named like the JAX parameter
tree (``layer0.w`` is ``params["layer0"]["w"]``; GAT's ``layer0.w.w`` is
``params["layer0"]["w"]["w"]``; an MLP's ``enc_node.l0.w`` is
``params["enc_node"]["l0"]["w"]``).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch
from torch import nn

import numpy as np

from ..nn import MLP, Linear, linear, mlp
from . import blocks as B


def elu(h: torch.Tensor) -> torch.Tensor:
    """ELU, with ``expm1`` taken in float64 and rounded to float32: PyTorch's
    CPU loop takes a tensor's last, partial vector with the scalar function,
    which may differ by an ulp from the vectorized one, so in float32 a
    row's value would depend on how many rows (partitions) the tensor
    holds; rounded from float64 it does not."""
    return torch.where(h > 0, h, torch.expm1(h.to(torch.float64))
                       .to(h.dtype))


class _Softplus(torch.autograd.Function):
    """JAX's ``softplus`` (``logaddexp(x, 0)``): ``max(x, 0) + log1p(exp(-|x|))``,
    not ``F.softplus`` with its threshold of 20; taken in float64 and
    rounded (see :func:`elu`). Gradient as JAX's ``logaddexp`` JVP: ``g *
    exp(x - y)``."""

    @staticmethod
    def forward(ctx, x):
        xd = x.to(torch.float64)
        y = (torch.clamp(xd, min=0.0) + torch.log1p(torch.exp(-xd.abs()))
             ).to(x.dtype)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp((x - y).to(torch.float64)).to(g.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def xla_linspace(stop: float, n: int) -> np.ndarray:
    """(n,) float32, bit for bit ``jnp.linspace(0, stop, n)`` as XLA
    computes it: ``stop * (i / (n - 1))`` with its constants folded, ``i *
    (stop * (1 / (n - 1)))`` in float32, and the last exactly ``stop``
    (``torch.linspace`` rounds from both ends)."""
    f32 = np.float32
    stop = f32(stop)
    if n == 1:
        return np.zeros(1, f32)
    out = np.arange(n - 1, dtype=f32) * (stop * (f32(1) / f32(n - 1)))
    return np.append(out, stop).astype(f32)


@lru_cache(maxsize=None)
def rbf_centers(stop: float, n: int, device: str) -> torch.Tensor:
    """:func:`xla_linspace` ``(stop, n)`` on ``device`` (copied once)."""
    return torch.as_tensor(xla_linspace(stop, n), device=device)


def param_tree(module: nn.Module) -> dict:
    """``module``'s parameters as the JAX tree: ``layer0.w`` ->
    ``{"layer0": {"w": ...}}``; a part of digits is an integer key, as in
    the JAX tree (NequIP's ``layer0.w_self.1`` -> ``{"w_self": {1:
    ...}}``)."""
    tree: dict = {}
    for name, param in module.named_parameters():
        *path, leaf = (int(k) if k.isdigit() else k for k in name.split("."))
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


def _module(**children) -> nn.Module:
    m = nn.Module()
    for name, child in children.items():
        m.add_module(name, child)
    return m


class PNA(_Model):
    """Principal Neighbourhood Aggregation [arXiv:2004.05718]: per layer a
    message ``relu(pre([src ; dst]))`` on every edge, the aggregators mean,
    max, min and std, each scaled by identity, amplification ``log(deg + 1)
    / delta`` and attenuation ``delta / log(deg + 1)``, then a residual
    ``relu(h + post(...))``. Parameters ``{"encoder", "layer{i}": {"pre",
    "post"}, "out"}``."""

    def __init__(self, d_in: int, d_hidden: int = 75, d_out: int = 0,
                 n_layers: int = 4, delta: float = 2.5, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.d_in, self.d_hidden, self.d_out = d_in, d_hidden, d_out
        self.n_layers, self.delta = n_layers, delta
        kw = dict(generator=generator, device=device)
        d = d_hidden
        self.add_module("encoder", Linear(d_in, d, **kw))
        for i in range(n_layers):
            self.add_module(f"layer{i}", _module(
                pre=Linear(2 * d, d, **kw), post=Linear(12 * d, d, **kw)))
        self.add_module("out", Linear(d, d_out, **kw))

    def comm_dims(self):
        return [self.d_hidden] * self.n_layers

    def apply(self, params: dict, block: B.GraphBlock, x: torch.Tensor,
              comm) -> torch.Tensor:
        h = torch.relu(linear(params["encoder"], x))
        # the in-degrees are constants: log1p in float64, rounded
        logd = torch.log1p(B.degrees(block).to(torch.float64)).to(
            h.dtype)[..., None]
        amp = logd / self.delta
        att = torch.full_like(logd, self.delta) / torch.clamp(logd, min=1e-6)
        for i in range(self.n_layers):
            lp = params[f"layer{i}"]
            table = B.halo_table(h, comm.halo(h))
            src = B.gather_src(block, table)
            dst = B.gather_dst(block, h)
            msg = torch.relu(linear(lp["pre"], torch.cat([src, dst], -1)))
            mx, mn = B.agg_max_min(block, msg)
            a = torch.cat([B.agg_mean_msgs(block, msg), mx, mn,
                           B.agg_std(block, msg)], -1)
            scaled = torch.cat([a, a * amp, a * att], -1)       # (P, n, 12d)
            h = torch.relu(h + linear(lp["post"], scaled))
        return linear(params["out"], h)


class MeshGraphNet(_Model):
    """Encode-process-decode with edge and node MLPs and residuals
    [arXiv:2010.03409], sum aggregation. ``block.edge_attr[..., :d_edge_in]``
    is ``[dist, unit_vec]`` (host-side geometry). Parameters ``{"enc_node",
    "enc_edge", "decoder", "proc{i}": {"edge", "node"}}``, each an MLP
    ``{"l0", "l1", ...}``."""

    def __init__(self, d_in: int, d_hidden: int = 128, d_out: int = 0,
                 n_layers: int = 15, mlp_layers: int = 2,
                 d_edge_in: int = 4, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.d_in, self.d_hidden, self.d_out = d_in, d_hidden, d_out
        self.n_layers, self.mlp_layers = n_layers, mlp_layers
        self.d_edge_in = d_edge_in
        kw = dict(generator=generator, device=device)
        d = d_hidden
        self.add_module("enc_node", MLP(self._mlp_dims(d_in), **kw))
        self.add_module("enc_edge", MLP(self._mlp_dims(d_edge_in), **kw))
        self.add_module("decoder", MLP([d, d, d_out], **kw))
        for i in range(n_layers):
            self.add_module(f"proc{i}", _module(
                edge=MLP(self._mlp_dims(3 * d), **kw),
                node=MLP(self._mlp_dims(2 * d), **kw)))

    def _mlp_dims(self, d_in: int) -> list:
        return [d_in] + [self.d_hidden] * self.mlp_layers

    def comm_dims(self):
        return [self.d_hidden] * self.n_layers

    def apply(self, params: dict, block: B.GraphBlock, x: torch.Tensor,
              comm) -> torch.Tensor:
        h = mlp(params["enc_node"], x)
        e = mlp(params["enc_edge"], block.edge_attr[..., :self.d_edge_in])
        for i in range(self.n_layers):
            lp = params[f"proc{i}"]
            table = B.halo_table(h, comm.halo(h))
            src = B.gather_src(block, table)
            dst = B.gather_dst(block, h)
            e = e + mlp(lp["edge"], torch.cat([e, src, dst], -1))
            agg = B.agg_sum(block, e)
            h = h + mlp(lp["node"], torch.cat([h, agg], -1))
        return mlp(params["decoder"], h)


class SchNet(_Model):
    """SchNet continuous-filter convolutions [arXiv:1706.08566]: filters
    from ``n_rbf`` Gaussian radial basis functions of the edge distance
    (``block.edge_attr[..., 0]``), the exchange of ``in(h)``, softplus
    (JAX's, :func:`softplus`). Parameters ``{"embed", "out", "int{i}":
    {"filter", "in", "dense1", "dense2"}}``."""

    def __init__(self, d_in: int, d_hidden: int = 64, d_out: int = 0,
                 n_interactions: int = 3, n_rbf: int = 300,
                 cutoff: float = 10.0, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.d_in, self.d_hidden, self.d_out = d_in, d_hidden, d_out
        self.n_interactions, self.n_rbf, self.cutoff = (n_interactions,
                                                        n_rbf, cutoff)
        kw = dict(generator=generator, device=device)
        d = d_hidden
        self.add_module("embed", Linear(d_in, d, **kw))
        self.add_module("out", MLP([d, d, d_out], **kw))
        for i in range(n_interactions):
            self.add_module(f"int{i}", _module(
                filter=MLP([n_rbf, d, d], **kw),
                **{"in": Linear(d, d, bias=False, **kw)},
                dense1=Linear(d, d, **kw), dense2=Linear(d, d, **kw)))

    def comm_dims(self):
        return [self.d_hidden] * self.n_interactions

    def centers(self) -> np.ndarray:
        """The RBF centers, :func:`xla_linspace` ``(cutoff, n_rbf)``."""
        return xla_linspace(self.cutoff, self.n_rbf)

    def _rbf(self, dist: torch.Tensor) -> torch.Tensor:
        centers = rbf_centers(self.cutoff, self.n_rbf, str(dist.device))
        gamma = 0.5 * (self.n_rbf / self.cutoff) ** 2
        z = -gamma * (dist[..., None] - centers) ** 2
        return torch.exp(z.to(torch.float64)).to(dist.dtype)

    def apply(self, params: dict, block: B.GraphBlock, x: torch.Tensor,
              comm) -> torch.Tensor:
        h = linear(params["embed"], x)
        rbf = self._rbf(block.edge_attr[..., 0])
        for i in range(self.n_interactions):
            lp = params[f"int{i}"]
            w = mlp(lp["filter"], rbf, act=softplus)            # (P, E, d)
            hin = linear(lp["in"], h)
            table = B.halo_table(hin, comm.halo(hin))
            agg = B.agg_sum(block, B.gather_src(block, table) * w)
            h = h + linear(lp["dense2"], softplus(linear(lp["dense1"], agg)))
        return mlp(params["out"], h, act=softplus)


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
