"""NequIP: E(3)-equivariant interatomic-potential GNN [arXiv:2101.03164], as
``repro.models.gnn.nequip`` computes it.

Published config: 5 layers, hidden multiplicity 32, l_max = 2, 8 radial
basis functions, cutoff 5. Node features are the irreps 32x0e + 32x1o +
32x2e stored flat (width 32 * (1 + 3 + 5) = 288, each l's block laid out
(mul, 2l+1)); each interaction layer:

  1. halo-exchanges the flat irrep features (the wire format Sylvie
     quantizes: one scale and one zero a row, so at 1 bit the exchange mixes
     the l blocks and is not equivariant, as in the reference);
  2. takes the per-edge tensor product h_u (x) Y(r_uv) over every coupled
     (l1, l2, l3) path (:func:`tensor_product`, the Gaunt tensors of
     ``so3``), weighted by a radial MLP of the edge length's RBF with a
     smooth cosine cutoff envelope;
  3. sums the messages onto the destinations (one ``agg_sum`` over the flat
     (E, width) messages: each column sums in the same CSR order as three
     calls of widths mul, 3 mul and 5 mul would), then the per-l
     self-interaction (mul-mixing linears);
  4. gates: SiLU on the scalars; the l > 0 irreps scaled by sigmoids of a
     linear of the scalars.

``block.edge_attr`` carries ``[dist(1), unit(3), sh(9)]`` computed on the
host on the global graph (``blocks.geometry_edge_attr``). A self-loop has
``unit = 0`` and so a fixed, non-rotating ``Y_20``: with self-loops the
model is not rotation-invariant, in the reference as here. SiLU, the
sigmoid, the envelope's cosine and the RBF's exponential are taken in
float64 and rounded to float32, so that a row's bits do not depend on how
many rows (partitions) a tensor holds (see ``models.elu``). Parameters
``{"embed", "out", "layer{i}": {"radial": {"l0", "l1"}, "gate", "w_self":
{0, 1, 2}, "w_agg": {0, 1, 2}}}`` (integer keys, as in the JAX tree).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import torch
from torch import nn

from ..nn import MLP, Linear, linear, mlp
from . import blocks as B
from . import so3
from .models import _Model, rbf_centers


def _l_slice(l: int, mul: int) -> slice:
    start = sum(mul * (2 * k + 1) for k in range(l))
    return slice(start, start + mul * (2 * l + 1))


def split_irreps(h: torch.Tensor, mul: int, l_max: int) -> dict:
    """flat (..., mul * (l_max+1)^2) -> {l: (..., mul, 2l+1)} views."""
    return {l: h[..., _l_slice(l, mul)].reshape(h.shape[:-1]
                                                + (mul, 2 * l + 1))
            for l in range(l_max + 1)}


def flat_irreps(parts: dict) -> torch.Tensor:
    """{l: (..., mul, 2l+1)} -> flat (..., mul * (l_max+1)^2)."""
    return torch.cat([parts[l].reshape(parts[l].shape[:-2] + (-1,))
                      for l in range(len(parts))], dim=-1)


def _f64(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` taken in float64 and rounded to ``x``'s dtype."""
    return fn(x.to(torch.float64)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return _f64(lambda v: v * torch.sigmoid(v), x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _f64(torch.sigmoid, x)


@lru_cache(maxsize=None)
def _gaunt_tensors(paths: tuple, device: str) -> tuple:
    """The Gaunt tensor of each path, on ``device`` (copied once)."""
    return tuple(torch.as_tensor(so3.gaunt(*p), device=device)
                 for p in paths)


def tensor_product(src: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                   mul: int, paths) -> torch.Tensor:
    """The per-edge tensor product, weighted: the reference's
    ``einsum("abc,peua,peb->peuc", C, src_l[l1], Y_l2) * w[..., pi, :,
    None]`` for each coupled path ``pi = (l1, l2, l3)`` in ``paths``' order,
    summed into ``msg[l3]`` in that order.

    ``src`` (..., mul * (l_max+1)^2) flat irreps of each edge's source,
    ``sh`` (..., (l_max+1)^2) the edge's real SH, ``w`` (..., len(paths) *
    mul) the radial weights -> the flat (..., mul * (l_max+1)^2) messages.
    Each path contracts the Gaunt tensor with the edge's ``Y_l2`` first
    (``(2l1+1) x (2l3+1)`` an edge), then multiplies the source's
    ``(mul, 2l1+1)`` block by it."""
    l_max = max(p[2] for p in paths)
    src_l = split_irreps(src, mul, l_max)
    w = w.reshape(w.shape[:-1] + (len(paths), mul))
    msg: dict = {}
    for pi, (c, (l1, l2, l3)) in enumerate(zip(
            _gaunt_tensors(tuple(paths), str(src.device)), paths)):
        y = sh[..., so3.sh_slice(l2)]                        # (..., b)
        t = torch.einsum("abc,...b->...ac", c, y)            # (..., a, c)
        m = torch.matmul(src_l[l1], t) * w[..., pi, :, None]  # (.., mul, c)
        msg[l3] = m if l3 not in msg else msg[l3] + m
    return flat_irreps(msg)


class NequIP(_Model):
    """The reference's ``NequIP`` (its fields, ``comm_dims``, ``paths``,
    ``width``) with the port's parameters: glorot linears (``embed``,
    ``out``, the radial MLP, ``gate``) and ``w_self`` / ``w_agg`` drawn
    normal x ``1 / sqrt(mul)``, from ``generator``."""

    def __init__(self, d_in: int, d_out: int = 0, mul: int = 32,
                 n_layers: int = 5, l_max: int = 2, n_rbf: int = 8,
                 cutoff: float = 5.0, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.d_in, self.d_out, self.mul = d_in, d_out, mul
        self.n_layers, self.l_max = n_layers, l_max
        self.n_rbf, self.cutoff = n_rbf, cutoff
        kw = dict(generator=generator, device=device)
        self.add_module("embed", Linear(d_in, mul, **kw))
        self.add_module("out", Linear(mul, d_out, **kw))
        scale = 1.0 / math.sqrt(mul)
        for i in range(n_layers):
            layer = nn.Module()
            layer.add_module("radial", MLP([n_rbf, mul,
                                            len(self.paths) * mul], **kw))
            for name in ("w_self", "w_agg"):
                mix = nn.Module()
                for l in range(l_max + 1):
                    t = torch.randn((mul, mul), generator=generator) * scale
                    mix.register_parameter(str(l),
                                           nn.Parameter(t.to(device)))
                layer.add_module(name, mix)
            layer.add_module("gate", Linear(mul, l_max * mul, **kw))
            self.add_module(f"layer{i}", layer)

    @property
    def width(self) -> int:
        return self.mul * (self.l_max + 1) ** 2

    @property
    def paths(self) -> list:
        ls = tuple(range(self.l_max + 1))
        return so3.coupled_paths(ls, ls, ls)

    def comm_dims(self):
        return [self.width] * self.n_layers

    def _rbf(self, dist: torch.Tensor) -> torch.Tensor:
        centers = rbf_centers(self.cutoff, self.n_rbf, str(dist.device))
        gamma = 0.5 * (self.n_rbf / self.cutoff) ** 2
        env = 0.5 * (_f64(torch.cos, math.pi * torch.clamp(
            dist / self.cutoff, 0, 1)) + 1.0)
        z = -gamma * (dist[..., None] - centers) ** 2
        return _f64(torch.exp, z) * env[..., None]

    def apply(self, params: dict, block: B.GraphBlock, x: torch.Tensor,
              comm) -> torch.Tensor:
        mul, l_max = self.mul, self.l_max
        scal = linear(params["embed"], x)                    # (P, n, mul)
        h = torch.cat([scal, scal.new_zeros(scal.shape[:-1]
                                            + (self.width - mul,))], -1)
        dist = block.edge_attr[..., 0]
        sh = block.edge_attr[..., 4:4 + (l_max + 1) ** 2]   # (P, E, 9)
        rbf = self._rbf(dist)
        paths = self.paths
        for i in range(self.n_layers):
            lp = params[f"layer{i}"]
            table = B.halo_table(h, comm.halo(h))
            src = B.gather_src(block, table)                 # (P, E, width)
            w = mlp(lp["radial"], rbf, act=silu)             # (P, E, 11 mul)
            agg = split_irreps(B.agg_sum(
                block, tensor_product(src, sh, w, mul, paths)), mul, l_max)
            h_l = split_irreps(h, mul, l_max)
            out = {l: (agg[l].transpose(-1, -2) @ lp["w_agg"][l]
                       + h_l[l].transpose(-1, -2) @ lp["w_self"][l]
                       ).transpose(-1, -2)
                   for l in range(l_max + 1)}                # (P, n, mul, m)
            scal = silu(out[0][..., 0])                      # (P, n, mul)
            gates = sigmoid(linear(lp["gate"], scal))
            gated = {0: scal[..., None]}
            for l in range(1, l_max + 1):
                g = gates[..., (l - 1) * mul: l * mul]
                gated[l] = out[l] * g[..., None]
            h = flat_irreps(gated)
        return linear(params["out"], h[..., :mul])
