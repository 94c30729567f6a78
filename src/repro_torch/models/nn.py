"""Minimal layer library with the JAX reference's parameter layout.

A linear layer is ``x @ w + b`` with ``w`` shaped ``(d_in, d_out)`` — not
``torch.nn.Linear``'s ``(out, in)`` — so a parameter tree
``{"layer0": {"w": ..., "b": ...}}`` and a checkpoint carry over between the
two packages unchanged (``models/convert.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn


def glorot(shape, generator: Optional[torch.Generator] = None
           ) -> torch.Tensor:
    """Glorot-uniform in [-lim, lim), lim = sqrt(6 / (fan_in + fan_out)),
    drawn on the CPU from ``generator``."""
    fan_in, fan_out = shape[-2], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return (u * 2.0 - 1.0) * lim


def linear_init(d_in: int, d_out: int, bias: bool = True,
                generator: Optional[torch.Generator] = None) -> dict:
    p = {"w": glorot((d_in, d_out), generator)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


class Linear(nn.Module):
    """:func:`linear` with its parameters ``w`` (d_in, d_out) and ``b``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        for name, t in linear_init(d_in, d_out, bias, generator).items():
            self.register_parameter(name, nn.Parameter(t.to(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(dict(self.named_parameters()), x)


def mlp_init(dims: Sequence[int],
             generator: Optional[torch.Generator] = None) -> dict:
    """``{"l0": {"w", "b"}, "l1": ...}``: one linear layer per pair of
    neighbouring ``dims``."""
    return {f"l{i}": linear_init(dims[i], dims[i + 1], True, generator)
            for i in range(len(dims) - 1)}


def mlp(p: dict, x: torch.Tensor, act: Callable = torch.relu
        ) -> torch.Tensor:
    """``p``'s linear layers in order, ``act`` between them."""
    n = len(p)
    for i in range(n):
        x = linear(p[f"l{i}"], x)
        if i < n - 1:
            x = act(x)
    return x


class MLP(nn.Module):
    """:func:`mlp_init`'s tree as parameters (``l0.w``, ``l0.b``, ...); a
    model applies them with :func:`mlp`."""

    def __init__(self, dims: Sequence[int],
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        for name, p in mlp_init(dims, generator).items():
            layer = nn.Module()
            for k, t in p.items():
                layer.register_parameter(k, nn.Parameter(t.to(device)))
            self.add_module(name, layer)


def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalize the last axis to zero mean and unit variance (no affine)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def rms_norm(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
             eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x)`` over the last axis (the mean square in float32), times
    ``gamma`` when given."""
    var = (x.to(torch.float32) ** 2).mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y if gamma is None else y * gamma


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked cross entropy as ``(sum_loss, count)``, so callers can sum both
    across partitions before dividing."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = (logz - ll) * mask
    return ce.sum(), mask.sum()


def accuracy_counts(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(correct predictions, count) over ``mask``."""
    pred = torch.argmax(logits, dim=-1)
    return ((pred == labels) * mask).sum(), mask.sum()
