"""Optimizers over parameter trees (SGD/momentum, Adam, AdamW) and
global-norm clipping, as ``repro.train.optimizer`` computes them.

Parameters, gradients and optimizer state are nested dicts (tuples allowed)
of float32 tensors with the JAX package's keys, not ``torch.optim`` state, so
a checkpoint carries over between the two packages. The arithmetic is the
reference's, in its order and in float32: Adam's bias corrections are
``1 - b1 ** t`` with ``t`` cast to float32, and its step is
``m / bc1 / (sqrt(v / bc2) + eps)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, tuples and dataclasses
    (``rest`` shaped like ``tree``); dict keys in sorted order, as
    ``jax.tree`` walks them. ``None`` is an empty subtree (no leaves), as in
    ``jax.tree``: a fault-free state's ``faults``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def global_norm(tree) -> torch.Tensor:
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    n = global_norm(grads)
    scale = torch.minimum(torch.ones_like(n),
                          max_norm / torch.clamp(n, min=1e-9))
    return tree_map(lambda g: g * scale, grads), n


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None):
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), state
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        return tree_map(lambda m: -lr * m, new_m), new_m

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        leaf = tree_leaves(params)[0]
        return {"m": z, "v": tree_map(torch.zeros_like, z),
                "t": torch.zeros((), dtype=torch.int32, device=leaf.device)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_
                     + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full_like(tf, b1), tf)
        bc2 = 1 - torch.pow(torch.full_like(tf, b2), tf)

        def upd(m_, v_, p):
            step = m_ / bc1 / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(torch.float32)
            return (-lr * step).to(p.dtype)

        updates = tree_map(upd, m, v, params if params is not None
                           else tree_map(torch.zeros_like, m))
        return updates, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def adamw(lr: float, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
