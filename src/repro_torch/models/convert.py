"""Parameter trees <-> the port's parameters.

The JAX package keeps parameters as nested dicts
(``{"layer0": {"w": (d_in, d_out), "b": (d_out,)}, ...}``). The port keeps
the GNN's in ``nn.Module``s whose parameter names follow the same path
(``layer0.w``; GraphSAGE's ``layer0.self.w`` / ``layer0.nb.w``, GAT's
``layer0.w.w`` / ``layer0.a_src`` / ``out.b``; NequIP's ``layer0.w_self.0``
for the JAX tree's integer key ``0``), and the LM's in a nested
dict of tensors with the JAX tree's keys, DLRM's as a dense dict
(``{"bot": {"l0": {"w", "b"}, ...}, "top": ...}``) and its table. These
functions carry weights across, so both packages can run on the same
numbers.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .gnn.models import param_tree
from .lm.model import param_shapes, tree_leaves


def params_from_numpy(model: nn.Module, tree: dict, device=None) -> nn.Module:
    """Copy a nested dict of arrays into ``model``'s parameters (in place) and
    move the model to ``device`` when given. Raises ``KeyError`` on a missing
    leaf and ``ValueError`` on a shape mismatch."""
    for name, param in model.named_parameters():
        node = tree
        for part in name.split("."):
            if isinstance(node, dict) and part not in node \
                    and part.isdigit():
                part = int(part)           # the JAX tree's integer keys
            if not isinstance(node, dict) or part not in node:
                raise KeyError(f"parameter tree has no leaf "
                               f"{name.replace('.', '/')!r}")
            node = node[part]
        arr = np.asarray(node)
        if arr.shape != tuple(param.shape):
            raise ValueError(f"parameter {name.replace('.', '/')!r} has shape "
                             f"{arr.shape}, model expects {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.tensor(arr, dtype=param.dtype))
    if device is not None:
        model.to(device)
    return model


def params_to_numpy(model: nn.Module) -> dict:
    """``model``'s parameters as a nested dict of numpy arrays."""
    return lm_params_to_numpy(param_tree(model))


def lm_params_from_numpy(tree: dict, cfg, device=None, dtype=None) -> dict:
    """The JAX LM parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, init_params(...))``) -> the port's parameter
    dict on ``device``, in ``dtype`` (default: each array's own; bfloat16
    arrays stay bfloat16). An MoE router stays float32 whatever ``dtype``
    says, as in the reference's model of any dtype. Raises ``KeyError`` on
    a missing or unexpected key and ``ValueError`` on a shape mismatch."""
    want = dict(tree_leaves(param_shapes(cfg)))
    have = dict(tree_leaves(tree))
    for path in sorted(set(want) | set(have)):
        name = "/".join(path)
        if path not in have:
            raise KeyError(f"parameter tree has no leaf {name!r}")
        if path not in want:
            raise KeyError(f"parameter tree has a leaf {name!r} that "
                           f"{cfg.name} does not have")
        if tuple(np.shape(have[path])) != want[path]:
            raise ValueError(f"parameter {name!r} has shape "
                             f"{np.shape(have[path])}, {cfg.name} expects "
                             f"{want[path]}")
    out: dict = {}
    for path, arr in have.items():
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":     # ml_dtypes' bfloat16
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))        # a writable copy
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        want_dtype = torch.float32 if path[-1] == "router" else dtype
        node[path[-1]] = t.to(device=device, dtype=want_dtype or t.dtype)
    return out


def lm_params_to_numpy(params: dict) -> dict:
    """The port's LM (or any) parameter dict as a nested dict of numpy arrays
    (bfloat16 tensors come out as float32, which holds them exactly)."""
    def conv(t: torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return {k: lm_params_to_numpy(v) if isinstance(v, dict) else conv(v)
            for k, v in params.items()}


def _check_keys(node, want, where: str) -> None:
    """Raise ``KeyError`` unless ``node`` is a dict with exactly the keys
    ``want`` (``where`` is its path, ending in ``/``)."""
    have = node if isinstance(node, dict) else {}
    for key in sorted(set(want) | set(have)):
        if key not in have:
            raise KeyError(f"parameter tree has no leaf {where + key!r}")
        if key not in want:
            raise KeyError(f"parameter tree has a leaf {where + key!r} that "
                           f"DLRM does not have")


def _mlp_widths(tree, name: str) -> list:
    """The widths ``[d_in, d_1, ..., d_out]`` of the MLP tree ``tree``
    (``{"l0": {"w", "b"}, ...}``); raises ``KeyError`` on a missing or
    unexpected key and ``ValueError`` on a shape that breaks the chain."""
    n = len(tree) if isinstance(tree, dict) else 0
    _check_keys(tree, [f"l{i}" for i in range(max(n, 1))], f"{name}/")
    widths: list = []
    for i in range(n):
        where = f"{name}/l{i}/"
        _check_keys(tree[f"l{i}"], ("w", "b"), where)
        w, b = (np.shape(tree[f"l{i}"][k]) for k in ("w", "b"))
        if len(w) != 2 or (widths and w[0] != widths[-1]):
            raise ValueError(f"parameter {where}w has shape {w}, expected "
                             f"({widths[-1] if widths else 'd_in'}, d_out)")
        if b != (w[1],):
            raise ValueError(f"parameter {where}b has shape {b}, expected "
                             f"{(w[1],)}")
        widths = (widths or [w[0]]) + [w[1]]
    return widths


def dlrm_params_from_numpy(dense_tree: dict, table, device=None):
    """The JAX DLRM's dense tree and table as numpy arrays -> the port's
    ``(dense_params, table)`` on ``device``. Every key and shape is
    checked: the tree holds exactly ``bot`` and ``top``, MLPs whose widths
    chain; ``top`` ends in one logit and reads ``d + F (F - 1) / 2``
    features for the table's width ``d`` (the bottom MLP's output) and
    some ``F >= 2``. Raises ``KeyError`` on a missing or unexpected key and
    ``ValueError`` on a shape mismatch."""
    _check_keys(dense_tree, ("bot", "top"), "")
    bot = _mlp_widths(dense_tree["bot"], "bot")
    top = _mlp_widths(dense_tree["top"], "top")
    d = bot[-1]
    if np.ndim(table) != 2 or np.shape(table)[1] != d:
        raise ValueError(f"table has shape {np.shape(table)}, expected "
                         f"(rows, {d}) (the bottom MLP's width)")
    pairs = top[0] - d
    f = int(round((1 + (1 + 8 * max(pairs, 0)) ** 0.5) / 2))
    if top[-1] != 1 or f < 2 or f * (f - 1) // 2 != pairs:
        raise ValueError(f"the top MLP reads {top[0]} features and writes "
                         f"{top[-1]}: expected {d} + F (F - 1) / 2 in and "
                         f"1 out")

    def conv(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    dense = {k: {lk: {leaf: conv(v) for leaf, v in layer.items()}
                 for lk, layer in dense_tree[k].items()}
             for k in ("bot", "top")}
    return dense, conv(table)


def dlrm_params_to_numpy(dense_params: dict, table: torch.Tensor):
    """The port's DLRM parameters -> ``(dense tree, table)`` of numpy
    arrays, as the JAX package keeps them."""
    return lm_params_to_numpy(dense_params), \
        table.detach().cpu().numpy()
