"""Parameter trees <-> the port's parameters.

The JAX package keeps parameters as nested dicts
(``{"layer0": {"w": (d_in, d_out), "b": (d_out,)}, ...}``). The port keeps
the GNN's in ``nn.Module``s whose parameter names follow the same path
(``layer0.w``; GraphSAGE's ``layer0.self.w`` / ``layer0.nb.w``, GAT's
``layer0.w.w`` / ``layer0.a_src`` / ``out.b``; NequIP's ``layer0.w_self.0``
for the JAX tree's integer key ``0``), and the LM's in a nested
dict of tensors with the JAX tree's keys. These functions carry weights across, so both packages can run on the
same numbers.
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
