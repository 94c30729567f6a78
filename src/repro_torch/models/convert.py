"""Parameter trees <-> module parameters.

The JAX package keeps parameters as nested dicts
(``{"layer0": {"w": (d_in, d_out), "b": (d_out,)}, ...}``); the port keeps
them in ``nn.Module``s whose parameter names follow the same path
(``layer0.w``). These two functions carry weights across, so both packages
can run on the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def params_from_numpy(model: nn.Module, tree: dict, device=None) -> nn.Module:
    """Copy a nested dict of arrays into ``model``'s parameters (in place) and
    move the model to ``device`` when given. Raises ``KeyError`` on a missing
    leaf and ``ValueError`` on a shape mismatch."""
    for name, param in model.named_parameters():
        node = tree
        for part in name.split("."):
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
    tree: dict = {}
    for name, param in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = param.detach().cpu().numpy()
    return tree
