"""Planted RA104: a tensor made at import time."""
import torch

IDENTITY = torch.zeros(4)         # RA104: allocates on import


def apply(x):
    return IDENTITY + x
