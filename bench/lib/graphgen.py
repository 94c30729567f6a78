"""The graph of a configuration, by its generator's name: each generator is
``bench/graphs/<generator>.py``'s ``generate(cfg, seed, device)``, which
returns the graph as tensors on ``device``: ``src``, ``dst`` (E,) int64,
``x`` (N, d) float32, ``y`` (N,) int64 and the boolean ``train_mask``,
``val_mask``, ``test_mask`` (N,)."""
from __future__ import annotations

import importlib
import re

NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def generate(cfg: dict, seed: int, device) -> dict:
    if not NAME.match(cfg["generator"]):
        raise ValueError(f"bad generator {cfg['generator']!r}")
    mod = importlib.import_module(f"bench.graphs.{cfg['generator']}")
    return mod.generate(cfg, seed, device)
