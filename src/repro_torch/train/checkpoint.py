"""Checkpoints in the JAX package's format: one directory per step.

    <dir>/step_0000100/
        manifest.json     format_version, step, sorted keys, shapes, dtypes, meta
        arrays.npz        path-keyed leaves ("params/layer0/w", ...)

The format (``format_version`` 2, ``/``-joined dict paths) is the one
``repro.train.checkpoint`` writes and reads, so a checkpoint saved by either
package restores in the other. Saves are atomic (a temporary directory renamed
into place) and keep the newest ``keep`` steps.

Trees are nested dicts, tuples and dataclasses (``GNNTrainState``) of tensors
or arrays; their paths are the ones ``jax.tree_util`` writes: dict keys in
sorted order, tuple positions, dataclass fields in order, ``None`` dropped —
``params/layer0/w``, ``opt_state/t``, ``halo/feats/0``.

:func:`restore` loads a full training state: a leaf whose stored shape
differs (halo caches after an elastic repartition) or that is missing is
zero-filled and flags a synchronous epoch. :func:`restore_for_inference`
loads only the model parameters: a missing or mis-shaped parameter leaf is
an error, never zero-filled.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

SEP = "/"
FORMAT_VERSION = 2


def _children(tree):
    """(key, child) pairs of an inner node, or ``None`` for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(str(i), t) for i, t in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    """A tree -> {"a/b/c": leaf} (see the module docstring for the paths)."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {prefix or "_root": tree}
    flat: dict[str, Any] = {}
    for k, child in kids:
        flat.update(_flatten(child, f"{prefix}{SEP}{k}" if prefix else k))
    return flat


def _rebuild(tree, leaf_of, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaf_of(path)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return leaf_of(prefix or "_root")
    new = {k: _rebuild(c, leaf_of, f"{prefix}{SEP}{k}" if prefix else k)
           for k, c in kids}
    if isinstance(tree, dict):
        return {k: new[str(k)] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(new[str(i)] for i in range(len(tree)))
    return dataclasses.replace(tree, **new)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str | os.PathLike, step: int, tree,
         meta: Optional[dict] = None, keep: int = 3) -> Path:
    """Write ``tree`` (nested dicts of tensors or arrays) as step ``step``."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    np.savez(tmp / "arrays.npz", **flat)
    manifest = dict(format_version=FORMAT_VERSION, step=int(step),
                    keys=sorted(flat),
                    shapes={k: list(v.shape) for k, v in flat.items()},
                    dtypes={k: str(v.dtype) for k, v in flat.items()},
                    meta=meta or {})
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish

    kept = sorted(p for p in ckpt_dir.iterdir()
                  if p.is_dir() and p.name.startswith("step_"))
    for old in kept[:-keep]:
        shutil.rmtree(old)
    return final


def latest_step(ckpt_dir: str | os.PathLike) -> Optional[int]:
    """Newest published step (orphaned ``.tmp_step_*`` dirs are removed)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.iterdir():
        if not p.is_dir():
            continue
        if p.name.startswith(".tmp_step_"):
            shutil.rmtree(p, ignore_errors=True)
            continue
        if p.name.startswith("step_"):
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _open(ckpt_dir: str | os.PathLike, step: Optional[int]):
    """(manifest, arrays) of one checkpoint; refuses newer formats."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    version = int(manifest.get("format_version", 1))
    if version > FORMAT_VERSION:
        raise ValueError(
            f"{d} was written with checkpoint format {version}; this reader "
            f"understands <= {FORMAT_VERSION}")
    return manifest, np.load(d / "arrays.npz")


def _unflatten(flat: dict[str, Any]):
    if list(flat) == ["_root"]:
        return flat["_root"]
    tree: dict = {}
    for key, leaf in flat.items():
        *path, last = key.split(SEP)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def restore(ckpt_dir: str | os.PathLike, example_tree,
            step: Optional[int] = None):
    """-> (tree, manifest meta, needs_sync_epoch).

    ``example_tree`` gives the structure and the target shapes and dtypes;
    the result has its structure with numpy leaves. Leaves whose stored shape
    differs (halo caches after an elastic repartition) or that are missing
    are zeros of the target shape, and flag a synchronous epoch."""
    manifest, stored = _open(ckpt_dir, step)
    examples = _flatten(example_tree)
    needs_sync = False

    def leaf_of(key):
        nonlocal needs_sync
        ex = _to_numpy(examples[key])
        if key in stored.files and tuple(stored[key].shape) == ex.shape:
            return stored[key].astype(ex.dtype)
        needs_sync = True
        return np.zeros(ex.shape, ex.dtype)

    tree = _rebuild(example_tree, leaf_of)
    return tree, manifest["meta"], needs_sync


def restore_for_inference(ckpt_dir: str | os.PathLike, example_params,
                          step: Optional[int] = None):
    """Load only the parameters (``params/...`` leaves) of a checkpoint.

    ``example_params`` (nested dicts, e.g. ``params_to_numpy(model)``) gives
    the structure and target shapes/dtypes. Returns ``(params, meta)``:
    nested dicts of numpy arrays, and the manifest's meta dict plus ``step``
    and ``format_version``. Raises ``KeyError`` on a missing leaf and
    ``ValueError`` on a shape mismatch."""
    manifest, stored = _open(ckpt_dir, step)
    out = {}
    for key, ex in _flatten(example_params).items():
        stored_key = f"params{SEP}{key}" if key != "_root" else "params"
        if stored_key not in stored.files:
            raise KeyError(
                f"checkpoint step_{manifest['step']:08d} has no leaf "
                f"{stored_key!r}; is this a checkpoint for this model?")
        arr = stored[stored_key]
        ex = _to_numpy(ex)
        if tuple(arr.shape) != tuple(ex.shape):
            raise ValueError(
                f"parameter {stored_key!r} has stored shape {arr.shape}, "
                f"model expects {tuple(ex.shape)}")
        out[key] = arr.astype(ex.dtype)
    meta = dict(manifest["meta"])
    meta["step"] = int(manifest["step"])
    meta["format_version"] = int(manifest.get("format_version", 1))
    return _unflatten(out), meta
