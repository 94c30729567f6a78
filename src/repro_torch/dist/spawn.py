"""Start one process per partition and join them: the port's counterpart of
the reference's "force host devices, build a mesh" (``repro.dist.api``,
``repro.dist.runtime.Runtime.sharded``), for a multi-controller runtime.

    from repro_torch.dist import spawn
    result = spawn.spawn(train_fn, 4, device="cpu", dist_backend="gloo",
                         args=(cfg,))

Each of the ``n_parts`` processes (``torch.multiprocessing``, the ``spawn``
start method) joins a ``torch.distributed`` group through a ``FileStore`` in
a fresh temporary directory — no TCP port, so spawns running side by side
cannot collide — and calls ``fn(*args)``; inside it,
``Runtime.sharded(n_parts, device=...)`` reads that group. Every process
runs with one intra-op thread and ``OMP_NUM_THREADS`` / ``MKL_NUM_THREADS``
set to 1 (inherited by whatever it starts), and sees ``RANK``,
``LOCAL_RANK`` and ``WORLD_SIZE``. ``fn`` must be importable by name (a
module-level function): the processes import it afresh.

``dist_backend`` is the caller's choice and is never picked here: ``nccl``
for a card per rank, ``gloo`` for the CPU or for several ranks on one card
(NCCL refuses two ranks on one device). ``device`` is checked against it and
pins each rank's current CUDA device: ``None`` means ``cuda:<rank>``.

:func:`spawn` returns rank 0's result. It raises if any rank fails (with
that rank's error; the others are stopped) or if the ranks have not all
finished within ``timeout`` seconds (all are stopped).
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Callable

import torch

DIST_BACKENDS = ("gloo", "nccl")
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")


def _rank_device(device, rank: int) -> torch.device:
    return torch.device(f"cuda:{rank}" if device is None else device)


def _entry(rank: int, fn: Callable, n_parts: int, device, dist_backend: str,
           workdir: str, timeout: float, args: tuple) -> None:
    """One rank: threads, environment, the group, ``fn``, rank 0's result."""
    import torch.distributed as dist

    for var in THREAD_VARS:
        os.environ[var] = "1"
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(n_parts))
    torch.set_num_threads(1)
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(workdir, "store"), n_parts)
    dist.init_process_group(dist_backend, store=store, rank=rank,
                            world_size=n_parts,
                            timeout=timedelta(seconds=timeout))
    try:
        result = fn(*args)
        if rank == 0:
            tmp = os.path.join(workdir, "result.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(result, f)
            os.replace(tmp, os.path.join(workdir, "result.pkl"))
    finally:
        dist.destroy_process_group()


def _rank_errors(error_files) -> dict:
    """{rank: traceback} of every rank that raised (``torch.multiprocessing``
    pickles it into the rank's error file)."""
    out = {}
    for i, path in enumerate(error_files):
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as f:
                out[i] = pickle.load(f)
    return out


def spawn(fn: Callable, n_parts: int, *, device, dist_backend: str,
          args: tuple = (), timeout: float = 300.0):
    """Run ``fn(*args)`` in ``n_parts`` processes, one partition each, over a
    ``dist_backend`` group; return rank 0's result (see the module
    docstring). ``device``: ``"cpu"``, one CUDA device for every rank
    (``"cuda:0"``, ``gloo`` only), or ``None`` for ``cuda:<rank>``."""
    if dist_backend not in DIST_BACKENDS:
        raise ValueError(f"dist_backend must be one of {DIST_BACKENDS}, got "
                         f"{dist_backend!r}")
    if n_parts < 1:
        raise ValueError(f"n_parts must be positive, got {n_parts}")
    devs = {_rank_device(device, r) for r in range(n_parts)}
    if any(d.type not in ("cpu", "cuda") for d in devs):
        raise ValueError(f"unsupported device {device!r}; use 'cpu' or cuda")
    if dist_backend == "nccl":
        if any(d.type != "cuda" for d in devs):
            raise ValueError("nccl needs a CUDA device per rank")
        if len(devs) != n_parts:
            raise ValueError("nccl refuses two ranks on one device: give "
                             "each rank its own card, or use gloo")
    if any(d.type == "cuda" for d in devs):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the ranks on the CPU")
        missing = [d for d in devs if (d.index or 0)
                   >= torch.cuda.device_count()]
        if missing:
            raise RuntimeError(f"{len(devs)} CUDA devices asked for, "
                               f"{torch.cuda.device_count()} present")
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    workdir = tempfile.mkdtemp(prefix="repro_torch_spawn_")
    try:
        ctx = mp.start_processes(
            _entry, args=(fn, n_parts, device, dist_backend, workdir,
                          timeout, tuple(args)),
            nprocs=n_parts, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"spawn: {n_parts} ranks did not finish within "
                        f"{timeout:.0f} s")
        except ProcessException as err:
            # every rank that raised, in rank order: the first to exit may
            # be a peer that lost its connection to the rank at fault
            errors = _rank_errors(ctx.error_files)
            detail = "".join(f"\n-- rank {i}:\n{tb}"
                             for i, tb in errors.items()) or f"\n{err}"
            raise RuntimeError(f"spawn: rank(s) "
                               f"{list(errors) or [err.error_index]} "
                               f"failed:{detail}") from err
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
            for path in ctx.error_files:
                if os.path.exists(path):
                    os.unlink(path)
        result = Path(workdir) / "result.pkl"
        if not result.exists():
            raise RuntimeError("spawn: rank 0 finished without a result")
        with open(result, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
