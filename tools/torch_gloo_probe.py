#!/usr/bin/env python3
"""Check ``torch.distributed``'s ``gloo`` collectives on CUDA tensors, four
ranks on one card (what the sharded runtime's one-card check relies on).

    python3 tools/torch_gloo_probe.py

Four processes (``torch.multiprocessing``, a ``FileStore`` rendezvous) on
``cuda:0`` (the CPU where there is no card) run ``all_to_all_single``
with equal and uneven splits on float32, uint8, bfloat16 and int32 rows,
one with ``async_op=True`` and ``wait()``, a 0-d ``all_reduce``,
``all_gather`` and ``broadcast_object_list``; each rank checks that every
one moved the right values and raises if not (the script then exits
non-zero), and rank 0 prints the mean time of a 1 MB ``all_to_all_single``
over 20 calls (host clock, ending in a sync). Prints Python's, PyTorch's
and CUDA's versions first.
"""
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, world, store_path):
    torch.set_num_threads(1)
    dev = torch.device("cuda:0") if torch.cuda.is_available() else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    for name, fn in [
        ("a2a_equal_f32", lambda: a2a(dev, torch.float32, None)),
        ("a2a_uneven_u8", lambda: a2a(dev, torch.uint8, [0, 3, 5, 2])),
        ("a2a_uneven_bf16", lambda: a2a(dev, torch.bfloat16, [1, 0, 2, 7])),
        ("a2a_uneven_i32", lambda: a2a(dev, torch.int32, [4, 4, 0, 1])),
        ("a2a_async", lambda: a2a(dev, torch.float32, [2, 1, 0, 3], True)),
        ("allreduce_0d", lambda: allreduce(dev)),
        ("allgather", lambda: allgather(dev)),
        ("bcast_obj", lambda: bcast()),
    ]:
        if not fn():
            raise RuntimeError(f"rank {rank}: {name} moved the wrong values")
    dist.barrier()
    if rank == 0:
        print("every collective moved the right values", flush=True)
    # timing: 1 MB a2a x 20
    x = torch.randn(4 * 65536, device=dev)
    out = torch.empty_like(x)
    for _ in range(3):
        dist.all_to_all_single(out, x)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        dist.all_to_all_single(out, x)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if rank == 0:
        print("a2a 1MB ms", (time.perf_counter() - t0) / 20 * 1e3, flush=True)
    dist.destroy_process_group()


def a2a(dev, dtype, splits, async_op=False):
    r, w = dist.get_rank(), dist.get_world_size()
    base = splits or [3] * w
    # rank r sends base[(d - r) % w] rows to d
    ins = [base[(d - r) % w] for d in range(w)]
    outs = [base[(r - s) % w] for s in range(w)]
    x = torch.cat([torch.full((n, 5), 10 * r + d, dtype=torch.float32) for d, n in enumerate(ins)]).to(dtype).to(dev)
    out = torch.empty((sum(outs), 5), dtype=dtype, device=dev)
    work = dist.all_to_all_single(out, x, outs, ins, async_op=async_op)
    if async_op:
        work.wait()
    want = torch.cat([torch.full((n, 5), 10 * s + r, dtype=torch.float32) for s, n in enumerate(outs)]).to(dtype)
    return bool(torch.equal(out.cpu(), want))


def allreduce(dev):
    w = dist.get_world_size()
    x = torch.tensor(float(dist.get_rank() + 1), device=dev)
    dist.all_reduce(x)
    return float(x) == w * (w + 1) / 2


def allgather(dev):
    w = dist.get_world_size()
    x = torch.full((1, 3), dist.get_rank(), dtype=torch.uint8, device=dev)
    outs = [torch.empty_like(x) for _ in range(w)]
    dist.all_gather(outs, x)
    return torch.cat(outs).cpu().tolist() == [[r] * 3 for r in range(w)]


def bcast():
    obj = [dist.get_rank() == 0]
    dist.broadcast_object_list(obj, src=0)
    return obj == [True]


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    d = tempfile.mkdtemp()
    t0 = time.perf_counter()
    mp.start_processes(run, args=(4, os.path.join(d, "store")), nprocs=4, start_method="spawn", join=True)
    print("total s", time.perf_counter() - t0)
