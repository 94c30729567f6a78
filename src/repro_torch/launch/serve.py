"""GNN serving launcher of the port, as ``python -m repro.launch.serve``:
train -> checkpoint -> quantized inference engine -> load-tested request
path, in one command.

Flow (``python -m repro_torch.launch.serve --graph reddit_like@paper``):

1. load the named workload and partition it (``repro_torch.datasets``);
2. restore the checkpoint under ``--ckpt-dir`` — or, when none exists, train
   ``--train-epochs`` epochs with the port's trainer and save one (the
   format is shared with the JAX package, so either package's checkpoint
   serves);
3. build an :class:`~repro_torch.serve.engine.InferenceEngine` at
   ``--bits`` (the paper's model of ``--arch`` from
   ``repro_torch.configs``; ``--reduced`` for d_hidden 16), run the full
   cache sweep, then drive the closed-loop load generator (``--clients`` x
   ``--requests`` seeded queries of ``--batch`` node ids, with a k-hop delta
   refresh of ``--refresh-nodes`` nodes every ``--refresh-every``
   completions);
4. print and write the serving report JSON (QPS, p50/p99 ms, exact refresh
   wire bytes, delta-vs-full byte ratio) under ``artifacts/torch/serve/``.

``--matrix NAME`` instead runs a serving matrix — bits x refresh mode cells
over one workload, one report JSON per cell plus a summary, under
``artifacts/torch/scenarios/serve_<NAME>/``.

``--store`` swaps the resident table for a sharded embedding store with a
hot-node cache (``--cache-kb``); ``--replicas N`` fronts the engine with N
load-balanced server replicas; ``--open-loop`` replaces the closed loop with
fixed-QPS Poisson arrivals (``--qps``, ``--slo-ms``, ``--skew``) and can
drive a seeded mutation stream through the refresh path while serving
(``--stream-events``).

Examples::

    python -m repro_torch.launch.serve --graph reddit_like@paper
    python -m repro_torch.launch.serve --graph gdelt_like@paper --store \\
        --replicas 2 --open-loop --qps 2000 --slo-ms 50 --skew 1.1 \\
        --stream-events 60
    python -m repro_torch.launch.serve --graph yelp_like@smoke --reduced \\
        --device cpu

Without ``--device cpu`` they run on the CUDA card (and raise where there is
none).

``--runtime sharded --dist-backend gloo|nccl`` serves one partition per
process: the command trains or finds the checkpoint (on the simulated
runtime, as the reference does), then spawns ``--parts`` ranks
(``repro_torch.dist.spawn``); rank 0 runs the flow above (engine, server,
load, the measured delta) and reports ``"runtime": "sharded"``, and the
other ranks follow its sweeps (``InferenceEngine.lead``). ``--device``
is every rank's (``cpu``, or one card, ``cuda:0``, which needs ``gloo``);
without it rank ``r`` takes ``cuda:<r>`` (``nccl``: a card per rank)::

    python -m repro_torch.launch.serve --graph yelp_like@smoke --reduced \\
        --device cpu --runtime sharded --dist-backend gloo
    python -m repro_torch.launch.serve --graph reddit_like@paper \\
        --device cuda:0 --runtime sharded --dist-backend gloo

``--matrix`` runs on the simulated runtime.
Partitions come through the plan cache (``artifacts/torch/plans/``).
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
from pathlib import Path
from typing import Optional

import numpy as np

from .. import obs

# the module the ranks of a sharded run import their function from (not
# __main__ under ``python -m``)
MODULE = "repro_torch.launch.serve"


def _root() -> Path:
    return Path(__file__).resolve().parents[3]


def _out_root() -> Path:
    """``<repo>/artifacts/torch``: the port's artifacts, beside the JAX
    package's ``artifacts/serve`` (never overwritten from here)."""
    return _root() / "artifacts" / "torch"


def _ckpt_dir(arch: str, ref: str, reduced: bool) -> Path:
    """The default checkpoint directory of ``arch`` served on ``ref``."""
    tag = f"{arch}-reduced" if reduced else arch
    return _out_root() / "serve" / f"{tag}-{ref.replace('@', '-')}-ckpt"


def _load(ref: str, parts: int, seed: int, reduced: bool = False,
          group=None):
    """The partitioned workload and ``{arch: (d_in, d_out) -> model}`` of the
    paper's models (``repro_torch.configs``; d_hidden 16 when reduced).
    ``group``: the ranks of a sharded run, rank 0 reading the plan cache."""
    from .. import configs as configlib
    from .. import datasets
    pg, _ = datasets.load_partitioned(ref, parts, seed=seed, group=group)
    archs = {}
    for arch in ("gcn", "graphsage", "gat"):
        spec = configlib.get(arch)
        archs[arch] = (spec.reduced() if reduced else spec.config()).make
    return pg, archs


def _ensure_checkpoint(ckpt_dir: Path, model, pg, *, train_epochs: int,
                       train_bits: int, seed: int, device) -> bool:
    """Train + save a checkpoint unless one already exists. Returns True when
    training ran."""
    from ..core.sylvie import SylvieConfig
    from ..train import checkpoint as ckpt
    from ..train.trainer import GNNTrainer
    if ckpt.latest_step(ckpt_dir) is not None:
        return False
    tr = GNNTrainer(model, pg, SylvieConfig(mode="sync", bits=train_bits),
                    device=device, seed=seed, ckpt_dir=str(ckpt_dir))
    tr.fit(train_epochs)
    tr.save()
    return True


def serve_once(args) -> dict:
    """The CLI's single-cell flow; returns the serving report dict (rank
    0's under ``--runtime sharded``)."""
    from ..dist.runtime import Runtime, resolve_device

    sharded = args.runtime == "sharded"
    if sharded and args.dist_backend is None:
        raise ValueError("--runtime sharded needs --dist-backend gloo|nccl")
    # the parent ensures the checkpoint on the simulated runtime (a sharded
    # run spawns its ranks after)
    device = resolve_device(args.device)
    pg, archs = _load(args.graph, args.parts, args.seed, args.reduced)
    model = archs[args.arch](pg.x.shape[-1], pg.n_classes)
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else \
        _ckpt_dir(args.arch, args.graph, args.reduced)
    trained = _ensure_checkpoint(ckpt_dir, model, pg,
                                 train_epochs=args.train_epochs,
                                 train_bits=args.train_bits, seed=args.seed,
                                 device=device)
    if sharded:
        import importlib

        from ..dist.spawn import spawn
        rank_fn = importlib.import_module(MODULE)._serve_rank
        return spawn(rank_fn, args.parts, device=args.device,
                     dist_backend=args.dist_backend,
                     args=(args, ckpt_dir, trained))
    engine, meta = _engine(args, ckpt_dir, model, pg,
                           Runtime.simulated(args.parts, device=device))
    return _front(engine, args, meta, ckpt_dir, trained)


def _engine(args, ckpt_dir: Path, model, pg, runtime):
    """``(engine, checkpoint meta)`` restored from ``ckpt_dir``, with the
    store of ``--store`` (rank 0's alone under a sharded runtime)."""
    from ..serve import InferenceEngine, ServeConfig
    store = None
    if args.store and runtime.rank in (None, 0):
        from ..store import ShardedEmbeddingStore
        store = ShardedEmbeddingStore(cache_bytes=args.cache_kb << 10)
    return InferenceEngine.from_checkpoint(
        ckpt_dir, model, pg,
        config=ServeConfig(bits=args.bits, max_staleness=args.max_staleness),
        runtime=runtime, seed=args.seed, store=store)


def _serve_rank(args, ckpt_dir: Path, trained: bool) -> Optional[dict]:
    """One rank of ``--runtime sharded`` (inside ``dist.spawn``): its
    partition's engine; rank 0 runs the front, the others follow."""
    import torch.distributed as dist

    from ..dist.runtime import Runtime
    runtime = Runtime.sharded(args.parts, device=args.device)
    pg, archs = _load(args.graph, args.parts, args.seed, args.reduced,
                      group=dist.group.WORLD)
    model = archs[args.arch](pg.x.shape[-1], pg.n_classes)
    engine, meta = _engine(args, ckpt_dir, model, pg, runtime)
    return engine.lead(_front, args, meta, ckpt_dir, trained)


def _front(engine, args, meta: dict, ckpt_dir: Path, trained: bool) -> dict:
    """The serving flow on the front (the whole stack's process, or rank 0):
    sweep, server, load, one measured delta; prints and returns the
    report."""
    from ..serve import EmbeddingServer, ReplicaSet
    from ..serve.loadgen import closed_loop, open_loop

    pg, store, device = engine.pg, engine.store, engine.device
    sweep = engine.full_sweep()
    n_nodes = int(pg.part_of.shape[0])

    if args.replicas > 1:
        server = ReplicaSet(engine, n_replicas=args.replicas,
                            microbatch=args.microbatch,
                            max_queue=args.max_queue)
    else:
        server = EmbeddingServer(engine, microbatch=args.microbatch,
                                 max_queue=args.max_queue)
    if args.open_loop:
        feed = None
        if args.stream_events:
            from ..datasets import registry
            from ..store import MutationStream
            name, tier = registry.parse(args.graph)
            stream_kw = dict(registry.get(name).stream.get(tier, {}))
            stream = MutationStream(n_nodes, pg.x.shape[-1],
                                    seed=args.seed + 2, **stream_kw)
            feed = stream.batches(args.stream_events, args.stream_window,
                                  rows_of=engine.feature_rows)
        load = open_loop(server, n_nodes, qps=args.qps,
                         requests=args.requests, batch=args.batch,
                         seed=args.seed, skew=args.skew,
                         slo_ms=args.slo_ms, feed=feed)
    else:
        load = closed_loop(server, n_nodes, clients=args.clients,
                           batch=args.batch, requests=args.requests,
                           seed=args.seed, refresh_every=args.refresh_every,
                           refresh_nodes=args.refresh_nodes)

    # one measured delta refresh for the byte comparison; the interleaved
    # load-phase refreshes may have run the staleness clock up to the bound,
    # so reset it first or the measurement could silently be a forced full
    engine.full_sweep()
    rng = np.random.default_rng(args.seed + 1)
    ids = rng.choice(n_nodes, size=max(1, args.refresh_nodes), replace=False)
    rows = rng.normal(0, 1, (ids.size, pg.x.shape[-1])).astype(np.float32)
    delta = engine.refresh(ids, rows)

    report = {
        "graph": args.graph, "arch": args.arch, "n_parts": args.parts,
        "bits": args.bits, "runtime": args.runtime, "seed": args.seed,
        "checkpoint": dict(dir=str(ckpt_dir), trained_now=trained, **meta),
        "sweep_seconds": sweep.seconds,
        "full_sweep_wire_bytes": engine.full_sweep_wire_bytes(),
        "load": load,
        "delta_refresh": dict(kind=delta.kind, changed=delta.changed,
                              affected_rows=list(delta.affected_rows),
                              wire_bytes=delta.wire_bytes,
                              seconds=delta.seconds),
        "delta_vs_full_bytes": delta.wire_bytes
        / max(engine.full_sweep_wire_bytes(), 1),
    }
    if store is not None:
        report["store"] = store.stats().as_dict()
        report["store"]["shard_bytes"] = store.shard_bytes()
    if args.replicas > 1:
        report["replicas"] = server.per_replica()
    print(f"== serve {args.arch} on {args.graph} (P={args.parts}, "
          f"{args.bits}-bit, {args.runtime}, {device}"
          + (f", store cache {args.cache_kb} kB" if store is not None else "")
          + (f", {args.replicas} replicas" if args.replicas > 1 else "")
          + ") ==")
    print(f"checkpoint: {'trained now' if trained else 'restored'} "
          f"(epoch {meta.get('epoch', '?')}, format v"
          f"{meta.get('format_version')})")
    print(f"sweep {sweep.seconds*1e3:.1f} ms, full refresh "
          f"{report['full_sweep_wire_bytes']/1e3:.1f} kB")
    if args.open_loop:
        print(f"open loop: offered {load['qps_offered']:.0f} qps, achieved "
              f"{load['qps_achieved']:.0f} qps  p50 {load['p50_ms']:.3f} ms  "
              f"p99 {load['p99_ms']:.3f} ms  ({load['completed']} completed, "
              f"{load['lost']} lost, {load['refreshes']} refreshes)")
        if load["slo_pass"] is not None:
            print(f"SLO {load['slo_ms']:.1f} ms: "
                  f"{'PASS' if load['slo_pass'] else 'FAIL'}")
    else:
        print(f"load: {load['qps']:.0f} qps  p50 {load['p50_ms']:.3f} ms  "
              f"p99 {load['p99_ms']:.3f} ms  ({load['requests']} requests, "
              f"{load['rejected']} rejected)")
    if store is not None:
        s = report["store"]
        print(f"store: hit rate {s['hit_rate']:.3f}, miss bytes "
              f"{s['miss_bytes']/1e3:.1f} kB, cached "
              f"{s['cached_bytes']/1e3:.1f} of {s['shard_bytes']/1e3:.1f} kB")
    print(f"delta refresh ({delta.changed} nodes): "
          f"{delta.wire_bytes/1e3:.2f} kB = "
          f"{100*report['delta_vs_full_bytes']:.1f}% of a full sweep")
    return report


# ---------------------------------------------------------------------------
# serving matrix (bits x refresh cells over one workload)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeMatrix:
    """A serving sweep: every ``bits`` width x refresh mode on one workload,
    all cells sharing one trained checkpoint."""

    name: str
    dataset: str
    bits: tuple[int, ...] = (32, 1)
    refreshes: tuple[str, ...] = ("full", "delta")
    parts: int = 4
    train_epochs: int = 3
    requests: int = 80
    clients: int = 4
    batch: int = 16
    refresh_nodes: int = 8
    seed: int = 0

    def cells(self):
        return tuple(itertools.product(self.bits, self.refreshes))


SERVE_MATRICES: dict[str, ServeMatrix] = {
    "smoke": ServeMatrix(name="smoke", dataset="yelp_like@smoke"),
    "small": ServeMatrix(name="small", dataset="yelp_like@small",
                         train_epochs=5, requests=200, refresh_nodes=12),
}


def run_serve_matrix(name: str, out_dir: Optional[Path] = None, *,
                     device=None, reduced: bool = False) -> list[dict]:
    """Run every cell of a named serving matrix (GCN); one JSON per cell plus
    ``summary.json`` under ``artifacts/torch/scenarios/serve_<name>/``."""
    from ..dist.runtime import Runtime, resolve_device
    from ..serve import EmbeddingServer, InferenceEngine, ServeConfig
    from ..serve.loadgen import closed_loop

    if name not in SERVE_MATRICES:
        raise KeyError(f"unknown serve matrix {name!r}; "
                       f"known: {sorted(SERVE_MATRICES)}")
    device = resolve_device(device)
    m = SERVE_MATRICES[name]
    out = (Path(out_dir) if out_dir is not None
           else _out_root() / "scenarios") / f"serve_{m.name}"
    out.mkdir(parents=True, exist_ok=True)
    pg, archs = _load(m.dataset, m.parts, m.seed, reduced)
    model = archs["gcn"](pg.x.shape[-1], pg.n_classes)
    ckpt_dir = _ckpt_dir("gcn", m.dataset, reduced)
    _ensure_checkpoint(ckpt_dir, model, pg, train_epochs=m.train_epochs,
                       train_bits=1, seed=m.seed, device=device)
    n_nodes = int(pg.part_of.shape[0])
    rng = np.random.default_rng(m.seed + 1)
    ids = rng.choice(n_nodes, size=m.refresh_nodes, replace=False)
    rows = rng.normal(0, 1, (ids.size, pg.x.shape[-1])).astype(np.float32)

    reports = []
    for bits, refresh in m.cells():
        cell_id = f"gcn__{m.dataset}__bits{bits}__{refresh}"
        engine, meta = InferenceEngine.from_checkpoint(
            ckpt_dir, model, pg,
            runtime=Runtime.simulated(m.parts, device=device),
            config=ServeConfig(bits=bits), seed=m.seed)
        engine.full_sweep()
        t0 = obs.clock()
        load = closed_loop(EmbeddingServer(engine), n_nodes,
                           clients=m.clients, batch=m.batch,
                           requests=m.requests, seed=m.seed)
        rep = engine.refresh(ids, rows, full=(refresh == "full"))
        r = {
            "matrix": f"serve_{m.name}", "cell": cell_id,
            "dataset": m.dataset, "bits": bits, "refresh": refresh,
            "n_parts": m.parts, "seed": m.seed,
            "checkpoint_step": meta.get("step"),
            "refresh_wire_bytes": rep.wire_bytes,
            "refresh_affected_rows": list(rep.affected_rows),
            "full_sweep_wire_bytes": engine.full_sweep_wire_bytes(),
            "load": load, "seconds": obs.clock() - t0,
        }
        (out / f"{cell_id}.json").write_text(
            json.dumps(r, indent=1, default=float))
        print(f"[serve:{m.name}] {cell_id}: {load['qps']:.0f} qps, refresh "
              f"{rep.wire_bytes/1e3:.2f} kB")
        reports.append(r)
    summary = {"matrix": f"serve_{m.name}", "dataset": m.dataset,
               "cells": [r["cell"] for r in reports],
               "qps": {r["cell"]: r["load"]["qps"] for r in reports},
               "refresh_wire_bytes": {r["cell"]: r["refresh_wire_bytes"]
                                      for r in reports}}
    (out / "summary.json").write_text(json.dumps(summary, indent=1,
                                                 default=float))
    return reports


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="quantized full-graph GNN serving (repro_torch.serve)")
    ap.add_argument("--graph", default="yelp_like@small",
                    help="named-workload ref, 'name@tier' "
                         "(see repro_torch.datasets.names())")
    ap.add_argument("--arch", default="gcn",
                    choices=["gcn", "graphsage", "gat"])
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (d_hidden 16)")
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--bits", type=int, default=1,
                    help="serving halo bit-width (32 = full precision)")
    ap.add_argument("--runtime", default="simulated",
                    choices=["simulated", "sharded"],
                    help="sharded: one process per partition (needs "
                         "--dist-backend); rank 0 serves")
    ap.add_argument("--dist-backend", default=None, choices=("gloo", "nccl"),
                    help="the sharded runtime's torch.distributed backend: "
                         "gloo (the CPU, or every rank on one card) or nccl "
                         "(a card per rank)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; default: the "
                         "CUDA card (sharded: cuda:<rank>)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore from here (a checkpoint of either "
                         "package); trains + saves when empty (default "
                         "artifacts/torch/serve/<arch>-<graph>-ckpt)")
    ap.add_argument("--train-epochs", type=int, default=5)
    ap.add_argument("--train-bits", type=int, default=1)
    ap.add_argument("--max-staleness", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=128)
    ap.add_argument("--max-queue", type=int, default=1024)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--refresh-every", type=int, default=None,
                    help="interleave a delta refresh every N completions")
    ap.add_argument("--refresh-nodes", type=int, default=8)
    ap.add_argument("--store", action="store_true",
                    help="serve through a sharded embedding store "
                         "(repro_torch.store) instead of the resident table")
    ap.add_argument("--cache-kb", type=int, default=4096,
                    help="store hot-node cache capacity (kB)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="front the engine with N load-balanced server "
                         "replicas (ReplicaSet) when > 1")
    ap.add_argument("--open-loop", action="store_true",
                    help="sustained open-loop load (fixed-QPS Poisson "
                         "arrivals) instead of the closed loop")
    ap.add_argument("--qps", type=float, default=500.0,
                    help="open-loop offered rate (arrivals/s)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="open-loop p99 latency SLO gate (ms)")
    ap.add_argument("--skew", type=float, default=0.0,
                    help="open-loop Zipf query skew (0 = uniform)")
    ap.add_argument("--stream-events", type=int, default=0,
                    help="open-loop: drive N mutation-stream events through "
                         "server.refresh while serving (uses the workload's "
                         "stream calibration when it declares one)")
    ap.add_argument("--stream-window", type=float, default=0.25,
                    help="mutation-stream consumption window (s)")
    ap.add_argument("--matrix", default=None,
                    help="run a named serving matrix instead "
                         f"({sorted(SERVE_MATRICES)})")
    ap.add_argument("--out", default=None, help="report JSON path override")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.matrix:
        run_serve_matrix(args.matrix, device=args.device,
                         reduced=args.reduced)
        return
    report = serve_once(args)
    ref_safe = args.graph.replace("@", "-")
    out = Path(args.out) if args.out else \
        _out_root() / "serve" / f"{args.arch}-{ref_safe}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1, default=float))
    print(f"report -> {out}")


if __name__ == "__main__":
    main()
