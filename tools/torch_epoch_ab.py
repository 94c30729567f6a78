#!/usr/bin/env python3
"""Time the port's training epoch with and without its ``obs`` spans, in
turns in one process on one CUDA card.

    python3 tools/torch_epoch_ab.py [--archs gat gcn] [--epochs 164]
                                    [--out FILE]

For each arch (the paper config of ``repro_torch.configs``) trained on
``reddit_like@paper`` partitioned 4 ways, Sylvie-S (1 bit) and Sylvie-A (1
bit, bounded staleness 4) as ``chip_smoke.py``'s ``[train]`` phase runs
them, one trainer takes ``--epochs`` epochs, each through one of two
versions of the epoch:

* ``spans``: ``GNNTrainer.train_epoch`` (``epoch > decide > step`` spans,
  timed on ``obs.clock``), tracing off;
* ``plain``: :func:`plain_epoch`, the same epoch with no span, timed on
  ``time.perf_counter`` (the method as it stood before the spans).

Epoch ``e`` runs ``spans`` when ``(e // 4 + e) % 2 == 0``, else ``plain``: the
two alternate, and each gets half of Sylvie-A's sync epochs (one in 4) and
half of its async ones. A second trainer from the same seed takes as many
epochs through ``train_epoch`` alone; its losses must equal the alternating
run's bit for bit (the two versions compute the same epoch).

Prints, per arch, config, mode and version, the median and the quartiles
of the host milliseconds of an epoch (``time.perf_counter`` around the
call, which ends in ``float(loss)``) and of ``EpochMetrics.seconds`` (the
step alone), skipping the first 4 epochs, and one JSON line of them (also
written to ``FILE`` when given). Exits non-zero when the losses differ.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
SEED = 0
WARMUP = 4


def plain_epoch(tr):
    """``GNNTrainer.train_epoch`` without its spans, on the host clock."""
    from repro_torch.train.trainer import EpochMetrics
    decision = tr._decide()
    ts, ta = tr._steps_for(decision)
    fn = ts if decision.sync else ta
    t0 = time.perf_counter()
    masks = tr.bns_masks(tr.epoch) if tr.bns_masks else None
    tr.state, loss = fn(tr.state, tr.block, tr.x, tr.y,
                        tr.train_mask, tr._epoch_key(), masks)
    loss = float(loss)                   # a device sync
    dt = time.perf_counter() - t0
    tr._needs_sync = False
    tr._last_decision = decision
    tr._absorb_site_stats()
    pb, eb = tr.comm_bytes_per_epoch(decision)
    m = EpochMetrics(tr.epoch, loss, dt,
                     "sync" if decision.sync else "async",
                     pb / 1e6, eb / 1e6, schedule=decision.schedule,
                     bits_per_site=decision.bits_per_site(),
                     policy=tr.policy.name, ef_bits=decision.ef_bits)
    tr.history.append(m)
    tr.epoch += 1
    return m


def spread(ms: list) -> dict:
    q1, q2, q3 = np.percentile(ms, [25, 50, 75]) if ms else (0.0,) * 3
    return dict(n=len(ms), median=float(q2), q1=float(q1), q3=float(q3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="+", default=["gat", "gcn"])
    ap.add_argument("--epochs", type=int, default=164)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_epoch_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch import configs, datasets
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.kernels import build
    from repro_torch.policy import BoundedStaleness, Uniform
    from repro_torch.train.trainer import GNNTrainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[card] {card}")
    build.build_all()
    pg, _ = datasets.load_partitioned("reddit_like@paper", n_parts=4)
    d_in, n_cls = pg.x.shape[-1], pg.n_classes
    runs = {"sylvie_s": lambda: (SylvieConfig(mode="sync", bits=1),
                                 Uniform(bits=1)),
            "sylvie_a": lambda: (SylvieConfig(mode="async", bits=1),
                                 BoundedStaleness(eps_s=4, bits=1))}

    def trainer(arch, name):
        torch.manual_seed(SEED)
        cfg, pol = runs[name]()
        model = configs.get(arch).config().make(d_in, n_cls)
        return GNNTrainer(model, pg, cfg, policy=pol, seed=SEED)

    ok, out = True, {}
    for arch in args.archs:
        for name in runs:
            tr = trainer(arch, name)
            rows = []
            for e in range(args.epochs):
                version = "spans" if (e // 4 + e) % 2 == 0 else "plain"
                t0 = time.perf_counter()
                m = tr.train_epoch() if version == "spans" \
                    else plain_epoch(tr)
                wall = (time.perf_counter() - t0) * 1e3
                rows.append((version, m.mode, wall, m.seconds * 1e3, m.loss))
            ref = trainer(arch, name)
            want = [ref.train_epoch().loss for _ in range(args.epochs)]
            same = want == [r[4] for r in rows]
            ok = ok and same
            res = out[f"{arch}_{name}"] = {"losses_bit_equal": same}
            for mode in ("sync", "async"):
                for version in ("spans", "plain"):
                    sel = [r for r in rows[WARMUP:]
                           if r[0] == version and r[1] == mode]
                    if not sel:
                        continue
                    res[f"{mode}_{version}"] = dict(
                        wall_ms=spread([r[2] for r in sel]),
                        step_ms=spread([r[3] for r in sel]))
            print(f"[ab] {arch} {name}: {json.dumps(res)}")
            del tr, ref
            torch.cuda.empty_cache()
    line = json.dumps({"card": card, "epochs": args.epochs, "ok": ok,
                       "runs": out})
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
