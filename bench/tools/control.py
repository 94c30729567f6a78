"""The readings that a cell's ``correct`` limits are set from, at the cell's
own size on the card (the benchmark's runs never run this).

    python3 bench/tools/control.py --config graphsage-reddit \\
        --traffic sylvie_a vanilla --seeds 12 --controls 3 [--no-program]

For each seed it makes the graph and weights as a run does, and for each
traffic:

* ``sound``: the program's warm-up epochs against the reference's (the
  lower readings); and, as a witness of what float32 itself reads, the
  program and the reference each against the reference in float64. With
  ``--no-program`` this is left out (the benchmark's own runs print the
  same numbers), and only the controls below are read;
* on the first ``--controls`` seeds, the reference put in the program's
  place: ``control`` computed in TF32 (matmul and cuDNN), and each fault a
  training cell can have planted in it: ``half_batch`` (the loss's mean over
  half the training nodes), ``exchange_left_out`` (every halo row zero),
  ``gradient_altered`` (the first leaf's gradient doubled where the optimizer
  gets it). A step that leaves its state unchanged reads 1 by ``delta``'s
  measure and needs no run.

One JSON line per seed and traffic goes to standard output and to
``chiprun_out/control_<config>.jsonl``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@contextlib.contextmanager
def tf32():
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def faults():
    """name -> a context that plants the fault in the reference."""
    import torch
    from bench.reference import common as C

    def half_ce(logits, y, mask):
        idx = torch.nonzero(mask).squeeze(1)
        keep = torch.zeros_like(mask)
        keep[idx[: idx.numel() // 2]] = True
        return C.masked_ce(logits, y, keep)

    table = C.RefComm.table

    def no_exchange(self, site, h):
        t = table(self, site, h)
        self.new_caches[-1] = torch.zeros_like(self.new_caches[-1])
        return torch.cat([t[:h.shape[0]], torch.zeros_like(t[h.shape[0]:])])

    adam = C.adam

    def altered(lr):
        step = adam(lr)

        def run(params, grads, state, t):
            grads = dict(grads)
            first = next(iter(grads))
            grads[first] = 2 * grads[first]
            return step(params, grads, state, t)
        return run

    return {"half_batch": lambda: patched(
                C, "train_steps", functools.partial(C.train_steps,
                                                    loss_fn=half_ce)),
            "exchange_left_out": lambda: patched(C.RefComm, "table",
                                                 no_exchange),
            "gradient_altered": lambda: patched(C, "adam", altered)}


def diff_norms(prog: dict, ref: dict, params0: dict) -> dict:
    """A look beside the gaps of norms: each leaf's norm of the difference
    over the reference's norm, for the first gradient and the change, by
    the median and the worst leaf."""
    import statistics

    import torch

    def rel(a, b):
        return float(torch.linalg.vector_norm((a - b).double())
                     / torch.linalg.vector_norm(b.double()).clamp(min=1e-30))
    g = [rel(prog["grad0"][k], ref["grad0"][k]) for k in ref["grad0"]]
    d = [rel(prog["params"][k] - params0[k], ref["params"][k] - params0[k])
         for k in ref["params"]]
    return {"grad_diff_med": statistics.median(g), "grad_diff": max(g),
            "delta_diff_med": statistics.median(d), "delta_diff": max(d)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1000)
    ap.add_argument("--no-program", action="store_true",
                    help="read the control and the faults only")
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the tool at a configuration's size")
    args = ap.parse_args(argv)

    import torch
    from bench import run as R
    from bench.lib import graphgen
    from bench.reference import common as C
    from bench.reference import compare

    dev = torch.device(args.device)
    cfg = R._load_json(ROOT, "configs", args.config)
    out = ROOT / "chiprun_out" / f"control_{args.config}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    planted = faults()
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        data = {k: v.cpu().numpy()
                for k, v in graphgen.generate(cfg, seed, dev).items()}
        model = R.load_reference(cfg["family"]).Model(
            cfg, data["x"].shape[1], cfg["n_classes"])
        weights = C.glorot_params(model.param_shapes(), seed, dev)
        for traffic in args.traffic:
            cell = {"name": f"{args.config}-{traffic}", "config_spec": cfg,
                    "traffic_spec": R._load_json(ROOT, "traffic", traffic)}
            ref = R.reference_epochs(cell, data, weights, seed, dev)
            row = {"config": args.config, "traffic": traffic, "seed": seed,
                   "ref_losses": ref["losses"]}
            if not args.no_program:
                t1 = time.perf_counter()
                tr, prog_model = R.build_program(cell, data, weights, seed,
                                                 dev)
                prog = R.first_epochs(
                    tr, int(cell["traffic_spec"]["warmup_epochs"]))
                del tr, prog_model
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                t2 = time.perf_counter()
                ref64 = R.reference_epochs(cell, data, weights, seed, dev,
                                           torch.float64)
                row.update(
                    sound=compare.training_gaps(prog, ref, weights),
                    sound_diff=diff_norms(prog, ref, weights),
                    program_vs_f64=compare.training_gaps(prog, ref64,
                                                         weights),
                    f32_vs_f64=compare.training_gaps(ref, ref64, weights),
                    losses=prog["losses"], program_s=t2 - t1)
            if i < args.controls:
                with tf32():
                    low = R.reference_epochs(cell, data, weights, seed, dev)
                row["control"] = compare.training_gaps(low, ref, weights)
                row["control_diff"] = diff_norms(low, ref, weights)
                for name, plant in planted.items():
                    with plant():
                        bad = R.reference_epochs(cell, data, weights, seed,
                                                 dev)
                    row[name] = compare.training_gaps(bad, ref, weights)
                    row[name + "_diff"] = diff_norms(bad, ref, weights)
            row["seed_s"] = time.perf_counter() - t0
            line = json.dumps(row)
            print(line, flush=True)
            with open(out, "a") as f:
                f.write(line + "\n")
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
