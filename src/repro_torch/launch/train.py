"""End-to-end launcher of the port, as ``python -m repro.launch.train``:
full-graph training of GCN / GraphSAGE / GAT and of PNA / MeshGraphNet /
SchNet / NequIP with Sylvie's quantized halo exchange, LM training on the
synthetic token stream, batched LM serving (prefill + greedy decode), and
DLRM training on the synthetic Criteo stream.

    python -m repro_torch.launch.train --arch gcn --graph reddit_like@paper \\
        --parts 4 --mode async --bits 1 --eps-s 4 --epochs 20
    python -m repro_torch.launch.train --arch gat --graph reddit_like@paper \\
        --parts 4 --mode sync --bits 1 --epochs 20
    python -m repro_torch.launch.train --arch graphsage --reduced --graph \\
        yelp_like@smoke --epochs 3 --device cpu
    python -m repro_torch.launch.train --arch pna --graph reddit_like@paper \\
        --parts 4 --mode async --bits 1 --eps-s 4 --epochs 10
    python -m repro_torch.launch.train --arch meshgraphnet --reduced \\
        --graph mesh_like@smoke --epochs 2 --device cpu
    python -m repro_torch.launch.train --arch nequip --reduced \\
        --graph molecule_like@smoke --epochs 2 --device cpu
    python -m repro_torch.launch.train --arch granite-3-2b --steps 100 \
        --lr 1e-3 --batch 4 --seq 2048
    python -m repro_torch.launch.train --arch olmoe-1b-7b --reduced \
        --steps 3 --device cpu
    python -m repro_torch.launch.train --arch granite-3-2b --serve
    python -m repro_torch.launch.train --arch olmoe-1b-7b --serve
    python -m repro_torch.launch.train --arch deepseek-v2-236b --serve \\
        --reduced --device cpu
    python -m repro_torch.launch.train --arch gemma2-27b --serve --reduced \\
        --device cpu
    python -m repro_torch.launch.train --arch dlrm-mlperf \\
        --max-ind-range 4194304 --batch 65536 --steps 100
    python -m repro_torch.launch.train --arch dlrm-mlperf --reduced \\
        --steps 3 --log-every 1 --device cpu
    python -m repro_torch.launch.train --scenario smoke [--obs]

Without ``--device cpu`` they run on the CUDA card (and raise where there is
none); ``--device cpu`` runs the kernels' plain PyTorch versions on the CPU.
``--scenario`` runs a named arch x dataset x policy x mode matrix
(``launch/scenarios.py``) and writes its reports under
``artifacts/torch/scenarios/``; ``--schedule overlap`` issues each halo
exchange on a side CUDA stream (``dist/overlap.py``). LM parameters are
float32 from a seeded generator; prompts are random tokens from the same
seed. An LM without ``--serve`` trains (``train_lm``, the reference's):
Adam at ``--lr`` for ``--steps`` batches of ``token_stream`` through the
``Prefetcher``, every layer recomputed in the backward, the attention's
gradient on the flash backward kernels. Every LM of the registry
(granite-3-2b, yi-34b, olmoe-1b-7b, deepseek-v2-236b, gemma2-27b) trains
and serves; at their full configs deepseek-v2-236b, gemma2-27b and yi-34b
do not fit one 80 GB card in float32 (to serve; with gradients and Adam's
moments, neither does olmoe-1b-7b). MeshGraphNet, SchNet and NequIP read
edge geometry, computed on the host after the self-loops are added (random
positions from seed 0 where the graph has none). DLRM trains
(``train_dlrm``, the reference's, whatever ``--serve`` says): Adam at
``--lr`` for ``--steps`` batches of ``criteo_stream`` through the
``Prefetcher``, whose worker also builds each batch's id CSR (the table
gradient's plan). Its published tables (96 GB in float32) fit no card;
``--max-ind-range N`` caps every table at N rows, as the upstream DLRM's
flag of that name does (2^22 leaves 12.8 GB a copy, 51.3 GB with the
gradient and Adam's moments).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import configs as configlib
from ..dist.runtime import resolve_device
from ..models.lm import model as LM
from ..models.lm.config import LMConfig


@dataclasses.dataclass(frozen=True)
class Generation:
    tokens: np.ndarray          # (batch, new) greedy tokens
    prefill_s: float            # host seconds, ending in a device sync
    decode_s: float             # the new - 1 decode steps, likewise


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params: dict, cfg: LMConfig, prompts: np.ndarray, new: int,
             device=None) -> Generation:
    """Greedy generation as the reference's ``serve_lm``: one prefill over
    the prompts followed by ``new`` zero tokens (the cache holds the whole
    horizon), whose last-position argmax is the first new token, then
    ``new - 1`` decode steps at positions ``len(prompt) + i``."""
    dev = torch.device(device) if device is not None \
        else params["embed"].device
    b, s_ctx = prompts.shape
    prefill = LM.make_prefill_step(cfg, b, s_ctx + new)
    decode = LM.make_decode_step(cfg)
    tokens = torch.zeros((b, s_ctx + new), dtype=torch.long, device=dev)
    tokens[:, :s_ctx] = torch.as_tensor(prompts, dtype=torch.long)
    t0 = time.perf_counter()
    last, caches = prefill(params, tokens)
    tok = last.argmax(-1)[:, None]
    _sync(dev)
    t1 = time.perf_counter()
    out = [tok]
    for i in range(new - 1):
        lg, caches = decode(params, caches, tok, s_ctx + i)
        tok = lg.argmax(-1)[:, None]
        out.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    return Generation(torch.cat(out, 1).cpu().numpy(), t1 - t0, t2 - t1)


def serve_lm(args) -> Generation:
    dev = resolve_device(args.device)
    spec = configlib.get(args.arch)
    cfg = spec.reduced() if args.reduced else spec.config()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = LM.init_params(cfg, gen, dtype=torch.float32)
    b, s_ctx, new = args.batch, args.seq, args.decode_tokens
    prompts = np.random.default_rng(args.seed).integers(0, cfg.vocab,
                                                        (b, s_ctx))
    res = generate(params, cfg, prompts, new, dev)
    print(f"{cfg.name} on {dev}: prefill {b}x{s_ctx + new} tokens in "
          f"{res.prefill_s * 1e3:.1f} ms")
    print(f"decoded {b}x{new} tokens, "
          f"{b * (new - 1) / max(res.decode_s, 1e-9):.1f} tok/s")
    print("sample:", res.tokens[0][:16])
    return res


def train_lm(args) -> list:
    """The reference's ``train_lm``: float32 parameters from the seed, Adam
    at ``args.lr``, ``args.steps`` batches of ``token_stream`` (batch x
    seq) through a ``Prefetcher`` onto the device. Prints the step lines
    and the final loss as the reference does; returns the losses."""
    from ..data.pipeline import Prefetcher, token_stream
    from ..train import optimizer as optlib

    dev = resolve_device(args.device)
    spec = configlib.get(args.arch)
    cfg = spec.reduced() if args.reduced else spec.config()
    opt = optlib.adam(args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = LM.init_params(cfg, gen, dtype=torch.float32)
    state = (params, opt.init(params),
             torch.zeros((), dtype=torch.int32, device=dev))
    step_fn = LM.make_train_step(cfg, opt)
    stream = Prefetcher(token_stream(cfg.vocab, args.batch, args.seq,
                                     args.seed, n_batches=args.steps),
                        device=dev)
    losses = []
    t0 = time.perf_counter()
    for i, (tok, lab) in enumerate(stream):
        state, loss = step_fn(state, tok, lab)
        losses.append(loss)
        if (i + 1) % args.log_every == 0:
            print(f"step {i + 1:5d} loss {float(loss):.4f} "
                  f"({(i + 1) * args.batch * args.seq / (time.perf_counter() - t0):.0f}"
                  f" tok/s)")
    losses = [float(x) for x in losses]
    print(f"final loss {losses[-1]:.4f}" if losses else "no steps")
    return losses


def train_dlrm(args, on_step=None) -> list:
    """The reference's ``train_dlrm``: dense parameters and the table from
    ``args.seed``, Adam at ``args.lr``, ``args.steps`` batches of
    ``criteo_stream`` through a ``Prefetcher`` (its worker builds each
    batch's id plan), one noise generator a step from the seed and the
    step index. Prints the step lines and the final loss as the reference
    does; ``on_step(i, loss)`` is called after each step. Returns the
    losses."""
    from ..data.pipeline import Prefetcher, criteo_stream
    from ..models.recsys import dlrm as D
    from ..train import optimizer as optlib

    dev = resolve_device(args.device)
    spec = configlib.get(args.arch)
    cfg = D.capped(spec.reduced() if args.reduced else spec.config(),
                   args.max_ind_range)
    opt = optlib.adam(args.lr)
    dp, tb = D.init_params(cfg, args.seed, dev)
    state = (dp, tb, opt.init(dp), opt.init(tb),
             torch.zeros((), dtype=torch.int32, device=dev))
    step = D.make_train_step(cfg, opt)
    stream = Prefetcher(D.with_plans(criteo_stream(
        cfg, args.batch, args.seed, n_batches=args.steps)), device=dev)
    losses = []
    for i, (dense, ids, label, plan) in enumerate(stream):
        state, loss = step(state, dense, ids, label,
                           D.step_generator(args.seed, i, dev), plan)
        losses.append(loss)
        if on_step is not None:
            on_step(i, loss)
        if (i + 1) % args.log_every == 0:
            print(f"step {i + 1:5d} loss {float(loss):.4f}")
    losses = [float(x) for x in losses]
    print(f"final loss {losses[-1]:.4f}" if losses else "no steps")
    return losses


def build_policy(args):
    """CLI -> CommPolicy. ``--eps-s`` maps onto the BoundedStaleness policy;
    ``None`` leaves the ``Uniform`` policy of the config."""
    from .. import policy as P

    if args.eps_s is not None and args.policy not in ("uniform",
                                                      "bounded_staleness"):
        raise SystemExit(f"--eps-s conflicts with --policy {args.policy}; "
                         "it implies bounded_staleness")
    if args.policy == "warmup":
        return P.Warmup(epochs=args.warmup_epochs, bits=args.bits)
    if args.policy == "adaqp":
        return P.AdaQPVariance(budget_bits=args.bits)
    if args.policy == "bounded_staleness" or args.eps_s is not None:
        if args.eps_s is None:
            raise SystemExit("--policy bounded_staleness needs --eps-s N "
                             "(the cache-refresh period)")
        return P.BoundedStaleness(eps_s=args.eps_s, bits=args.bits)
    return None


def gnn_graph(arch, graph: str, parts: int, seed: int = 0):
    """The partitioned graph ``train_gnn`` trains ``arch`` (a ``GNNArch``)
    on: a named workload or a generator's defaults, self-loops and GCN
    weights added, then, when the arch reads geometry, each edge's
    ``geometry_edge_attr`` (random positions from ``default_rng(0)`` where
    the graph has none), as the reference's ``train_gnn`` does."""
    from .. import datasets
    from ..graph import formats, partition, synthetic
    from ..models.gnn.blocks import geometry_edge_attr

    if graph in synthetic.GENERATORS:          # raw generator, default kwargs
        g = synthetic.by_name(graph, seed=seed)
    else:                                      # named workload
        g = datasets.load(graph, seed=seed)
    g, ew = formats.gcn_normalize(g)
    if arch.d_edge_attr:
        if g.pos is None:
            rng = np.random.default_rng(0)
            g.pos = rng.normal(0, 1, (g.n_nodes, 3)).astype(np.float32)
        g.edge_attr = geometry_edge_attr(g)
    return partition.partition_graph(g, parts, edge_weight=ew)


def train_gnn(args):
    """Full-graph training of a registered GNN; returns the trainer."""
    from ..core.sylvie import SylvieConfig
    from ..train.trainer import GNNTrainer

    dev = resolve_device(args.device)
    spec = configlib.get(args.arch)
    arch = spec.reduced() if args.reduced else spec.config()
    pg = gnn_graph(arch, args.graph, args.parts, args.seed)
    model = arch.make(pg.x.shape[-1], pg.n_classes)
    cfg = SylvieConfig(mode=args.mode, bits=args.bits,
                       schedule=args.schedule or "blocking")
    tr = GNNTrainer(model, pg, cfg, policy=build_policy(args), device=dev,
                    seed=args.seed, ckpt_dir=args.ckpt_dir)
    if args.resume and tr.resume():
        print(f"resumed at epoch {tr.epoch}")
    t0 = time.perf_counter()
    for _ in range(args.epochs):
        m = tr.train_epoch()
        if tr.epoch % args.log_every == 0:
            acc = tr.evaluate("val")
            print(f"epoch {m.epoch:4d} [{m.mode}] loss {m.loss:.4f} "
                  f"val {acc:.4f} comm {m.comm_payload_mb:.2f}MB "
                  f"(+{m.comm_ec_mb:.2f}MB ec) {m.seconds * 1e3:.1f}ms")
    print(f"test acc {tr.evaluate('test'):.4f}  ({args.epochs} epochs in "
          f"{time.perf_counter() - t0:.1f}s on {dev})")
    if args.ckpt_dir:
        tr.save()
    return tr


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help=f"architecture id (required unless --scenario): "
                         f"{sorted(configlib.REGISTRY)}")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-sized)")
    ap.add_argument("--serve", action="store_true",
                    help="LM: batched prefill + greedy decode")
    # scenario-matrix runner (repro_torch.launch.scenarios)
    ap.add_argument("--scenario", default=None,
                    help="run a named arch x dataset x policy x mode matrix "
                         "end to end (smoke | policies | paper | "
                         "chaos_smoke); writes "
                         "artifacts/torch/scenarios/<name>/*.json")
    ap.add_argument("--only", default=None,
                    help="with --scenario: substring filter over cell ids")
    ap.add_argument("--scenario-dir", default=None,
                    help="with --scenario: report directory override")
    ap.add_argument("--obs", action="store_true",
                    help="with --scenario: arm span tracing per cell and "
                         "write artifacts/torch/obs/<name>/<cell>."
                         "{trace,metrics}.json (render: python -m "
                         "repro_torch.obs summarize)")
    ap.add_argument("--obs-dir", default=None,
                    help="with --scenario --obs: obs artifact directory "
                         "override")
    # GNN
    ap.add_argument("--graph", default="planted",
                    help="named workload ('reddit_like@paper', see "
                         "repro_torch.datasets.names()) or generator name")
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--mode", default="sync",
                    choices=["vanilla", "sync", "async"])
    ap.add_argument("--bits", type=int, default=1)
    ap.add_argument("--schedule", default=None,
                    choices=["blocking", "overlap"],
                    help="halo-exchange schedule: blocking, or issue/land "
                         "with each exchange on a side CUDA stream "
                         "(dist/overlap.py; bit-equal to blocking). With "
                         "--scenario, overrides the scenario's schedule for "
                         "every cell")
    ap.add_argument("--policy", default="uniform",
                    choices=["uniform", "warmup", "bounded_staleness",
                             "adaqp"],
                    help="per-epoch communication schedule; adaqp treats "
                         "--bits as the budget")
    ap.add_argument("--warmup-epochs", type=int, default=5)
    ap.add_argument("--eps-s", type=int, default=None,
                    help="cache-refresh period (implies bounded_staleness)")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    # LM / DLRM
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--decode-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-ind-range", type=int, default=None,
                    help="DLRM: cap every table at this many rows (ids are "
                         "taken modulo the capped size); default: the "
                         "published sizes")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; default: the "
                         "CUDA card")
    args = ap.parse_args(argv)

    if args.scenario:
        from .scenarios import run_scenario
        run_scenario(args.scenario, only=args.only,
                     out_dir=args.scenario_dir, schedule=args.schedule,
                     obs_trace=args.obs, obs_dir=args.obs_dir,
                     device=resolve_device(args.device))
        return
    if args.arch is None:
        ap.error("--arch is required (or pass --scenario)")
    kind = configlib.get(args.arch).kind
    if kind == "gnn":
        train_gnn(args)
    elif kind == "lm":
        serve_lm(args) if args.serve else train_lm(args)
    else:
        train_dlrm(args)


if __name__ == "__main__":
    main()
