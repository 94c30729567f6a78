"""End-to-end launcher of the port: batched LM serving (prefill + greedy
decode), as ``python -m repro.launch.train --arch <lm> --serve`` does.

    python -m repro_torch.launch.train --arch granite-3-2b --serve
    python -m repro_torch.launch.train --arch granite-3-2b --serve --reduced \\
        --device cpu

The first runs the full published config on the CUDA card; ``--device cpu``
runs the plain PyTorch versions on the CPU. Parameters are float32 from a
seeded generator; prompts are random tokens from the same seed. GNN, LM and
DLRM training and ``--scenario`` are not ported yet (ROADMAP queue A).
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

NOT_PORTED = "not ported yet (ROADMAP queue A)"


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help=f"architecture id; the port runs "
                         f"{sorted(configlib.REGISTRY)}")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-sized)")
    ap.add_argument("--serve", action="store_true",
                    help="LM: batched prefill + greedy decode")
    ap.add_argument("--scenario", default=None, help=NOT_PORTED)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--decode-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; default: the "
                         "CUDA card")
    args = ap.parse_args(argv)

    if args.scenario:
        raise SystemExit(f"--scenario: {NOT_PORTED}")
    if args.arch is None:
        ap.error("--arch is required")
    if args.arch not in configlib.REGISTRY:
        raise SystemExit(f"--arch {args.arch}: {NOT_PORTED}; the port runs "
                         f"{sorted(configlib.REGISTRY)} with --serve")
    if not args.serve:
        raise SystemExit(f"LM training: {NOT_PORTED}; pass --serve")
    serve_lm(args)


if __name__ == "__main__":
    main()
