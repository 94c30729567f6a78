"""Kill-and-resume chaos harness: preemption-safe training, proven end to
end, as ``repro.launch.chaos``.

Three entry points (one module, so the worker ships with its orchestrator):

* ``--worker`` — internal: build a :class:`~repro_torch.train.trainer
  .GNNTrainer` with a per-epoch checkpoint cadence and train to
  ``--epochs``. With ``--kill-at K`` the worker SIGKILLs *itself* right after
  training epoch K, **before** saving it — and first drops a fake
  ``.tmp_step_*`` orphan in the checkpoint directory, so the resume leg also
  proves the crash-orphan GC (``checkpoint.latest_step``). With ``--resume``
  it restores the latest checkpoint first. It prints whether its partition
  came from the plan cache (``plan cache hit: ...``).
* ``--kill-resume`` — orchestrate the proof: a reference run
  (uninterrupted), a chaos run killed at a *seeded* epoch, the resumed run to
  completion; then compare the two final checkpoints leaf by leaf. Under the
  ``uniform`` policy and ``sync`` mode the comparison is **bit-exact** (epoch
  noise streams are a function of (seed, epoch), and the whole training
  state rides the checkpoint); other points report the largest leaf
  deviation.
* ``--ci`` — the chaos gate: bit-exact kill-and-resume on
  ``yelp_like@smoke`` and the ``chaos_smoke`` scenario matrix with the fault
  accounting (``faults_injected == halos_reused + forced_syncs``) asserted
  on every cell.

The worker command is ``python -m repro_torch.launch.chaos --worker`` and
gets ``--device`` (default: the CUDA card). SIGKILL, not SIGTERM: *no*
cleanup code runs — exactly a preemption — and the atomic checkpoint layout
and the orphan GC still recover.

``--runtime sharded --dist-backend gloo|nccl`` makes every leg a P-process
job: the worker spawns one process per partition (``dist.spawn``), rank 0
reads and writes the plan cache and the checkpoints (gathered from every
rank), and a killed leg SIGKILLs the worker and all its ranks.

    python -m repro_torch.launch.chaos --kill-resume --device cpu
    python -m repro_torch.launch.chaos --kill-resume --device cpu \\
        --runtime sharded --dist-backend gloo
    python -m repro_torch.launch.chaos --kill-resume \\
        --dataset reddit_like@paper --epochs 4          # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2]
WORKER = "repro_torch.launch.chaos"


def _build_trainer(args):
    import torch
    import torch.distributed as dist

    from .. import datasets
    from ..core.sylvie import SylvieConfig
    from ..dist.runtime import Runtime
    from ..models.gnn.models import PAPER_ARCHS as ARCHS
    from ..train.trainer import GNNTrainer
    from .scenarios import parse_fault, parse_policy

    sharded = args.runtime == "sharded"
    runtime = Runtime.sharded(args.parts, device=args.device) if sharded \
        else Runtime.simulated(args.parts, device=args.device)
    pg, hit = datasets.load_partitioned(
        args.dataset, args.parts, seed=args.seed, cache_dir=args.plan_cache,
        group=dist.group.WORLD if sharded else None)
    if runtime.rank in (None, 0):
        print(f"plan cache hit: {str(hit).lower()}", flush=True)
    model = ARCHS[args.arch](pg.x.shape[-1], pg.n_classes,
                             generator=torch.Generator().manual_seed(args.seed))
    return GNNTrainer(model, pg, SylvieConfig(mode=args.mode),
                      policy=parse_policy(args.policy), runtime=runtime,
                      seed=args.seed, ckpt_dir=args.ckpt, ckpt_every=1,
                      keep=args.keep, fault_plan=parse_fault(args.fault))


def _worker(args) -> int:
    if args.runtime == "sharded":
        import importlib

        from ..dist.spawn import spawn

        # the ranks import the leg by the module's name, not as __main__
        leg = importlib.import_module(WORKER)._train_leg
        return spawn(leg, args.parts, device=args.device,
                     dist_backend=args.dist_backend, args=(args,))
    return _train_leg(args)


def _train_leg(args) -> int:
    """One leg, in the worker or (sharded) in each of its ranks."""
    tr = _build_trainer(args)
    if args.resume and not tr.resume():
        print("worker: --resume but no checkpoint found", file=sys.stderr)
        return 2
    lead = tr.rank in (None, 0)
    while tr.epoch < args.epochs:
        tr.train_epoch()
        if args.kill_at is not None and tr.epoch == args.kill_at:
            _crash(args, tr)
        tr.save()
    result = dict(epochs=tr.epoch,
                  losses=[m.loss for m in tr.history],
                  test_acc=tr.evaluate("test"),
                  faults_injected=sum(m.faults_injected for m in tr.history),
                  halos_reused=sum(m.halos_reused for m in tr.history),
                  forced_syncs=sum(m.forced_syncs for m in tr.history))
    if args.out and lead:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


def _crash(args, tr) -> None:
    """Simulate a crash mid-save: leave a partial tmp dir behind (the orphan
    the resume leg must GC), then die without cleanup — under a sharded
    runtime once every rank has trained the epoch, the worker and all its
    ranks."""
    sharded = tr.rank is not None
    if sharded:
        import torch.distributed as dist
        dist.barrier()
    if tr.rank in (None, 0):
        orphan = Path(args.ckpt) / f".tmp_step_{tr.epoch:08d}"
        orphan.mkdir(parents=True, exist_ok=True)
        (orphan / "arrays.npz").write_bytes(b"partial garbage")
    sys.stdout.flush()
    sys.stderr.flush()
    if sharded:
        dist.barrier()
        if tr.rank == 0:
            os.kill(os.getppid(), signal.SIGKILL)     # the worker
    os.kill(os.getpid(), signal.SIGKILL)


def _worker_cmd(args, ckpt: str, extra: list[str]) -> list[str]:
    cmd = [sys.executable, "-m", WORKER, "--worker",
           "--ckpt", ckpt, "--dataset", args.dataset,
           "--arch", args.arch, "--parts", str(args.parts),
           "--epochs", str(args.epochs), "--mode", args.mode,
           "--policy", args.policy, "--seed", str(args.seed),
           "--runtime", args.runtime, "--keep", str(args.keep)]
    if args.dist_backend:
        cmd += ["--dist-backend", args.dist_backend]
    if args.fault:
        cmd += ["--fault", args.fault]
    if args.device:
        cmd += ["--device", args.device]
    if args.plan_cache:
        cmd += ["--plan-cache", str(args.plan_cache)]
    return cmd + extra


def _run_worker(cmd: list[str], tmp: Path) -> subprocess.CompletedProcess:
    """Run one leg; its temporary files (a sharded leg's rendezvous, which
    a killed leg cannot remove) go under ``tmp``."""
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{SRC}{os.pathsep}" + env.get("PYTHONPATH", "")
    env["TMPDIR"] = str(tmp)
    return subprocess.run(cmd, env=env, capture_output=True, text=True)


def _cache_hit(leg: subprocess.CompletedProcess) -> bool:
    """The worker's ``plan cache hit: ...`` line."""
    for line in leg.stdout.splitlines():
        if line.startswith("plan cache hit: "):
            return line.split(": ", 1)[1] == "true"
    raise RuntimeError(f"worker printed no plan-cache line:\n{leg.stdout}\n"
                       f"{leg.stderr}")


def _final_arrays(ckpt_dir: str) -> dict[str, np.ndarray]:
    from ..train.checkpoint import latest_step
    step = latest_step(ckpt_dir)
    if step is None:
        raise RuntimeError(f"no checkpoint under {ckpt_dir}")
    with np.load(Path(ckpt_dir) / f"step_{step:08d}" / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


def kill_resume(args) -> dict:
    """Run the reference / killed / resumed legs; return the comparison
    (``plan_cache_hits`` gives each leg's plan-cache outcome, in order)."""
    if args.runtime == "sharded" and args.dist_backend is None:
        raise ValueError("--runtime sharded needs --dist-backend gloo|nccl")
    root = Path(args.out_dir) if args.out_dir else \
        Path(tempfile.mkdtemp(prefix="chaos_"))
    root.mkdir(parents=True, exist_ok=True)
    ref_dir, chaos_dir = str(root / "ref"), str(root / "chaos")
    kill_at = int(np.random.default_rng(args.seed).integers(
        2, max(3, args.epochs)))

    def check(ok: bool, what: str, leg=None):
        if not ok:
            tail = f":\n{leg.stdout}\n{leg.stderr}" if leg is not None else ""
            raise RuntimeError(f"kill-resume: {what}{tail}")

    tmp = root / "tmp"
    ref = _run_worker(_worker_cmd(args, ref_dir,
                                  ["--out", str(root / "ref.json")]), tmp)
    check(ref.returncode == 0, "reference run failed", ref)

    killed = _run_worker(_worker_cmd(args, chaos_dir,
                                     ["--kill-at", str(kill_at)]), tmp)
    check(killed.returncode == -signal.SIGKILL,
          f"expected SIGKILL death, got rc={killed.returncode}", killed)
    check(bool(list(Path(chaos_dir).glob(".tmp_step_*"))),
          "killed worker left no .tmp_step_* orphan")

    resumed = _run_worker(_worker_cmd(
        args, chaos_dir, ["--resume", "--out", str(root / "resumed.json")]),
        tmp)
    check(resumed.returncode == 0, "resumed run failed", resumed)
    check(not list(Path(chaos_dir).glob(".tmp_step_*")),
          "resume did not GC the crash orphan")

    a, b = _final_arrays(ref_dir), _final_arrays(chaos_dir)
    check(sorted(a) == sorted(b), "final checkpoints differ in structure")
    max_dev, exact = 0.0, True
    for k in a:
        if not np.array_equal(a[k], b[k]):
            exact = False
            if np.issubdtype(a[k].dtype, np.floating):
                max_dev = max(max_dev,
                              float(np.abs(a[k].astype(np.float64)
                                           - b[k].astype(np.float64)).max()))
            else:
                max_dev = float("inf")
    result = dict(kill_at=kill_at, bit_exact=exact, max_deviation=max_dev,
                  plan_cache_hits=[_cache_hit(leg)
                                   for leg in (ref, killed, resumed)],
                  ref=json.loads((root / "ref.json").read_text()),
                  resumed=json.loads((root / "resumed.json").read_text()))
    print(json.dumps({k: result[k] for k in
                      ("kill_at", "bit_exact", "max_deviation",
                       "plan_cache_hits")}, indent=1))
    return result


def _ci(args) -> int:
    from .scenarios import resolve, run_scenario

    # 1) bit-exact kill-and-resume where the policy lattice guarantees it
    kr = argparse.Namespace(
        dataset="yelp_like@smoke", arch="gcn", parts=4, epochs=5,
        mode="sync", policy="uniform:1", seed=0, runtime=args.runtime,
        dist_backend=args.dist_backend, fault=None, keep=3,
        out_dir=args.out_dir, device=args.device, plan_cache=args.plan_cache)
    result = kill_resume(kr)
    if not result["bit_exact"]:
        raise RuntimeError("uniform/sync kill-resume not bit-exact: "
                           f"{result['max_deviation']}")
    # 2) the chaos scenario matrix: completes under the seeded schedule and
    #    every injected fault is accounted for
    scn = dataclasses.replace(resolve("chaos_smoke"),
                              runtimes=(args.runtime,))
    for rep in run_scenario(scn, cache_dir=args.plan_cache,
                            device=args.device,
                            dist_backend=args.dist_backend):
        if rep["faults_injected"] != rep["halos_reused"] + \
                rep["forced_syncs"]:
            raise RuntimeError(
                f"{rep['cell']}: accounting broken ({rep['faults_injected']}"
                f" != {rep['halos_reused']} + {rep['forced_syncs']})")
        if rep["faults_injected"] <= 0:
            raise RuntimeError(f"{rep['cell']}: schedule inert")
    print("chaos ci: kill-resume bit-exact + scenario accounting OK")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.chaos",
        description="seeded kill-and-resume harness + chaos CI gate")
    ap.add_argument("--worker", action="store_true", help="internal")
    ap.add_argument("--kill-resume", action="store_true",
                    help="run the reference/killed/resumed proof")
    ap.add_argument("--ci", action="store_true", help="the chaos gate")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--dataset", default="yelp_like@smoke")
    ap.add_argument("--arch", default="gcn")
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--mode", default="sync")
    ap.add_argument("--policy", default="uniform:1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runtime", default="simulated",
                    choices=("simulated", "sharded"),
                    help="sharded: one process per partition (needs "
                         "--dist-backend)")
    ap.add_argument("--dist-backend", default=None, choices=("gloo", "nccl"),
                    help="the sharded runtime's torch.distributed backend: "
                         "nccl for a card per rank, gloo for the CPU or one "
                         "card")
    ap.add_argument("--fault", default=None,
                    help="scenarios.parse_fault spec, e.g. drop=0.15,seed=7")
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; default: the "
                         "CUDA card")
    ap.add_argument("--plan-cache", default=None,
                    help="partition-plan cache directory (default "
                         "artifacts/torch/plans)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.worker:
        if not args.ckpt:
            ap.error("--worker requires --ckpt")
        return _worker(args)
    if args.ci:
        return _ci(args)
    if args.kill_resume:
        kill_resume(args)
        return 0
    ap.error("pick one of --worker / --kill-resume / --ci")


if __name__ == "__main__":
    raise SystemExit(main())
