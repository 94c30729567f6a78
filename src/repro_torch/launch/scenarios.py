"""Scenario-matrix runner: declarative arch x dataset x policy x mode sweeps
over the named-workload registry, as ``repro.launch.scenarios``.

A :class:`Scenario` declares the axes; :func:`run_scenario` expands the cross
product, drives one :class:`~repro_torch.train.trainer.GNNTrainer` per cell
(graphs come from :func:`repro_torch.datasets.load_partitioned`, so repeated
runs hit the partition-plan cache), and writes one report JSON per cell under
``artifacts/torch/scenarios/<scenario>/`` plus a ``summary.json`` (schema:
DESIGN.md §9). CLI::

    python -m repro_torch.launch.train --scenario smoke [--obs]
    python -m repro_torch.launch.train --scenario smoke --device cpu

Policy axis entries are compact specs (``parse_policy``): ``uniform:BITS``,
``warmup:EPOCHS:BITS``, ``bounded_staleness:EPS_S:BITS``, ``adaqp:BUDGET``.
Arch names resolve through ``models.gnn.models.PAPER_ARCHS`` (the
reference's widths), so a port report and a reference report of one cell are
one model. The runtime axis takes ``simulated`` (the whole stack on one
device: the CUDA card unless ``device="cpu"``) and ``sharded`` (one process
per partition, started by ``dist.spawn`` over the ``dist_backend`` the
caller names; ``device=None`` is a card per rank, ``"cuda:0"`` every rank on
one card, which needs ``gloo``). A sharded cell's report is rank 0's, with
the simulated cell's keys.

The report's key set is the reference's with one change: the modeled comm
time is the card's — ``modeled_comm_s``, ``modeled_comm_exposed_s`` and
``modeled_comm_overlapped_s`` over NVLink and the BF16 peak of
``launch/hardware.py`` — where the reference's keys say ``modeled_tpu_``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from pathlib import Path
from typing import Optional

import torch

from .. import datasets
from .. import obs
from .. import policy as P
from ..core.sylvie import SylvieConfig
from ..dist.runtime import Runtime
from ..faults import FaultPlan
from ..models.gnn.models import PAPER_ARCHS as ARCHS
from ..obs import export as obs_export
from ..train.trainer import GNNTrainer
from .cells import _gnn_model_flops
from .hardware import NVLINK_BW, PEAK_FLOPS_BF16

def parse_policy(spec: str):
    """Compact policy spec -> CommPolicy. ``uniform:32``, ``warmup:5:1``,
    ``bounded_staleness:4:1``, ``adaqp:4``."""
    kind, *args = spec.split(":")
    a = [int(x) for x in args]
    if kind == "uniform":
        return P.Uniform(bits=a[0] if a else 1)
    if kind == "warmup":
        return P.Warmup(epochs=a[0] if a else 5, bits=a[1] if len(a) > 1 else 1)
    if kind == "bounded_staleness":
        return P.BoundedStaleness(eps_s=a[0] if a else None,
                                  bits=a[1] if len(a) > 1 else 1)
    if kind == "adaqp":
        return P.AdaQPVariance(budget_bits=a[0] if a else 4)
    raise KeyError(f"unknown policy spec {spec!r}; known kinds: uniform, "
                   "warmup, bounded_staleness, adaqp")


def parse_fault(spec: Optional[str]) -> Optional[FaultPlan]:
    """Compact fault spec -> :class:`~repro_torch.faults.FaultPlan` (None ->
    None). Comma-separated ``key=value`` pairs, e.g.
    ``"drop=0.15,corrupt=0.05,seed=7,escalate=3"``. Keys: ``drop``,
    ``corrupt``, ``delay``, ``preempt`` (rates), ``delay_s`` (seconds),
    ``seed``, ``escalate`` (epochs)."""
    if spec is None or spec == "":
        return None
    keys = {"drop": ("drop_rate", float), "corrupt": ("corrupt_rate", float),
            "delay": ("delay_rate", float), "preempt": ("preempt_rate", float),
            "delay_s": ("delay_s", float), "seed": ("seed", int),
            "escalate": ("escalate_after", int)}
    kw = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        if k not in keys:
            raise KeyError(f"unknown fault key {k!r} in {spec!r}; "
                           f"known: {sorted(keys)}")
        name, cast = keys[k]
        kw[name] = cast(v)
    return FaultPlan(**kw)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One point of the matrix. ``cell_id`` names the report file."""

    arch: str
    dataset: str                        # registry ref, "name@tier"
    policy: str                         # parse_policy spec
    mode: str                           # "sync" | "async" | "vanilla"
    runtime: str                        # "simulated" | "sharded"

    @property
    def cell_id(self) -> str:
        pol = self.policy.replace(":", "-")
        return f"{self.arch}__{self.dataset}__{pol}__{self.mode}" \
               f"__{self.runtime}"


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A declarative arch x dataset x policy x mode x runtime matrix.
    ``fault`` is a :func:`parse_fault` spec applied to every cell (None:
    fault-free); ``schedule`` the exchange schedule of every cell (a scalar,
    not an axis: cell ids stay stable)."""

    name: str
    archs: tuple[str, ...]
    datasets: tuple[str, ...]
    policies: tuple[str, ...]
    modes: tuple[str, ...] = ("sync",)
    runtimes: tuple[str, ...] = ("simulated",)
    parts: int = 4
    epochs: int = 3
    seed: int = 0
    fault: Optional[str] = None
    schedule: str = "blocking"

    def cells(self) -> tuple[Cell, ...]:
        """The expanded cross product, in deterministic order."""
        return tuple(Cell(a, d, p, m, r) for a, d, p, m, r
                     in itertools.product(self.archs, self.datasets,
                                          self.policies, self.modes,
                                          self.runtimes))


SCENARIOS: dict[str, Scenario] = {
    # CI-sized: 2 archs x 2 datasets x 2 policies, 8 cells.
    "smoke": Scenario(
        name="smoke",
        archs=("gcn", "graphsage"),
        datasets=("yelp_like@smoke", "products_like@smoke"),
        policies=("uniform:1", "warmup:2:1"),
        parts=4, epochs=3),
    # Policy sweep on the two benchmark reference graphs.
    "policies": Scenario(
        name="policies",
        archs=("graphsage",),
        datasets=("yelp_like@small", "products_like@small"),
        policies=("uniform:32", "uniform:4", "uniform:1", "warmup:5:1",
                  "bounded_staleness:4:1", "adaqp:4"),
        modes=("sync", "async"),
        parts=8, epochs=40),
    # The paper-shaped full matrix (run cells with --only).
    "paper": Scenario(
        name="paper",
        archs=("gcn", "graphsage", "gat"),
        datasets=("reddit_like@small", "yelp_like@small",
                  "products_like@small", "amazon_like@small"),
        policies=("uniform:32", "uniform:1", "adaqp:4"),
        modes=("sync", "async"),
        parts=8, epochs=40),
    # The chaos gate: the smoke workload under a seeded fault schedule that
    # drops or corrupts well over 10% of halo exchanges
    # (``python -m repro_torch.launch.chaos --ci`` asserts the accounting on
    # every cell report).
    "chaos_smoke": Scenario(
        name="chaos_smoke",
        archs=("gcn",),
        datasets=("yelp_like@smoke",),
        policies=("uniform:1", "bounded_staleness:4:1"),
        modes=("sync", "async"),
        parts=4, epochs=6,
        fault="drop=0.15,corrupt=0.05,seed=7"),
}


def default_out_dir() -> Path:
    """``<repo>/artifacts/torch/scenarios`` (never the reference's
    ``artifacts/scenarios``)."""
    return Path(__file__).resolve().parents[3] / "artifacts" / "torch" \
        / "scenarios"


# Cell reports are versioned: v2 = v1 + {schema_version, obs, trace_path}.
REPORT_SCHEMA_VERSION = 2

REPORT_KEYS = frozenset({
    "schema_version", "scenario", "cell", "arch", "dataset", "policy",
    "policy_spec", "mode", "runtime", "n_parts", "epochs", "seed",
    "plan_cache_hit", "final_loss", "val_acc", "test_acc",
    "comm_payload_bytes_per_epoch", "comm_ec_bytes_per_epoch",
    "wire_payload_bytes_per_epoch", "wire_ec_bytes_per_epoch",
    "modeled_comm_s", "schedule", "modeled_comm_exposed_s",
    "modeled_comm_overlapped_s", "bits_per_site", "seconds", "fault",
    "faults_injected", "halos_reused", "forced_syncs", "stall_s",
    "obs", "trace_path",
})


def run_cell(scn: Scenario, cell: Cell, *,
             cache_dir: Optional[Path] = None,
             loaded: Optional[dict] = None,
             obs_dir: Optional[Path] = None, device=None,
             dist_backend: Optional[str] = None) -> dict:
    """Train one cell and return its report dict (not yet written).

    ``loaded`` memoizes partitioned graphs within one run: cells sharing a
    dataset reuse the first load, and their ``plan_cache_hit`` reports that
    load's disk outcome. ``obs_dir`` arms span tracing for this cell (the
    metrics registry reset, the tracer on for the whole train/eval) and
    writes ``<obs_dir>/<cell_id>.trace.json`` (Perfetto) and
    ``<cell_id>.metrics.json``; the ``obs`` block (measured wall per epoch
    against the modeled exposed/overlapped comm) is in every report.
    ``device`` is the runtime's (``None``: the CUDA card; a card per rank
    for a sharded cell). A sharded cell runs in ``scn.parts`` processes
    over ``dist_backend`` (``"gloo"`` or ``"nccl"``, which it needs; rank 0
    writes the trace). Weights come from a generator seeded with the
    scenario's seed."""
    if cell.runtime == "sharded":
        if dist_backend is None:
            raise ValueError("a sharded cell needs dist_backend='gloo' or "
                             "'nccl'")
        from ..dist.spawn import spawn
        return spawn(_sharded_cell, scn.parts, device=device,
                     dist_backend=dist_backend,
                     args=(scn, cell, cache_dir, obs_dir, device))
    if cell.runtime != "simulated":
        raise KeyError(f"unknown runtime {cell.runtime!r}")
    key = (cell.dataset, scn.parts, scn.seed)
    if loaded is None or key not in loaded:
        entry = datasets.load_partitioned(
            cell.dataset, scn.parts, seed=scn.seed, cache_dir=cache_dir)
        if loaded is not None:
            loaded[key] = entry
    else:
        entry = loaded[key]
    return _train_cell(scn, cell, *entry,
                       Runtime.simulated(scn.parts, device=device), obs_dir)


def _sharded_cell(scn: Scenario, cell: Cell, cache_dir, obs_dir,
                  device) -> dict:
    """One rank of a sharded cell (runs inside ``dist.spawn``)."""
    import torch.distributed as dist
    runtime = Runtime.sharded(scn.parts, device=device)
    pg, cache_hit = datasets.load_partitioned(
        cell.dataset, scn.parts, seed=scn.seed, cache_dir=cache_dir,
        group=dist.group.WORLD)
    return _train_cell(scn, cell, pg, cache_hit, runtime,
                       obs_dir if runtime.rank == 0 else None)


def _train_cell(scn: Scenario, cell: Cell, pg, cache_hit: bool,
                runtime: Runtime, obs_dir: Optional[Path]) -> dict:
    model = ARCHS[cell.arch](pg.x.shape[-1], pg.n_classes,
                             generator=torch.Generator().manual_seed(scn.seed))
    policy = parse_policy(cell.policy)
    cfg = SylvieConfig(mode=cell.mode, schedule=scn.schedule)
    tr = GNNTrainer(model, pg, cfg, policy=policy, runtime=runtime,
                    seed=scn.seed, fault_plan=parse_fault(scn.fault))
    traced = obs_dir is not None
    if traced:
        obs.reset_metrics()
        obs.enable()
    try:
        t0 = obs.clock()
        tr.fit(scn.epochs)
        seconds = obs.clock() - t0
        pb, eb = tr.comm_bytes_per_epoch()
        wb, web = tr.wire_bytes_per_epoch()
        # DESIGN §8/§14 comm-time split: per-partition analytic FLOPs bound
        # each site's overlappable window; blocking exposes every comm second
        # (exposed + overlapped == modeled_comm_s in both schedules)
        n_nodes = int(pg.part_of.shape[0])
        n_edges = int(pg.edge_mask.sum())
        flops_per_part = _gnn_model_flops(cell.arch, model, n_nodes, n_edges,
                                          pg.x.shape[-1], True) / scn.parts
        exposed_s, overlapped_s = tr.modeled_comm_split(
            flops_per_part, PEAK_FLOPS_BF16, NVLINK_BW)
        val_acc = float(tr.evaluate("val"))
        test_acc = float(tr.evaluate("test"))
    finally:
        events = obs.drain()
        if traced:
            obs.disable()
    mm = obs_export.modeled_vs_measured(
        [m.wall_s for m in tr.history], exposed_s, overlapped_s)
    trace_path = None
    if traced:
        run_name = f"{scn.name}/{cell.cell_id}"
        trace_path = str(obs_export.write_trace(
            Path(obs_dir) / f"{cell.cell_id}.trace.json", events))
        obs_export.write_metrics(
            Path(obs_dir) / f"{cell.cell_id}.metrics.json",
            metrics=obs.snapshot(), run=run_name, merge=mm,
            trace_path=trace_path)
    return {
        "schema_version": REPORT_SCHEMA_VERSION,
        "scenario": scn.name, "cell": cell.cell_id,
        "arch": cell.arch, "dataset": cell.dataset,
        "policy": tr.policy.name, "policy_spec": cell.policy,
        "mode": cell.mode, "runtime": cell.runtime,
        "n_parts": scn.parts, "epochs": scn.epochs, "seed": scn.seed,
        "plan_cache_hit": bool(cache_hit),
        "final_loss": float(tr.history[-1].loss),
        "val_acc": val_acc,
        "test_acc": test_acc,
        # exact true-wire bytes per epoch (hardware-independent), what the
        # plan's layout ships, and the modeled comm time over NVLink
        "comm_payload_bytes_per_epoch": float(pb),
        "comm_ec_bytes_per_epoch": float(eb),
        "wire_payload_bytes_per_epoch": float(wb),
        "wire_ec_bytes_per_epoch": float(web),
        "modeled_comm_s": float((pb + eb) / scn.parts / NVLINK_BW),
        "schedule": scn.schedule,
        "modeled_comm_exposed_s": float(exposed_s),
        "modeled_comm_overlapped_s": float(overlapped_s),
        "bits_per_site": [list(b) for b in tr.history[-1].bits_per_site],
        "seconds": seconds,
        # chaos accounting (zeros when scn.fault is None); the invariant
        # faults_injected == halos_reused + forced_syncs is asserted by the
        # chaos gate (repro_torch.launch.chaos --ci)
        "fault": scn.fault,
        "faults_injected": int(sum(m.faults_injected for m in tr.history)),
        "halos_reused": int(sum(m.halos_reused for m in tr.history)),
        "forced_syncs": int(sum(m.forced_syncs for m in tr.history)),
        "stall_s": float(sum(m.stall_s for m in tr.history)),
        "obs": {"enabled": traced, "n_epochs": mm["n_epochs"],
                "mean_wall_s": mm["mean_wall_s"], "drift_s": mm["drift_s"]},
        "trace_path": trace_path,
    }


def resolve(scenario) -> Scenario:
    """Accept a Scenario or a name from :data:`SCENARIOS`."""
    if isinstance(scenario, Scenario):
        return scenario
    if scenario not in SCENARIOS:
        raise KeyError(f"unknown scenario {scenario!r}; "
                       f"known: {sorted(SCENARIOS)}")
    return SCENARIOS[scenario]


def run_scenario(scenario, *, out_dir: Optional[Path] = None,
                 cache_dir: Optional[Path] = None,
                 only: Optional[str] = None,
                 schedule: Optional[str] = None,
                 obs_trace: bool = False,
                 obs_dir: Optional[Path] = None, device=None,
                 dist_backend: Optional[str] = None) -> list[dict]:
    """Expand and run a scenario; one report JSON per cell + a summary.

    ``only`` is a substring filter over cell ids. A filtered run rewrites
    only its own cell reports; ``summary.json`` is rebuilt from *all* cell
    files on disk, so running a matrix slice by slice converges to the full
    summary. ``schedule`` overrides the scenario's exchange schedule for
    every cell. ``obs_trace`` arms span tracing per cell and writes
    ``<obs_dir>/<scenario>/<cell_id>.{trace,metrics}.json`` (default
    ``artifacts/torch/obs/``). ``dist_backend`` serves the sharded cells
    (see :func:`run_cell`)."""
    scn = resolve(scenario)
    if schedule is not None:
        scn = dataclasses.replace(scn, schedule=schedule)
    cells = [c for c in scn.cells() if only is None or only in c.cell_id]
    if not cells:
        raise ValueError(f"--only {only!r} matched no cell of {scn.name!r}")
    out = (Path(out_dir) if out_dir is not None else default_out_dir()) \
        / scn.name
    out.mkdir(parents=True, exist_ok=True)
    obs_out = None
    if obs_trace:
        obs_out = (Path(obs_dir) if obs_dir is not None
                   else obs_export.default_obs_dir()) / scn.name
    reports = []
    loaded: dict = {}
    for i, cell in enumerate(cells):
        t0 = obs.clock()
        rep = run_cell(scn, cell, cache_dir=cache_dir, loaded=loaded,
                       obs_dir=obs_out, device=device,
                       dist_backend=dist_backend)
        (out / f"{cell.cell_id}.json").write_text(
            json.dumps(rep, indent=1, default=float))
        reports.append(rep)
        print(f"[{i+1:3d}/{len(cells)}] {cell.cell_id:60s} "
              f"test={rep['test_acc']:.3f} "
              f"comm={rep['comm_payload_bytes_per_epoch']/1e6:7.2f}MB/ep "
              f"cache={'hit' if rep['plan_cache_hit'] else 'miss'} "
              f"{obs.clock()-t0:5.1f}s")
    if only is None:
        # a full run defines the matrix: drop cell files orphaned by a
        # scenario-definition change so the summary never resurrects them
        current = {f"{c.cell_id}.json" for c in cells}
        for f in out.glob("*.json"):
            if f.name != "summary.json" and f.name not in current:
                f.unlink()
    all_cells = [json.loads(f.read_text())
                 for f in sorted(out.glob("*.json")) if f.name != "summary.json"]
    (out / "summary.json").write_text(
        json.dumps({"scenario": scn.name, "n_cells": len(all_cells),
                    "cells": all_cells}, indent=1, default=float))
    print(f"wrote {len(reports)} cell reports; summary.json covers "
          f"{len(all_cells)} cells -> {out}")
    return reports
