"""The benchmark of the PyTorch and CUDA port: full-graph Sylvie training,
timed by the epoch on one card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run, from the root of a checkout:

1. finds the cell (``bench/workloads/<cell>.json``), its configuration
   (``bench/configs/<config>.json``) and its traffic
   (``bench/traffic/<traffic>.json``) by name;
2. builds the port's kernels where the checkout has none yet (the port's
   ``kernels/build.py``, into ``build/kernels/``), then makes the graph and
   the weights from ``--seed`` on the card (``bench/lib/graphgen.py``,
   ``bench/reference/common.py``);
3. builds the program's set-up through its own entry points: the self-loops
   and weights of ``gcn_normalize``, ``partition_graph``, the model from the
   registry, ``GNNTrainer`` on ``Runtime.simulated(P)`` (the partitions
   stacked on one card);
4. runs the first training epochs, which the reference follows, as the
   warm-up (the traffic's ``warmup_epochs``): they run each step the cell
   uses, for Sylvie-A the synchronous refresh after asynchronous steps too;
5. times whole ``GNNTrainer.train_epoch`` calls for ``--seconds`` (each ends
   in the sync of its loss);
6. after the window: reads the peak memory, frees the program, runs the
   plain reference (``bench/reference/``) over the same first epochs and
   compares.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` profiles
the window and reports its per-layer metrics, each read by
``bench/metrics/<metric>.py``. The last line of standard output is the
result as one JSON object; the numbers compared, with their limits, end
both it and standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# top-level module names that the run must not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _setup_paths(root: Path) -> None:
    """The checkout's port and benchmark first on the path (the port's
    kernel build cache is ``build/kernels/`` inside the checkout)."""
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _load_json(root: Path, kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = root / "bench" / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> dict:
    """The cell by name, with its configuration and traffic resolved."""
    cell = _load_json(root, "workloads", name)
    cell["name"] = name
    cell["config_spec"] = _load_json(root, "configs", cell["config"])
    cell["traffic_spec"] = _load_json(root, "traffic", cell["traffic"])
    # the program and the reference both train under Adam, and nothing else
    if cell["config_spec"]["optimizer"] != "adam":
        raise ValueError(f"optimizer {cell['config_spec']['optimizer']!r}: "
                         "only 'adam' is implemented on both sides")
    return cell


def cell_metrics(root: Path, name: str) -> list:
    """The per-layer metrics that ``BENCHMARK.json`` gives this cell."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    return [m for m in bench["per_layer"]
            if "workloads" not in m or name in m["workloads"]]


def load_reader(root: Path, metric: str):
    """``bench/metrics/<metric>.py``'s ``read``."""
    if not NAME.match(metric):
        raise ValueError(f"bad metric name {metric!r}")
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_reference(model: str):
    """The plain reference of a model family: ``bench/reference/<model>``."""
    if not NAME.match(model) or "." in model:
        raise ValueError(f"bad model name {model!r}")
    return importlib.import_module(f"bench.reference.{model}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        else:
            out[key] = v
    return out


def build_program(cell: dict, data: dict, weights: dict, seed: int, device):
    """The program's set-up from the benchmark's graph (host arrays) and
    weights: ``(trainer, model)``."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.dist.runtime import Runtime
    from repro_torch.graph import formats, partition
    from repro_torch.policy.builtin import BoundedStaleness
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.trainer import GNNTrainer

    cfg, tr_spec = cell["config_spec"], cell["traffic_spec"]
    n, d_in = data["x"].shape
    g = formats.Graph(
        int(n), np.stack([data["src"], data["dst"]]).astype(np.int32),
        data["x"], data["y"].astype(np.int32), data["train_mask"],
        data["val_mask"], data["test_mask"],
        n_classes=int(cfg["n_classes"]))
    g, ew = formats.gcn_normalize(g)
    pg = partition.partition_graph(g, int(tr_spec["n_parts"]), edge_weight=ew)
    model = configs.get(cfg["arch"]).config().make(int(d_in),
                                                   int(cfg["n_classes"]))
    for key in ("d_hidden", "n_layers"):
        if getattr(model, key) != cfg[key]:
            raise ValueError(f"the registry's {cfg['arch']} has {key} "
                             f"{getattr(model, key)}, the configuration "
                             f"{cfg[key]}")
    named = dict(model.named_parameters())
    if {k: tuple(p.shape) for k, p in named.items()} != \
            {k: tuple(w.shape) for k, w in weights.items()}:
        raise ValueError("the program's parameters differ from the "
                         "reference's in names or shapes")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(weights[k].to(p.device))
    sc = SylvieConfig(mode=tr_spec["mode"], bits=int(tr_spec["bits"]),
                      stochastic=bool(tr_spec["stochastic"]))
    policy = None
    if tr_spec.get("eps_s") is not None:
        policy = BoundedStaleness(eps_s=int(tr_spec["eps_s"]),
                                  bits=int(tr_spec["bits"]),
                                  stochastic=bool(tr_spec["stochastic"]))
    opt = optlib.adam(float(cfg["lr"]))
    tr = GNNTrainer(model, pg, sc, opt=opt, policy=policy,
                    runtime=Runtime.simulated(int(tr_spec["n_parts"]),
                                              device=device),
                    seed=seed)
    return tr, model


def first_epochs(tr, n_epochs: int, b1: float = 0.9) -> dict:
    """Run the program's first epochs through ``train_epoch`` and keep what
    the reference is compared with: each epoch's loss, the first gradient
    worked out from Adam's first moment after one step, and the parameters
    after the last."""
    out = {"losses": []}
    for t in range(n_epochs):
        out["losses"].append(tr.train_epoch().loss)
        if t == 0:
            out["grad0"] = {k: v.detach().clone() / (1 - b1) for k, v in
                            _flat(tr.state.opt_state["m"]).items()}
    out["params"] = {k: v.detach().clone() for k, v in
                     _flat(tr.state.params).items()}
    return out


def reference_epochs(cell: dict, data: dict, weights: dict, seed: int,
                     device, dtype=None) -> dict:
    """The plain reference's warm-up epochs on the same inputs, in float32
    (or ``dtype``: the limits' readings take float64 as a witness)."""
    import torch
    from bench.reference import common as R
    cfg, tr_spec = cell["config_spec"], cell["traffic_spec"]
    mod = load_reference(cfg["family"])
    dtype = dtype or torch.float32
    weights = {k: w.to(dtype) for k, w in weights.items()}
    graph = R.Graph.from_data(data, device, dtype)
    plan = R.Plan.build(graph.src, graph.dst, graph.n,
                        int(tr_spec["n_parts"]))
    model = mod.Model(cfg, int(data["x"].shape[1]), int(cfg["n_classes"]))
    return R.train_steps(model, graph, plan, weights,
                         mode=tr_spec["mode"], bits=int(tr_spec["bits"]),
                         eps_s=tr_spec.get("eps_s"),
                         lr=float(cfg["lr"]), seed=seed,
                         steps=int(tr_spec["warmup_epochs"]))


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        root: Path = ROOT) -> dict:
    """One run of ``cell``; returns the result object."""
    import torch
    from bench.lib import flops, graphgen
    from bench.lib import trace as T
    from bench.reference import common as R
    from bench.reference import compare
    from repro_torch import obs

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    cfg, tr_spec = cell["config_spec"], cell["traffic_spec"]
    marks = [("start", time.perf_counter() - T_START)]
    if on_card:
        # the port's kernels are built (where the checkout has not yet
        # built them) before the host holds the graph and the program
        from repro_torch.kernels import build
        build.build_all()
        marks.append(("kernels", time.perf_counter() - T_START))
    data = {k: v.cpu().numpy() for k, v in
            graphgen.generate(cfg, seed, dev).items()}
    marks.append(("graph", time.perf_counter() - T_START))
    d_in, n_classes = data["x"].shape[1], int(cfg["n_classes"])
    ref_model = load_reference(cfg["family"]).Model(cfg, d_in, n_classes)
    weights = R.glorot_params(ref_model.param_shapes(), seed, dev)
    tr, model = build_program(cell, data, weights, seed, dev)
    marks.append(("program", time.perf_counter() - T_START))
    prog = first_epochs(tr, int(tr_spec["warmup_epochs"]))
    setup_s = time.perf_counter() - T_START
    marks.append(("warm-up", setup_s))

    recorder = T.CallRecorder()
    dtrace = T.DeviceTrace() if trace and on_card else None
    events = T.EpochEvents() if dtrace else None
    notes = []
    if dtrace:
        # the profiler's device tracing is set up before the window
        problem = T.DeviceTrace.warm_up()
        if problem:
            notes.append(problem)
    wire, spans, failed, n, traced = [], [], 0, 0, None
    with contextlib.ExitStack() as stack:
        if trace:
            obs.enable()
            stack.callback(obs.disable)
            stack.enter_context(recorder)
        if dtrace:
            stack.enter_context(dtrace)
        t0 = time.perf_counter()
        while True:
            ev = events.start() if events else None
            m = tr.train_epoch()
            if events:
                events.stop(ev)
            n += 1
            failed += not math.isfinite(m.loss)
            t1 = time.perf_counter()
            if trace:
                wire.append(sum(tr.wire_bytes_per_epoch()))
            if t1 - t0 >= seconds:
                break
        if trace:
            spans = [ev for ev in obs.drain() if ev["ts"] >= t0]
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run holds modules it must not: {found}")

    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    result = {"correct": False, "attempted": n, "failed": failed}
    if not trace:
        result["metrics"] = {
            "epoch_ms": {"value": (t1 - t0) / n * 1e3, "unit": "ms"},
            "peak_gb": {"value": peak / 1e9, "unit": "GB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    else:
        n_real = int(data["x"].shape[0])
        e_real = int(data["src"].shape[0]) + n_real      # with self-loops
        traced = T.TracedRun(
            ops=dtrace.ops if dtrace else [], spans=spans, t0=t0, t1=t1,
            n_epochs=n, wire_bytes=wire, calls=recorder.calls,
            flops_per_epoch=flops.gnn_train_flops(
                cfg["family"], n_real, e_real, d_in, int(cfg["d_hidden"]),
                n_classes, int(cfg["n_layers"])),
            peaks=T.peaks(kind))
        if dtrace and dtrace.problem:
            notes.append(dtrace.problem)
        metrics = {}
        for spec in cell_metrics(root, cell["name"]):
            try:
                value = load_reader(root, spec["name"])(traced)
            except Exception as e:  # reported; the metric is left out
                notes.append(f"reader {spec['name']} failed: {e!r}")
                continue
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
        result["metrics"] = metrics
        if dtrace and dtrace.ops:
            result["breakdown"] = T.breakdown(traced)
    result["device"] = {
        "platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    if dtrace:
        if dtrace.ops:
            busy = T.union_seconds([(s, e) for _, s, e in dtrace.ops], t0, t1)
        else:
            busy = events.seconds()
            notes.append("busy_s from CUDA events around each epoch (the "
                         "host's gaps inside an epoch count as busy)")
        result["device"].update(busy_s=busy, window_s=t1 - t0)

    # the program's state goes before the reference runs (the recorded
    # calls hold its CSRs)
    del tr, model, recorder, traced
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = reference_epochs(cell, data, weights, seed, dev)
    gaps = compare.training_gaps(prog, ref, weights)
    ok, checks = compare.judge(gaps, cell["limits"])
    result["correct"] = bool(ok and failed == 0)
    result["setup_marks"] = marks
    result["trace_notes"] = notes
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_paths(ROOT)
    cell = load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"the run holds modules it must not: {found}", file=sys.stderr)
        return 3
    print("set-up, seconds since start: " + ", ".join(
        f"{k} {v:.2f}" for k, v in result["setup_marks"]), file=sys.stderr)
    for note in result["trace_notes"]:
        print(f"trace: {note}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
