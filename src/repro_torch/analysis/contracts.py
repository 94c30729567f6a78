"""Contract registry: run the port's real entry points under a census and
hold what they did to the reference's contracts
(``repro.analysis.contracts``).

The workload is the reference's: a 96-node ``planted_partition`` graph,
``skewed`` over 4 partitions (skewed so the ring buckets are ragged: a
symmetric graph would make the forward and inverted-backward shift
censuses identical and the ring-inversion check vacuous), ``alignment=4``,
GCN and GraphSAGE 8 wide, 2 layers, SGD 0.1. Where the reference traces an
entry point with ``jax.make_jaxpr``, a contract here runs it once under
:func:`~repro_torch.analysis.census.census` and checks what it did
(:mod:`.checks`).

Covered entry points (the reference's matrix, ``shard_map`` read as
``sharded``):

* the sync train step for GCN / GraphSAGE x dense / compact, sharded and
  simulated; the async train step and the eval step (GCN, compact,
  sharded) — RC201 / RC202 / RC203;
* the serve sweep (quantized forward + uint8 affected-mask rides, no
  all-reduce);
* the Low-bit Module's payload across the whole bit lattice (RC206; on CUDA
  it runs the quantize / dequantize kernels);
* the step-cache budget: K lattice decisions build K entries of
  ``GNNTrainer._step_cache`` and calling a step again builds nothing
  (RC204); one sweep function for a full sweep and a delta refresh, whose
  censuses are equal — the masks ride as data (RC204 / RC207);
* fault transparency: ``FaultyBackend`` with ``faults=None`` has the plain
  backend's census, and two armed epochs with different masks have one
  census (RC208);
* the overlap schedule: blocking's census with ``async_op=True`` exchanges
  plus one ``fence`` per issue (RC209a), inside the RC204 budget (RC209b);
* observability transparency: the census of the overlap steps and the
  serve sweep is the same with ``obs.enable()`` and without (RC210).

The ``/sharded`` contracts need an initialized ``torch.distributed`` group
of :data:`N_PARTS` processes. :func:`run_contracts` runs them together in
one ``dist.spawn`` of four ``gloo`` processes (rank 0 returns every rank's
findings), so on the CPU they always run; a program that has its own spawn
calls :func:`run_sharded` in each rank. A contract that raises is an RC200
finding, never a pass. On CUDA every census also holds the kernel
launches, so the transparency contracts compare launches too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import obs
from ..api import partition
from ..core import quantization as qlib
from ..core.sylvie import SylvieConfig
from ..dist import api as dist_api
from ..dist.runtime import Runtime, resolve_device
from ..faults import FaultCtl, FaultPlan, FaultyBackend, RowGeometry
from ..graph import synthetic
from ..models.gnn import blocks as B
from ..models.gnn.models import GCN, GraphSAGE
from ..policy.base import BIT_LATTICE, EpochDecision
from ..policy.builtin import Uniform
from ..serve import delta as deltalib
from ..serve.engine import InferenceEngine, ServeConfig
from ..train import optimizer as optlib
from ..train.gnn_step import GNNTrainState, make_gnn_steps
from ..train.trainer import GNNTrainer
from .census import Census, CountingBackend, census
from .checks import (ExchangeExpectation, check_exchange_census,
                     check_no_collectives, check_overlap, check_same_census,
                     check_wire_dtypes)
from .report import Finding

N_PARTS = 4
SPAWN_TIMEOUT = 300.0    # seconds for the sharded contracts' spawn
KEY = (0, 1)             # the steps' noise key (deterministic rounding)
ARCHS: dict[str, Callable] = {
    "gcn": lambda d_in, d_out: GCN(
        d_in, 8, d_out, n_layers=2,
        generator=torch.Generator().manual_seed(0)),
    "sage": lambda d_in, d_out: GraphSAGE(
        d_in, 8, d_out, n_layers=2,
        generator=torch.Generator().manual_seed(0)),
}


@dataclasses.dataclass
class Workload:
    """One contract's model, partition, optimizer, state and step arguments
    ``(block, x, y, train_mask, key)`` on a counting runtime."""

    model: object
    pg: object
    opt: object
    state: GNNTrainState
    args: tuple
    runtime: Runtime
    counter: CountingBackend


def counting(runtime: Runtime) -> tuple[Runtime, CountingBackend]:
    """``runtime`` with its backend wrapped in a :class:`CountingBackend`."""
    cb = CountingBackend(runtime.backend)
    return Runtime(cb, runtime.device), cb


def graph_and_partition(layout: str):
    """The reference's 96-node skewed workload graph and its partition."""
    g = synthetic.planted_partition(n_nodes=96, d_feat=8, seed=0)
    return g, partition(g, N_PARTS, method="skewed", layout=layout,
                        alignment=4)


def workload(arch: str, layout: str, runtime: Runtime) -> Workload:
    """The workload on a counting copy of ``runtime`` (its rank's slice
    under a sharded runtime)."""
    rt, cb = counting(runtime)
    g, pg = graph_and_partition(layout)
    model = ARCHS[arch](g.x.shape[-1], g.n_classes)
    opt = optlib.sgd(1e-1)
    block = B.build_block(pg, rt.device, part=rt.rank)
    x, y, train_mask, _, _ = dist_api.gnn_data(pg, rt.rank, rt.device)
    state = GNNTrainState.create(
        model.param_tree(), opt, block.plan, model.comm_dims(),
        stacked_parts=rt.stacked_parts(N_PARTS), device=rt.device)
    return Workload(model, pg, opt, state, (block, x, y, train_mask, KEY),
                    rt, cb)


def buckets(pg, layout: str) -> Optional[tuple[int, ...]]:
    if layout != "compact":
        return None
    return tuple(int(b) for b in pg.plan.bucket_sizes)


def train_exp(model, state, pg, layout: str, bits: int
              ) -> ExchangeExpectation:
    """Declared comm structure of a train step, sync or async (the
    reference's ``_train_exp``).

    Forward: one exchange per site. Backward: the site-0 exchange ships raw
    input features (GCN and GraphSAGE, the models of these contracts), which
    need no gradient, so its backward exchange does not run — ``n_sites -
    1`` ops. A sync step's backward has nothing to send there; an async
    step, which exchanges the *gradient caches*, wires no gradient slot for
    a site whose ``h`` needs no gradient. (The reference's async
    expectation is ``n_sites``: it differentiates every cache.) psums: one
    per weight-grad leaf (Alg. 2 line 16) + 2 for the masked loss (sum,
    count) + 1 for the site telemetry."""
    n_sites = len(model.comm_dims())
    n_leaves = len(optlib.tree_leaves(state.params))
    return ExchangeExpectation(
        fwd_ops=n_sites, bwd_ops=n_sites - 1,
        bits=bits, buckets=buckets(pg, layout), psums=n_leaves + 3)


def eval_exp(model, pg) -> ExchangeExpectation:
    """The eval step: a full-precision forward exchange per site and
    exactly 2 psums (correct, count)."""
    return ExchangeExpectation(
        fwd_ops=len(model.comm_dims()), bwd_ops=0, bits=32,
        buckets=buckets(pg, "compact"), psums=2,
        wire_dtypes=frozenset({"float32"}))


def serve_exp(n_sites: int, pg) -> ExchangeExpectation:
    """The 1-bit serve sweep: per site one quantized forward exchange and
    one uint8 affected-mask ride; no psum, no backward."""
    return ExchangeExpectation(
        fwd_ops=n_sites, bwd_ops=0, bits=1,
        buckets=buckets(pg, "compact"), mask_ops=n_sites, psums=0)


def _cfg(mode: str, schedule: str = "blocking") -> SylvieConfig:
    return SylvieConfig(mode=mode, bits=1, stochastic=False,
                        schedule=schedule)


def step_census(w: Workload, mode: str, schedule: str = "blocking",
                state: Optional[GNNTrainState] = None,
                backend=None) -> Census:
    """The census of one train step of ``w`` (``mode`` "sync" or "async"),
    built against ``backend`` (default: ``w``'s counting backend)."""
    ts, ta, _ = make_gnn_steps(w.model, _cfg(mode, schedule), w.opt,
                               backend=backend or w.runtime.backend)
    step = ts if mode == "sync" else ta
    with census(w.counter, device=w.runtime.device) as c:
        step(w.state if state is None else state, *w.args)
    return c


def _sharded(device) -> Runtime:
    return Runtime.sharded(N_PARTS, device=device)


def _census_findings(c: Census, exp: ExchangeExpectation, where: str,
                     rt: Runtime) -> list[Finding]:
    return (check_exchange_census(c, exp, where, rt.rank, N_PARTS)
            + check_wire_dtypes(c, exp, where))


# ---------------------------------------------------------------------------
# the sharded contracts (one partition per process)
# ---------------------------------------------------------------------------
def train_census(arch: str, layout: str, mode: str, device,
                 schedule: str = "blocking"
                 ) -> tuple[Census, ExchangeExpectation, Runtime]:
    """This rank's census of one sharded train step and its expectation."""
    w = workload(arch, layout, _sharded(device))
    c = step_census(w, mode, schedule)
    return c, train_exp(w.model, w.state, w.pg, layout, bits=1), w.runtime


def contract_train_census(arch: str, layout: str, device) -> list[Finding]:
    """RC201/202/203 on the sharded sync train step."""
    c, exp, rt = train_census(arch, layout, "sync", device)
    return _census_findings(c, exp, f"contract:train_sync/{arch}/{layout}/"
                            "sharded", rt)


def contract_train_async_census(device) -> list[Finding]:
    """The async (Sylvie-A) step: cached-halo consumption still moves one
    quantized exchange per site forward and, on inverted rings, one per
    site whose ``h`` needs a gradient backward (all but site 0)."""
    c, exp, rt = train_census("gcn", "compact", "async", device)
    return _census_findings(c, exp, "contract:train_async/gcn/compact/"
                            "sharded", rt)


def eval_census(device) -> tuple[Census, ExchangeExpectation, Runtime]:
    """This rank's census of one sharded eval step."""
    w = workload("gcn", "compact", _sharded(device))
    _, _, ev = make_gnn_steps(w.model, _cfg("sync"), w.opt,
                              backend=w.runtime.backend)
    with census(w.counter, device=w.runtime.device) as c:
        ev(w.state.params, *w.args)
    return c, eval_exp(w.model, w.pg), w.runtime


def contract_eval_census(device) -> list[Finding]:
    """eval_step: full-precision forward exchange, exactly 2 psums
    (correct, count) — no telemetry, no weight-grad reduce."""
    c, exp, rt = eval_census(device)
    return _census_findings(c, exp, "contract:eval/gcn/compact/sharded", rt)


def _engine(runtime: Runtime) -> InferenceEngine:
    g, pg = graph_and_partition("compact")
    return InferenceEngine(ARCHS["gcn"](g.x.shape[-1], g.n_classes), pg,
                           config=ServeConfig(bits=1), runtime=runtime)


def sweep_census(eng: InferenceEngine, counter: CountingBackend,
                 refresh=None) -> Census:
    """The census of one raw sweep (``eng._sweep``) under the masks of
    ``refresh`` (default: the full sweep's)."""
    if refresh is None:
        refresh = deltalib.plan_full(eng.pg, eng.n_sites)
    masks = refresh.device_masks(eng.device, part=eng.rank)
    with census(counter, device=eng.device) as c:
        eng._sweep(eng.block, eng.x, eng._halos, masks, eng._generator())
    return c


def serve_census(device) -> tuple[Census, ExchangeExpectation, Runtime]:
    """This rank's census of one sharded 1-bit serve sweep."""
    rt, cb = counting(_sharded(device))
    eng = _engine(rt)
    return sweep_census(eng, cb), serve_exp(eng.n_sites, eng.pg), rt


def contract_serve_census(device) -> list[Finding]:
    """The serve sweep: per site one quantized forward exchange + one uint8
    affected-mask ride; no all-reduce, no backward, nothing fp32 on the
    wire."""
    c, exp, rt = serve_census(device)
    return _census_findings(c, exp, "contract:serve_sweep/gcn/compact/"
                            "sharded", rt)


def contract_overlap_census(device) -> list[Finding]:
    """RC209(a): the overlap schedule is *census-identical* to blocking. The
    issue/land split reorders work around the collective; it must not add,
    drop, widen or re-route a single exchange. So the sharded sync step
    under ``schedule="overlap"`` passes the exact expectation the blocking
    step is held to, with the same collectives (its exchanges started with
    ``async_op=True``), and lands each issue through one ``fence``."""
    where = "contract:overlap_census/gcn/compact/sharded"
    w = workload("gcn", "compact", _sharded(device))
    blocking = step_census(w, "sync")
    overlap = step_census(w, "sync", "overlap")
    exp = train_exp(w.model, w.state, w.pg, "compact", bits=1)
    return (_census_findings(overlap, exp, where, w.runtime)
            + check_overlap(blocking, overlap, where))


# ---------------------------------------------------------------------------
# the simulated contracts (the whole stack in one process)
# ---------------------------------------------------------------------------
def contract_simulated_pure(arch: str, layout: str, device
                            ) -> list[Finding]:
    """The simulated runtime runs the whole stack in one process: no
    ``torch.distributed`` collective at all (RC201)."""
    w = workload(arch, layout, Runtime.simulated(N_PARTS, device=device))
    return check_no_collectives(
        step_census(w, "sync"),
        f"contract:train_sync/{arch}/{layout}/simulated")


def contract_quantize_payload(device) -> list[Finding]:
    """RC206: across the whole bit lattice the Low-bit Module's wire
    payload is uint8 (packed to ``packed_width`` bytes) with bfloat16 error
    compensation — passthrough widths keep bf16/f32 and ship no scale. On
    CUDA the kernel widths launch ``quantize_pack`` and
    ``unpack_dequantize`` once each."""
    where = "contract:quantize_payload"
    dev = resolve_device(device)
    h = torch.randn((N_PARTS, 24, 16),
                    generator=torch.Generator().manual_seed(0)).to(dev)
    findings = []

    def bad(msg):
        findings.append(Finding(code="RC206", where=where, message=msg))

    for bits in BIT_LATTICE:
        with census(device=dev) as c:
            qt = qlib.quantize(h, bits, stochastic=False)
            qlib.dequantize(qt)
        data = str(qt.data.dtype).removeprefix("torch.")
        if bits >= 16:
            want = "bfloat16" if bits == 16 else "float32"
            if data != want or qt.scale.numel():
                bad(f"bits={bits} passthrough must ship {want} with empty "
                    f"scale, got {data} + scale shape "
                    f"{tuple(qt.scale.shape)}")
        else:
            want_w = qlib.packed_width(16, bits)
            if data != "uint8" or qt.data.shape[-1] != want_w:
                bad(f"bits={bits} payload must be uint8 packed to {want_w} "
                    f"bytes/row, got {data} shape {tuple(qt.data.shape)}")
            for name, t in (("scale", qt.scale), ("zero", qt.zero)):
                if t.dtype != torch.bfloat16:
                    bad(f"bits={bits} {name} must be bfloat16 (wire-cheap "
                        f"error compensation), got {t.dtype}")
        want_k = ({"quantize_pack": 1, "unpack_dequantize": 1}
                  if bits in qlib.KERNEL_BITS and dev.type == "cuda" else {})
        if c.launched() != want_k:
            bad(f"bits={bits} launched {c.launched()}, expected {want_k}")
    return findings


def _trainer(device, mode: str = "async") -> GNNTrainer:
    g, pg = graph_and_partition("compact")
    return GNNTrainer(ARCHS["gcn"](g.x.shape[-1], g.n_classes), pg,
                      _cfg(mode), opt=optlib.sgd(1e-1),
                      runtime=Runtime.simulated(N_PARTS, device=device),
                      seed=0)


def _budget(tr: GNNTrainer, decisions, code: str, where: str
            ) -> list[Finding]:
    """Each decision's steps built once (one ``_step_cache`` entry) and
    handed back unchanged on the next call; both steps run twice."""
    built, rebuilt = [], 0
    for d in decisions:
        for i in range(2):
            steps = tr._steps_for(d)
            if i == 0:
                built.append(steps)
            elif any(a is not b for a, b in zip(steps, built[-1])):
                rebuilt += 1
            ts, ta = steps
            st, _ = ts(tr.state, tr.block, tr.x, tr.y, tr.train_mask, KEY)
            ta(st, tr.block, tr.x, tr.y, tr.train_mask, KEY)
    n = len(tr._step_cache)
    if n != len(decisions) or rebuilt:
        return [Finding(
            code=code, where=where,
            message=f"step budget exceeded: {len(decisions)} decisions x 2 "
            f"calls must build exactly {len(decisions)} cached step pairs, "
            f"the cache holds {n} and {rebuilt} call(s) built anew")]
    return []


def contract_recompile_budget(device) -> list[Finding]:
    """RC204: one built step pair per lattice decision — asking again for a
    decision's steps hands back the cached ones, so K decisions build
    exactly K entries of ``GNNTrainer._step_cache``."""
    tr = _trainer(device)
    decisions = [EpochDecision.uniform(tr.n_sites, bits=b, stochastic=False)
                 for b in (1, 2)]
    return _budget(tr, decisions, "RC204", "contract:recompile_budget/train")


def contract_serve_one_executable(device) -> list[Finding]:
    """RC204 / RC207: a full sweep and a delta refresh are served by ONE
    sweep function (built with the engine), and their censuses are equal:
    the affected masks ride as data instead of shaping what runs."""
    where = "contract:serve_one_executable"
    rt, cb = counting(Runtime.simulated(N_PARTS, device=device))
    eng = _engine(rt)
    sweep = eng._sweep
    out = []
    with census(cb, device=rt.device) as full:
        eng.full_sweep()
    with census(cb, device=rt.device) as delta:
        eng.refresh(np.array([0]), np.zeros((1, 8), np.float32))
    with census(cb, device=rt.device) as again:
        eng.full_sweep()
    if eng._sweep is not sweep:
        out.append(Finding(
            code="RC204", where=where,
            message="full sweep + delta refresh + full sweep must share the "
            "one sweep function built with the engine; it was rebuilt"))
    out += check_same_census(
        full, delta, "RC207", where, "a delta refresh's census differs from "
        "a full sweep's — the masks are shaping what runs instead of "
        "riding as data")
    out += check_same_census(full, again, "RC207", where,
                             "two full sweeps have different censuses")
    return out


def contract_fault_transparency(device) -> list[Finding]:
    """RC208: fault injection must not change what runs. Two halves:

    (a) fault-free transparency — a train step built against a
        ``FaultyBackend`` wrapper, run with ``faults=None``, has the plain
        backend's census (no extra exchange when no chaos is armed);
    (b) masks as data — the armed step has one census for two epochs with
        *different* fault sets (the masks ride in ``GNNTrainState.faults``;
        fault values never shape what runs).
    """
    where = "contract:fault_transparency"
    w = workload("gcn", "compact", Runtime.simulated(N_PARTS, device=device))
    plan = FaultPlan(seed=3, drop_rate=0.2, corrupt_rate=0.1)
    n_sites = len(w.model.comm_dims())
    geom = RowGeometry.from_plan(w.args[0].plan)
    ctls = [FaultCtl.expand(plan.events(e, n_sites, N_PARTS), geom, n_sites,
                            w.runtime.device) for e in (1, 2)]
    findings: list[Finding] = []
    for mode in ("sync", "async"):
        plain = step_census(w, mode)
        faulty = step_census(w, mode, backend=FaultyBackend(w.counter,
                                                            FaultPlan()))
        findings += check_same_census(
            plain, faulty, "RC208", f"{where}/{mode}",
            "FaultyBackend with faults=None runs a different census than "
            "the plain backend — the fault path leaks into the fault-free "
            "step")
        armed = FaultyBackend(w.counter, plan)
        a, b = (step_census(w, mode, state=dataclasses.replace(
            w.state, faults=ctl), backend=armed) for ctl in ctls)
        findings += check_same_census(
            a, b, "RC208", f"{where}/{mode}/armed",
            "two epochs with different fault masks have different censuses "
            "— fault events are shaping what runs instead of riding as "
            "data")
    return findings


def contract_overlap_budget(device) -> list[Finding]:
    """RC209(b): overlap decisions obey the RC204 budget — a blocking and an
    overlap decision build exactly 2 cached step pairs across repeated
    calls (the schedule is part of ``EpochDecision.step_key()``)."""
    tr = _trainer(device)
    decisions = [EpochDecision.uniform(tr.n_sites, bits=1, stochastic=False,
                                       schedule=s)
                 for s in ("blocking", "overlap")]
    return _budget(tr, decisions, "RC209", "contract:overlap_budget/train")


def contract_obs_transparency(device) -> list[Finding]:
    """RC210: observability must not change what runs. The span tracer and
    the metrics live at the host seams; enabling tracing must not add, drop
    or reorder a single exchange, collective or launch. Checked on the
    sync and async train steps under ``schedule="overlap"`` (the path with
    the most spans: every issue and land is a ``halo`` span) and the serve
    sweep, with the tracer off and on (a ``FakeClock``)."""
    where = "contract:obs_transparency"
    rt = Runtime.simulated(N_PARTS, device=device)

    def snapshot() -> dict[str, Census]:
        w = workload("gcn", "compact", rt)
        crt, cb = counting(rt)
        return {"train_sync": step_census(w, "sync", "overlap"),
                "train_async": step_census(w, "async", "overlap"),
                "serve_sweep": sweep_census(_engine(crt), cb)}

    was = obs.current()
    try:
        obs.disable()
        off = snapshot()
        obs.enable(obs.FakeClock())
        on = snapshot()
        obs.drain()
    finally:
        if was is not None:
            obs.enable(was.clock)
        else:
            obs.disable()
    return [f for k in off for f in check_same_census(
        off[k], on[k], "RC210", f"{where}/{k}",
        "enabling the span tracer changes the census — instrumentation is "
        "adding work instead of staying at the host seams")]


def contract_trainer_epoch(model, pg, runtime: Runtime, where: str
                           ) -> tuple[list[Finding], Census]:
    """One 1-bit Sylvie-S epoch of ``model`` on ``pg`` through
    ``GNNTrainer`` under ``runtime`` (any size: ``chip_smoke.py`` runs GCN
    256x2 on ``reddit_like@paper``), held to the sync step's expectation
    over ``pg``'s own buckets; returns the findings and the census."""
    rt, cb = counting(runtime)
    tr = GNNTrainer(model, pg, SylvieConfig(mode="sync", bits=1),
                    policy=Uniform(bits=1), runtime=rt, seed=0)
    with census(cb, device=rt.device) as c:
        tr.train_epoch()
    layout = getattr(pg.plan, "layout", "dense")
    exp = train_exp(model, tr.state, pg, layout, 1)
    found = (check_exchange_census(c, exp, where, rt.rank, pg.plan.n_parts)
             + check_wire_dtypes(c, exp, where))
    if rt.rank is None:
        found += check_no_collectives(c, where)
    return found, c


# ---------------------------------------------------------------------------
# registry + runners
# ---------------------------------------------------------------------------
CONTRACTS: dict[str, Callable[..., list[Finding]]] = {
    **{f"train_sync/{a}/{lay}/sharded":
       (lambda device, a=a, lay=lay: contract_train_census(a, lay, device))
       for a in ARCHS for lay in ("compact", "dense")},
    **{f"train_sync/{a}/{lay}/simulated":
       (lambda device, a=a, lay=lay: contract_simulated_pure(a, lay, device))
       for a in ARCHS for lay in ("compact", "dense")},
    "train_async/gcn/compact/sharded": contract_train_async_census,
    "eval/gcn/compact/sharded": contract_eval_census,
    "serve_sweep/gcn/compact/sharded": contract_serve_census,
    "quantize_payload": contract_quantize_payload,
    "recompile_budget/train": contract_recompile_budget,
    "serve_one_executable": contract_serve_one_executable,
    "fault_transparency": contract_fault_transparency,
    "overlap_census/gcn/compact/sharded": contract_overlap_census,
    "overlap_budget/train": contract_overlap_budget,
    "obs_transparency": contract_obs_transparency,
}
SHARDED = tuple(n for n in CONTRACTS if n.endswith("/sharded"))
SIMULATED = tuple(n for n in CONTRACTS if n not in SHARDED)


def _run(name: str, device) -> list[Finding]:
    """One contract; an error is an RC200 finding — a broken checker must
    fail the gate, not pass it."""
    try:
        return list(CONTRACTS[name](device))
    except Exception as e:  # noqa: BLE001 - surfaced as a finding
        return [Finding(code="RC200", where=f"contract:{name}",
                        message=f"contract raised {type(e).__name__}: {e}")]


def run_sharded(names=SHARDED, device=None) -> list[Finding]:
    """The sharded contracts ``names``, run in every process of the default
    group (each checks its own rank's census); every rank returns the
    findings of all ranks, each distinct finding once."""
    import torch.distributed as dist
    mine = [f for name in names for f in _run(name, device)]
    every: list = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return list(dict.fromkeys(f for fs in every for f in fs))


def run_contracts(only: Optional[list[str]] = None, device=None
                  ) -> tuple[list[Finding], list[str]]:
    """Run every registered contract (or the named subset) on ``device``
    (``None`` means CUDA: without a card that raises; ``"cpu"`` runs the
    plain versions). The simulated contracts run here, the sharded ones
    together in one spawn of :data:`N_PARTS` ``gloo`` processes on the
    same device. Returns ``(findings, skipped)``; nothing is skipped."""
    from ..dist.spawn import spawn
    dev = resolve_device(device)
    names = [n for n in CONTRACTS if only is None or n in only]
    findings = [f for n in names if n not in SHARDED for f in _run(n, dev)]
    sharded = [n for n in names if n in SHARDED]
    if sharded:
        where = "cpu" if dev.type == "cpu" else f"cuda:{dev.index or 0}"
        try:
            findings += spawn(run_sharded, N_PARTS, device=where,
                              dist_backend="gloo", args=(sharded, where),
                              timeout=SPAWN_TIMEOUT)
        except Exception as e:  # noqa: BLE001 - surfaced as a finding
            findings += [Finding(code="RC200", where=f"contract:{n}",
                                 message=f"the sharded spawn raised "
                                 f"{type(e).__name__}: {e}")
                         for n in sharded]
    return findings, []
