"""The port's multi-process runtime (``Runtime.sharded``: one partition per
process over ``torch.distributed``) on the CPU, four ``gloo`` processes from
``repro_torch.dist.spawn``, against the simulated runtime and the JAX
reference.

* exchanges: ``ProcessGroupBackend`` gives every rank its row of what
  ``SimulatedBackend`` gives the stack, bit for bit — dense and compact
  (ragged buckets, empty ones among them), forward and reversed, uint8 /
  bfloat16 / float32 / int32, the quantized variants and the issued
  (``async_op``) ones landed by ``fence``;
* ``psum``: a two-rank toy loss gives the whole stack's weight gradients,
  reduced once (not twice: its transpose is the identity);
* training: the program of ``tests/test_runtime.py``'s backend-parity test
  (``planted_partition(400, 16)``, GCN 16->32, SGD 1e-1, deterministic
  1 bit, sync 3 epochs and async 4), sharded, in the dense and the compact
  layouts, against ``repro.train`` on ``repro.Runtime.simulated(4)``:
  losses rtol 1e-5, parameters rtol 1e-4 / atol 1e-6, validation accuracy
  within 1e-6 (the JAX package holds its ``shard_map`` run to that same
  simulated run);
* GraphSAGE and GAT (deterministic 1 bit, SGD, sync and async), sharded
  against the port's simulated runtime: losses rtol 1e-5, parameters rtol
  1e-4 / atol 1e-6, validation accuracy within 1e-6, bytes equal;
* the overlap schedule under the sharded runtime: bit-equal to blocking;
* faults under the ``chaos_smoke`` schedule: per epoch the same injected /
  reused / forced units as the simulated run, and the same losses
  (deterministic rounding, rtol 1e-5);
* checkpoints cross between runtimes both ways; kill-and-resume
  (``launch.chaos --kill-resume --runtime sharded``) is bit-exact; a sharded
  scenario cell reports the simulated cell's keys and bytes;
* BNS under the whole stack's keep-masks: each rank takes its row;
* refusals: no group, a partition count other than the world size, a card
  asked for where there is none, a failing rank (its error in the message),
  no ``torch.distributed`` backend named. Serving under the sharded runtime
  is ``tests/test_torch_sharded_serve.py``'s.

Every spawn joins with a timeout, so a hang fails a test instead of eating
the run's time. The JAX package is imported inside the tests, not here: the
ranks import this module, and need only torch.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.dist.spawn import spawn

P = 4
TIMEOUT = 240
DTYPES = {"uint8": torch.uint8, "bfloat16": torch.bfloat16,
          "float32": torch.float32, "int32": torch.int32}
BUCKETS = {"ragged": (0, 5, 0, 3), "wide": (2, 0, 7, 1)}


def _spawn(fn, *args, n=P):
    return spawn(fn, n, device="cpu", dist_backend="gloo", args=args,
                 timeout=TIMEOUT)


# ---------------------------------------------------------------------------
# exchanges, bit for bit
# ---------------------------------------------------------------------------
def _stack(dtype, rows, seed, width=3) -> torch.Tensor:
    """A (P, rows, width) stack of ``dtype`` from a seed."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 50, (P, rows, width))
                         .astype(np.float32))
    if dtype in (torch.uint8, torch.int32):
        x = torch.from_numpy(rng.integers(0, 255, (P, rows, width)))
    return x.to(dtype)


def _qt(bits, rows, seed):
    from repro_torch.core import quantization as qlib
    h = _stack(torch.float32, rows, seed, width=13)
    return qlib.quantize(h, bits, stochastic=False)


EXCHANGE_CASES = (
    [f"dense-{d}" for d in DTYPES]
    + [f"compact-{b}-{dirn}-{d}" for b in BUCKETS for dirn in ("fwd", "rev")
       for d in DTYPES]
    + [f"quantized-{bits}-{lay}" for bits in (1, 32)
       for lay in ("dense", "compact-fwd", "compact-rev")]
    + [f"issued-{bits}-{lay}" for bits in (1, 32)
       for lay in ("dense", "compact-fwd", "compact-rev")])


def _exchange_rank() -> dict:
    """Every case on this rank: its row of the simulated stack's result?"""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.dist.backend import ProcessGroupBackend, SimulatedBackend
    pg, sim = ProcessGroupBackend(), SimulatedBackend()
    r = pg.axis_index()
    mine = {}

    def row(t):
        return t[r:r + 1]

    def same(a, b):
        return a.dtype == b.dtype and torch.equal(a, b)

    def same_qt(a, b):
        return all(same(getattr(a, f), getattr(b, f))
                   for f in ("data", "scale", "zero"))

    for i, (name, dt) in enumerate(DTYPES.items()):
        x = _stack(dt, P * 3, i)
        mine[f"dense-{name}"] = same(pg.exchange(row(x)),
                                     row(sim.exchange(x)))
        for j, (bname, sizes) in enumerate(BUCKETS.items()):
            x = _stack(dt, sum(sizes), 10 * i + j)
            for dirn, rev in (("fwd", False), ("rev", True)):
                mine[f"compact-{bname}-{dirn}-{name}"] = same(
                    pg.exchange_compact(row(x), sizes, rev),
                    row(sim.exchange_compact(x, sizes, rev)))
    sizes = BUCKETS["ragged"]
    for bits in (1, 32):
        for lay, buckets, rev in (("dense", None, False),
                                  ("compact-fwd", sizes, False),
                                  ("compact-rev", sizes, True)):
            qt = _qt(bits, P * 3 if buckets is None else sum(buckets), bits)
            local = dataclasses.replace(qt, data=row(qt.data),
                                        scale=row(qt.scale) if
                                        qt.scale.numel() else qt.scale,
                                        zero=row(qt.zero) if
                                        qt.zero.numel() else qt.zero)
            if buckets is None:
                want, got = sim.exchange_quantized(qt), \
                    pg.exchange_quantized(local)
            else:
                want = sim.exchange_quantized_compact(qt, buckets, rev)
                got = pg.exchange_quantized_compact(local, buckets, rev)
            want = dataclasses.replace(
                want, data=row(want.data),
                scale=row(want.scale) if want.scale.numel() else want.scale,
                zero=row(want.zero) if want.zero.numel() else want.zero)
            mine[f"quantized-{bits}-{lay}"] = same_qt(got, want)
            issued = pg.fence(pg.issue_quantized(local, buckets, rev))
            mine[f"issued-{bits}-{lay}"] = same_qt(issued.qt, want)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return {case: [m[case] for m in every] for case in mine}


@pytest.fixture(scope="module")
def exchanged():
    return _spawn(_exchange_rank)


@pytest.mark.parametrize("case", EXCHANGE_CASES)
def test_process_group_exchange_equals_the_stack_bit_for_bit(exchanged,
                                                            case):
    assert exchanged[case] == [True] * P, exchanged[case]


# ---------------------------------------------------------------------------
# psum: weight gradients reduced once; refusals inside a group
# ---------------------------------------------------------------------------
def _toy(x, w, backend):
    s = (torch.tanh(x @ w) ** 2).sum()
    c = torch.tensor(float(x.shape[0] * x.shape[1]))
    return backend.psum(s) / backend.psum(c)


def _psum_rank(x_all: np.ndarray, w0: np.ndarray) -> dict:
    from repro_torch.dist.backend import ProcessGroupBackend
    from repro_torch.dist.runtime import Runtime
    be = ProcessGroupBackend()
    r = be.axis_index()
    w = torch.from_numpy(w0).requires_grad_()
    loss = _toy(torch.from_numpy(x_all[r:r + 1]), w, be)
    (g,) = torch.autograd.grad(loss, [w])
    refused = {}
    for what, call in (("n_parts", lambda: Runtime.sharded(3,
                                                           device="cpu")),
                       ("no card", lambda: Runtime.sharded(2))):
        try:
            call()
            refused[what] = None
        except (ValueError, RuntimeError) as err:
            refused[what] = str(err)
    return dict(loss=float(loss), grad=be.psum(g).numpy(), refused=refused)


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 4)).astype(np.float32)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    return x, w, _spawn(_psum_rank, x, w, n=2)


def test_psum_reduces_weight_gradients_once(toy):
    from repro_torch.dist.backend import SimulatedBackend
    x, w0, got = toy
    w = torch.from_numpy(w0).requires_grad_()
    loss = _toy(torch.from_numpy(x), w, SimulatedBackend())
    (g,) = torch.autograd.grad(loss, [w])
    np.testing.assert_allclose(got["loss"], float(loss.detach()), rtol=1e-6)
    np.testing.assert_allclose(got["grad"], g.numpy(), rtol=1e-5, atol=1e-7)
    assert not np.allclose(got["grad"], 2 * g.numpy(), rtol=1e-3)


def test_sharded_runtime_refuses_a_count_other_than_the_group(toy):
    assert "one partition per process" in toy[2]["refused"]["n_parts"]


def test_sharded_runtime_without_a_card_raises_for_cuda(toy):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: cuda:<rank> resolves")
    assert "no CUDA device" in toy[2]["refused"]["no card"]


def test_sharded_runtime_needs_a_group():
    from repro_torch.dist.runtime import Runtime
    with pytest.raises(RuntimeError, match="dist.spawn"):
        Runtime.sharded(4, device="cpu")


def _fail_rank():
    import torch.distributed as dist
    if dist.get_rank() == 0:
        raise ValueError("boom from rank 0")
    dist.barrier()


def test_spawn_raises_with_the_failing_ranks_error():
    with pytest.raises(RuntimeError, match="boom from rank 0"):
        spawn(_fail_rank, 2, device="cpu", dist_backend="gloo", timeout=60)


def test_spawn_picks_no_backend_and_refuses_what_cannot_run(monkeypatch):
    for bad in (None, "auto", "mpi"):
        with pytest.raises(ValueError, match="dist_backend"):
            spawn(_fail_rank, 2, device="cpu", dist_backend=bad)
    with pytest.raises(ValueError, match="nccl"):
        spawn(_fail_rank, 2, device="cpu", dist_backend="nccl")
    with pytest.raises(ValueError, match="two ranks on one device"):
        spawn(_fail_rank, 2, device="cuda:0", dist_backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(_fail_rank, 2, device=None, dist_backend="gloo")


# ---------------------------------------------------------------------------
# training against the JAX reference and the simulated runtime
# ---------------------------------------------------------------------------
RUNS = {"sync": 3, "async": 4}
LAYOUTS = ("dense", "compact")
ARCHS = ("graphsage", "gat")
CHAOS = "drop=0.15,corrupt=0.05,seed=7"       # the chaos_smoke schedule


def _graph():
    from repro_torch.graph import synthetic
    return synthetic.planted_partition(n_nodes=400, d_feat=16)


def _bns_masks(rows: int):
    """BNS keep-masks of the whole stack, (P, rows) per site, by epoch."""
    def masks(epoch):
        rng = np.random.default_rng([7, epoch])
        return [torch.from_numpy((rng.random((P, rows)) > 0.3)
                                 .astype(np.float32)) for _ in range(2)]
    return masks


def _model(arch: str, n_classes: int):
    """GCN 16->32, or GraphSAGE 16->32 or GAT 2 heads x 8 with their weights
    drawn from a seeded generator (the same in every process)."""
    from repro_torch.models.gnn.models import GAT, GCN, GraphSAGE
    gen = torch.Generator().manual_seed(3)
    if arch == "gat":
        return GAT(16, 8, n_classes, n_layers=2, heads=2, generator=gen)
    if arch == "graphsage":
        return GraphSAGE(16, 32, n_classes, n_layers=2, generator=gen)
    return GCN(16, 32, n_classes, n_layers=2)


def _train(runtime, layout, mode, epochs, params, schedule="blocking",
           fault=None, policy=None, bns=False, arch="gcn"):
    import repro_torch.api as repro
    from repro_torch.launch.scenarios import parse_fault
    from repro_torch.train import optimizer as opt
    g = _graph()
    pg = repro.partition(g, n_parts=P, layout=layout)
    cfg = repro.SylvieConfig(mode=mode, bits=1, stochastic=False,
                             schedule=schedule,
                             boundary_sample_p=0.3 if bns else 0.0)
    tr = repro.GNNTrainer(_model(arch, g.n_classes), pg, cfg,
                          policy=policy, runtime=runtime, opt=opt.sgd(1e-1),
                          params=params, fault_plan=parse_fault(fault))
    if bns:
        tr.bns_masks = _bns_masks(pg.plan.halo_rows)
    tr.fit(epochs)
    return dict(
        losses=[m.loss for m in tr.history],
        params=[p.detach().cpu().numpy()
                for p in opt.tree_leaves(tr.state.params)],
        val=tr.evaluate("val"), mb=[m.comm_payload_mb for m in tr.history],
        accounting=[(m.faults_injected, m.halos_reused, m.forced_syncs)
                    for m in tr.history])


def _faulted(runtime, params) -> dict:
    """The runs held to the port's simulated runtime: the chaos_smoke
    schedule's (compact layout, 6 epochs), a BNS run under the whole
    stack's keep-masks (3 epochs), and GraphSAGE and GAT (dense layout,
    sync 3 epochs and async 4, their own seeded weights)."""
    from repro_torch.policy import BoundedStaleness
    out = {("faults", mode): _train(
        runtime, "compact", mode, 6, params, fault=CHAOS,
        policy=BoundedStaleness(eps_s=4, bits=1, stochastic=False)
        if mode == "async" else None) for mode in RUNS}
    out["bns"] = _train(runtime, "compact", "sync", 3, params, bns=True)
    out.update({(arch, mode): _train(runtime, "dense", mode, epochs, None,
                                     arch=arch)
                for arch in ARCHS for mode, epochs in RUNS.items()})
    return out


def _runs_rank(params) -> dict:
    """Every sharded training run of this file."""
    from repro_torch.dist.runtime import Runtime
    rt = Runtime.sharded(P, device="cpu")
    out = {(layout, mode): _train(rt, layout, mode, epochs, params)
           for layout in LAYOUTS for mode, epochs in RUNS.items()}
    out.update({("overlap", mode): _train(rt, "compact", mode, epochs,
                                          params, schedule="overlap")
                for mode, epochs in RUNS.items()})
    return {**out, **_faulted(rt, params)}


@pytest.fixture(scope="module")
def trained():
    """The JAX reference's simulated runs, and the same runs sharded and
    simulated in the port from the reference's initial parameters (the
    ranks run while this process runs the reference)."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    import repro.api as jrepro
    from repro.graph import synthetic as jsyn
    from repro.models.gnn.models import GCN as JGCN
    from repro.train import optimizer as jopt
    from repro_torch.dist.runtime import Runtime

    g = jsyn.planted_partition(n_nodes=400, d_feat=16)
    model = JGCN(d_in=16, d_hidden=32, d_out=g.n_classes, n_layers=2)
    runs = {}
    for layout in LAYOUTS:
        pg = jrepro.partition(g, n_parts=P, layout=layout)
        for mode in RUNS:
            cfg = jrepro.SylvieConfig(mode=mode, bits=1, stochastic=False)
            runs[layout, mode] = jrepro.train(
                model, pg, cfg, runtime=jrepro.Runtime.simulated(P),
                opt=jopt.sgd(1e-1))
    inits = [jax.tree.map(np.asarray, tr.state.params)
             for tr in runs.values()]
    params = inits[0]
    assert all(np.array_equal(a, b) for init in inits
               for a, b in zip(jax.tree.leaves(init),
                               jax.tree.leaves(params)))
    with ThreadPoolExecutor(1) as pool:
        sharded = pool.submit(_spawn, _runs_rank, params)
        ref = {}
        for (layout, mode), tr in runs.items():
            tr.fit(RUNS[mode])
            ref[layout, mode] = dict(
                losses=[m.loss for m in tr.history],
                params=[np.asarray(p)
                        for p in jax.tree.leaves(tr.state.params)],
                val=tr.evaluate("val"),
                mb=[m.comm_payload_mb for m in tr.history])
        simulated = _faulted(Runtime.simulated(P, device="cpu"), params)
        return ref, sharded.result(), simulated


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", RUNS)
def test_sharded_losses_match_jax(trained, layout, mode):
    ref, sharded, _ = trained
    np.testing.assert_allclose(sharded[layout, mode]["losses"],
                               ref[layout, mode]["losses"], rtol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", RUNS)
def test_sharded_params_match_jax(trained, layout, mode):
    ref, sharded, _ = trained
    for a, b in zip(sharded[layout, mode]["params"],
                    ref[layout, mode]["params"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", RUNS)
def test_sharded_val_accuracy_matches_jax(trained, layout, mode):
    ref, sharded, _ = trained
    assert abs(sharded[layout, mode]["val"] - ref[layout, mode]["val"]) \
        < 1e-6


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", RUNS)
def test_sharded_bytes_per_epoch_are_the_whole_graphs(trained, layout, mode):
    ref, sharded, _ = trained
    np.testing.assert_allclose(sharded[layout, mode]["mb"],
                               ref[layout, mode]["mb"], rtol=1e-12)


@pytest.mark.parametrize("mode", RUNS)
def test_overlap_under_sharded_is_bit_equal_to_blocking(trained, mode):
    _, sharded, _ = trained
    a, b = sharded["compact", mode], sharded["overlap", mode]
    assert a["losses"] == b["losses"]
    assert all(np.array_equal(x, y) for x, y in zip(a["params"],
                                                    b["params"]))


@pytest.mark.parametrize("mode", RUNS)
def test_faults_under_sharded_account_as_the_simulated_run(trained, mode):
    _, sharded, simulated = trained
    a, b = sharded["faults", mode], simulated["faults", mode]
    assert a["accounting"] == b["accounting"]
    assert all(i == r + f for i, r, f in a["accounting"])
    assert sum(i for i, _, _ in a["accounting"]) > 0
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", RUNS)
def test_sharded_losses_match_the_simulated_runtime(trained, arch, mode):
    _, sharded, simulated = trained
    np.testing.assert_allclose(sharded[arch, mode]["losses"],
                               simulated[arch, mode]["losses"], rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", RUNS)
def test_sharded_params_match_the_simulated_runtime(trained, arch, mode):
    _, sharded, simulated = trained
    for a, b in zip(sharded[arch, mode]["params"],
                    simulated[arch, mode]["params"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert sharded[arch, mode]["mb"] == simulated[arch, mode]["mb"]
    assert abs(sharded[arch, mode]["val"] - simulated[arch, mode]["val"]) \
        < 1e-6


def test_bns_under_sharded_takes_each_ranks_row_of_the_masks(trained):
    _, sharded, simulated = trained
    a, b = sharded["bns"], simulated["bns"]
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
    for x, y in zip(a["params"], b["params"]):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# checkpoints, kill-and-resume, scenarios
# ---------------------------------------------------------------------------
def _ckpt_rank(sim_dir: str, out_dir: str) -> dict:
    """Resume the simulated runtime's checkpoint and train one epoch; write
    a checkpoint of two epochs of this runtime's own."""
    import repro_torch.api as repro
    from repro_torch.dist.runtime import Runtime
    from repro_torch.models.gnn.models import GCN
    from repro_torch.train import optimizer as opt
    rt = Runtime.sharded(P, device="cpu")
    g = _graph()
    pg = repro.partition(g, runtime=rt)
    out = {}
    for name, d in (("resumed", sim_dir), ("own", out_dir)):
        tr = repro.GNNTrainer(
            GCN(16, 32, g.n_classes, n_layers=2,
                generator=torch.Generator().manual_seed(0)), pg,
            repro.SylvieConfig(mode="async", bits=1, stochastic=False),
            runtime=rt, opt=opt.sgd(1e-1), ckpt_dir=d)
        if name == "resumed":
            assert tr.resume() and tr.epoch == 2
            tr.fit(1)
        else:
            tr.fit(2)
            tr.save()
        out[name] = dict(losses=[m.loss for m in tr.history],
                         params=[p.numpy() for p in
                                 opt.tree_leaves(tr.state.params)])
    return out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    import repro_torch.api as repro
    from repro_torch.dist.runtime import Runtime
    from repro_torch.models.gnn.models import GCN
    from repro_torch.train import optimizer as opt
    root = tmp_path_factory.mktemp("ckpt")
    rt = Runtime.simulated(P, device="cpu")
    g = _graph()
    pg = repro.partition(g, runtime=rt)

    def trainer(d):
        return repro.GNNTrainer(
            GCN(16, 32, g.n_classes, n_layers=2,
                generator=torch.Generator().manual_seed(0)), pg,
            repro.SylvieConfig(mode="async", bits=1, stochastic=False),
            runtime=rt, opt=opt.sgd(1e-1), ckpt_dir=str(d))

    sim = trainer(root / "sim")
    sim.fit(2)
    sim.save()
    sharded = _spawn(_ckpt_rank, str(root / "sim"), str(root / "sharded"))
    sim.fit(1)
    again = trainer(root / "sharded")
    assert again.resume() and again.epoch == 2
    again.fit(1)
    return root, sim, again, sharded


def _arrays(d):
    from repro_torch.train.checkpoint import latest_step
    step = latest_step(d)
    man = json.loads((d / f"step_{step:08d}" / "manifest.json").read_text())
    with np.load(d / f"step_{step:08d}" / "arrays.npz") as z:
        return man, {k: z[k] for k in z.files}


def test_a_sharded_checkpoint_is_the_simulated_runtimes(checkpoints):
    root = checkpoints[0]
    (man_a, a), (man_b, b) = _arrays(root / "sim"), _arrays(root / "sharded")
    assert man_a["format_version"] == man_b["format_version"] == 2
    assert sorted(a) == sorted(b) and "halo/feats/1" in a
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_a_simulated_checkpoint_resumes_sharded(checkpoints):
    _, sim, _, sharded = checkpoints
    np.testing.assert_allclose(sharded["resumed"]["losses"],
                               [m.loss for m in sim.history[2:]], rtol=1e-5)
    for a, b in zip(sharded["resumed"]["params"],
                    (p.numpy() for p in _leaves(sim))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_a_sharded_checkpoint_resumes_simulated(checkpoints):
    _, sim, again, _ = checkpoints
    np.testing.assert_allclose([m.loss for m in again.history],
                               [m.loss for m in sim.history[2:]], rtol=1e-5)
    for a, b in zip(_leaves(again), _leaves(sim)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


def _leaves(tr):
    from repro_torch.train import optimizer as opt
    return opt.tree_leaves(tr.state.params)


def test_kill_and_resume_under_sharded_is_bit_exact(tmp_path, capsys):
    from repro_torch import datasets
    from repro_torch.launch import chaos
    cache = tmp_path / "plans"
    datasets.load_partitioned("yelp_like@smoke", P, cache_dir=cache)
    args = chaos.build_parser().parse_args([
        "--kill-resume", "--epochs", "3", "--device", "cpu",
        "--runtime", "sharded", "--dist-backend", "gloo",
        "--plan-cache", str(cache), "--out-dir", str(tmp_path / "kr")])
    res = chaos.kill_resume(args)
    assert res["bit_exact"] and res["max_deviation"] == 0.0
    assert res["plan_cache_hits"] == [True, True, True]
    assert res["ref"]["losses"][-1] == res["resumed"]["losses"][-1]
    assert not list((tmp_path / "kr" / "chaos").glob(".tmp_step_*"))
    assert '"bit_exact": true' in capsys.readouterr().out


def test_a_sharded_scenario_cell_reports_the_simulated_cells(tmp_path):
    from repro_torch.launch import scenarios as S
    scn = S.Scenario(name="s", archs=("gcn",), datasets=("yelp_like@smoke",),
                     policies=("uniform:1",), runtimes=("simulated",
                                                        "sharded"),
                     epochs=2)
    sim_cell, sh_cell = scn.cells()
    sim = S.run_cell(scn, sim_cell, cache_dir=tmp_path, device="cpu")
    sh = S.run_cell(scn, sh_cell, cache_dir=tmp_path, device="cpu",
                    dist_backend="gloo")
    assert set(sh) == set(sim) == S.REPORT_KEYS
    assert sh["runtime"] == "sharded" and sh["plan_cache_hit"]
    for k in ("comm_payload_bytes_per_epoch", "comm_ec_bytes_per_epoch",
              "wire_payload_bytes_per_epoch", "wire_ec_bytes_per_epoch",
              "modeled_comm_s", "bits_per_site", "n_parts"):
        assert sh[k] == sim[k], k
    # stochastic rounding draws per partition: the losses agree only
    # statistically
    assert np.isfinite(sh["final_loss"])
    assert abs(sh["final_loss"] - sim["final_loss"]) < 0.1 * sim["final_loss"]
