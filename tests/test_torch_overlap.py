"""The port's overlap schedule (``repro_torch.dist.overlap``) against the
blocking schedule and against the JAX reference's overlap, on the CPU.

On the CPU the exchange runs in place and the fence is the identity (the
side CUDA stream and its event exist only on the card, where
``chip_smoke.py`` holds the same equalities); so every check here is exact:

* the overlap Functions against the blocking ones and against
  ``repro.dist.overlap``'s ``custom_vjp``s, values and gradients, with JAX's
  noise injected (stochastic) and deterministic, on the dense and the
  compact plans of a ``method="skewed"`` partition;
* whole runs (``yelp_like@smoke``, P = 4, d_hidden 16): GCN, GraphSAGE and
  GAT, sync and async (``Uniform``), deterministic and stochastic rounding
  (the port's own generators): losses and parameters bit-equal to blocking,
  with the kernels' plain versions called as often as in blocking; GCN
  deterministic against JAX's overlap trainer (losses at rtol 1e-4);
* ``site_comm_seconds``, ``split_comm_time``, ``modeled_step_seconds`` and
  the trainer's ``modeled_comm_split`` equal JAX's given the same constants;
* an unknown schedule is refused; the serving engine's overlap sweep and
  delta refresh are bit-equal to blocking.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import datasets as jdatasets
from repro.core import exchange as jx
from repro.core.sylvie import SylvieConfig as JConfig
from repro.dist import overlap as jol
from repro.dist.backend import SimulatedBackend as JBackend
from repro.graph import formats as jformats
from repro.graph import partition as jpartition
from repro.graph import synthetic as jsynthetic
from repro.models.gnn.models import GCN as JGCN
from repro.policy import builtin as jpol
from repro.train.trainer import GNNTrainer as JTrainer
from repro_torch import datasets
from repro_torch.core import exchange as tx
from repro_torch.core import sylvie as ts
from repro_torch.core.sylvie import SylvieConfig
from repro_torch.dist import overlap as tol
from repro_torch.dist.backend import Inflight, SimulatedBackend
from repro_torch.dist.runtime import Runtime
from repro_torch.graph import formats, partition, synthetic
from repro_torch.kernels.quant import ref as qref
from repro_torch.kernels.spmm import ref as sref
from repro_torch.models.convert import params_to_numpy
from repro_torch.models.gnn.models import GAT, GCN, GraphSAGE
from repro_torch.policy import builtin as tpol
from repro_torch.serve import InferenceEngine, ServeConfig
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import GNNTrainer

D = 24
REF = "yelp_like@smoke"
CPU = Runtime.simulated(4, device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["dense", "compact"])
def plans(request):
    out = []
    for fm, sy, pa in ((formats, synthetic, partition),
                       (jformats, jsynthetic, jpartition)):
        g = sy.powerlaw_community(n_nodes=600, d_feat=D, avg_degree=10,
                                  seed=0)
        g, ew = fm.gcn_normalize(g)
        out.append(pa.partition_graph(g, 4, method="skewed", edge_weight=ew,
                                      layout=request.param))
    pg, jpg = out
    return (pg, tx.PlanArrays.from_plan(pg.plan),
            jx.PlanArrays.from_plan(jpg.plan))


def _noise(key, shape, stochastic):
    if not stochastic:
        return None
    return torch.tensor(np.asarray(jax.random.uniform(key, shape,
                                                      dtype=jnp.float32)))


def _value_and_vjp(f, *args):
    def run(args, ct):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(ct)
    return lambda ct: jax.jit(run)(tuple(jnp.asarray(a) for a in args),
                                   jnp.asarray(ct))


def _rand(shape, seed, live=None):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    if live is not None:
        x = np.where(np.asarray(live)[..., None], x, 0).astype(np.float32)
    return x


# ---------------------------------------------------------------------------
# the Functions: overlap == blocking == JAX's overlap
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", [1, 8])
def test_overlap_quantized_halo_equals_blocking_and_jax(plans, bits,
                                                        stochastic):
    pg, plan, jplan = plans
    h = _rand((plan.n_parts, plan.n_local, D), 0)
    rows = (plan.n_parts, plan.halo_rows, D)
    ct = _rand(rows, 1)
    kf, kb = jax.random.split(jax.random.PRNGKey(bits))
    uf, ub = _noise(kf, rows, stochastic), _noise(kb, rows, stochastic)
    jout, (jg,) = _value_and_vjp(lambda x: jol.overlap_quantized_halo(
        x, jplan, kf, kb, bits, bits, stochastic, jnp.bfloat16, JBackend(),
        "jnp"), h)(ct)
    got = []
    for fn in (tol.overlap_quantized_halo, ts.quantized_halo):
        th = torch.from_numpy(h).requires_grad_()
        out = fn(th, plan, bits, bits, stochastic, torch.bfloat16,
                 SimulatedBackend(), u_fwd=uf, u_bwd=ub)
        (g,) = torch.autograd.grad(out, th, torch.from_numpy(ct))
        got.append((out.detach().numpy(), g.numpy()))
    for out, g in got:
        np.testing.assert_array_equal(out, np.asarray(jout))
        np.testing.assert_array_equal(g, np.asarray(jg))
    # site 0 (no gradient wanted) exchanges nothing back, as blocking
    out = tol.overlap_quantized_halo(torch.from_numpy(h), plan, bits, bits,
                                     stochastic, torch.bfloat16,
                                     SimulatedBackend(), u_fwd=uf)
    assert out.grad_fn is None


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", [1, 8])
def test_overlap_stale_and_fresh_halo_equal_blocking_and_jax(plans, bits,
                                                             stochastic):
    pg, plan, jplan = plans
    h = _rand((plan.n_parts, plan.n_local, D), 2)
    rows = (plan.n_parts, plan.halo_rows, D)
    cache = _rand(rows, 3, jplan.recv_mask)
    grad_in = _rand(rows, 4, jplan.send_mask)
    ct = _rand(rows, 5)
    kf, kb = jax.random.split(jax.random.PRNGKey(10 + bits))
    uf, ub = _noise(kf, rows, stochastic), _noise(kb, rows, stochastic)

    def jf(x, gslot):
        return jol.overlap_stale_halo(x, jnp.asarray(cache),
                                      jnp.asarray(grad_in), gslot, jplan, kb,
                                      bits, stochastic, jnp.bfloat16,
                                      JBackend(), "jnp")

    jout, (jgh, jgs) = _value_and_vjp(jf, h, np.zeros(rows, np.float32))(ct)
    for fn in (tol.overlap_stale_halo, ts.stale_halo):
        th = torch.from_numpy(h).requires_grad_()
        gslot = torch.zeros(rows, requires_grad=True)
        out = fn(th, torch.from_numpy(cache), torch.from_numpy(grad_in),
                 gslot, plan, bits, stochastic, torch.bfloat16,
                 SimulatedBackend(), u_bwd=ub)
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
        gh, gs = torch.autograd.grad(out, (th, gslot), torch.from_numpy(ct))
        np.testing.assert_array_equal(gh.numpy(), np.asarray(jgh))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(jgs))

    jfresh = jax.jit(lambda x: jol.overlap_fresh_halo(
        x, jplan, kf, bits, stochastic, jnp.bfloat16, JBackend(), "jnp"))(h)
    th = torch.from_numpy(h).requires_grad_()
    be = SimulatedBackend()
    inflight = tol.overlap_fresh_halo(th, plan, bits, stochastic,
                                      torch.bfloat16, be, u=uf)
    assert isinstance(inflight, Inflight) and inflight.event is None
    fresh = tol.land_fresh(inflight, plan, be)
    assert fresh.grad_fn is None
    np.testing.assert_array_equal(fresh.numpy(), np.asarray(jfresh))
    np.testing.assert_array_equal(
        fresh.numpy(), ts.fresh_halo(th, plan, bits, stochastic,
                                     torch.bfloat16, be, u=uf).numpy())


def test_the_fence_is_the_identity_on_the_cpu(plans):
    _, plan, _ = plans
    be = SimulatedBackend()
    h = torch.from_numpy(_rand((plan.n_parts, plan.n_local, D), 6))
    inflight = tol._issue(h, lambda t: tx.gather_boundary(t, plan), 1, False,
                          torch.bfloat16, be, plan)
    assert inflight.event is None
    x = torch.ones(3)
    assert be.fence(inflight) is inflight and be.fence((inflight, x))[1] is x
    assert tol.fence(be, inflight).qt is inflight.qt


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    pg, _ = datasets.load_partitioned(
        REF, n_parts=4, cache_dir=tmp_path_factory.mktemp("tplans"))
    jpg, _ = jdatasets.load_partitioned(
        REF, n_parts=4, cache_dir=tmp_path_factory.mktemp("plans"))
    return pg, jpg


MODELS = {"gcn": lambda d, c, **kw: GCN(d, 16, c, **kw),
          "graphsage": lambda d, c, **kw: GraphSAGE(d, 16, c, **kw),
          "gat": lambda d, c, **kw: GAT(d, 8, c, heads=2, **kw)}


def _run(pg, arch, mode, schedule, stochastic, epochs=3, counts=None,
         monkeypatch=None):
    model = MODELS[arch](pg.x.shape[-1], pg.n_classes,
                         generator=torch.Generator().manual_seed(0))
    tr = GNNTrainer(model, pg, SylvieConfig(mode=mode, stochastic=stochastic,
                                            schedule=schedule),
                    policy=tpol.Uniform(bits=1, stochastic=stochastic),
                    runtime=CPU)
    if counts is not None:
        for mod, name in ((qref, "quantize_pack_ref"),
                          (qref, "unpack_dequantize_ref"),
                          (sref, "spmm_ref")):
            real = getattr(mod, name)

            def counted(*a, _real=real, _name=name):
                counts[_name] = counts.get(_name, 0) + 1
                return _real(*a)
            monkeypatch.setattr(mod, name, counted)
    tr.fit(epochs)
    if counts is not None:
        monkeypatch.undo()
    return tr


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_overlap_training_is_bit_equal_to_blocking(graphs, arch, mode,
                                                   stochastic, monkeypatch):
    pg, _ = graphs
    counts = {"blocking": {}, "overlap": {}}
    runs = {s: _run(pg, arch, mode, s, stochastic, counts=counts[s],
                    monkeypatch=monkeypatch) for s in ("blocking", "overlap")}
    a, b = runs["blocking"], runs["overlap"]
    assert [m.loss for m in a.history] == [m.loss for m in b.history]
    assert [m.mode for m in b.history] == \
        (["sync"] * 3 if mode == "sync" else ["sync", "async", "async"])
    assert all(m.schedule == "overlap" for m in b.history)
    for x, y in zip(topt.tree_leaves(a.state.params),
                    topt.tree_leaves(b.state.params)):
        assert torch.equal(x, y)
    for x, y in zip(a.state.halo.feats + a.state.halo.grads,
                    b.state.halo.feats + b.state.halo.grads):
        assert torch.equal(x, y)
    # the same plain-version calls (the kernels' launches on the card)
    assert counts["overlap"] == counts["blocking"]
    assert counts["blocking"]["quantize_pack_ref"] > 0


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_overlap_training_matches_jax_overlap(graphs, mode):
    pg, jpg = graphs
    dims = (pg.x.shape[-1], 16, pg.n_classes)
    cfg = dict(mode=mode, bits=1, stochastic=False, schedule="overlap")
    jtr = JTrainer(JGCN(*dims), jpg, JConfig(**cfg),
                   policy=jpol.Uniform(bits=1, stochastic=False))
    tr = GNNTrainer(GCN(*dims), pg, SylvieConfig(**cfg),
                    policy=tpol.Uniform(bits=1, stochastic=False),
                    runtime=CPU,
                    params=jax.tree.map(np.asarray, jtr.state.params))
    want, got = jtr.fit(4), tr.fit(4)
    assert [(m.mode, m.schedule) for m in got] == \
        [(m.mode, m.schedule) for m in want]
    np.testing.assert_allclose([m.loss for m in got],
                               [m.loss for m in want], rtol=1e-4)
    # the modeled split, given the same constants
    flops, peak, bw = 3e9, 989e12, 450e9
    np.testing.assert_allclose(tr.modeled_comm_split(flops, peak, bw),
                               jtr.modeled_comm_split(flops, peak, bw),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# the comm-time model
# ---------------------------------------------------------------------------
def test_the_comm_time_model_equals_jax(plans):
    from repro.policy.base import EpochDecision as JDecision
    from repro_torch.policy.base import EpochDecision
    _, plan, jplan = plans
    dims = (D, 16, 7)
    for bits in (1, 4, 32):
        dec = EpochDecision.uniform(3, bits=bits)
        jdec = JDecision.uniform(3, bits=bits)
        got = tol.site_comm_seconds(plan, dims, dec, 450e9)
        want = jol.site_comm_seconds(jplan, dims, jdec, 450e9)
        assert got == pytest.approx(want, rel=1e-15) and min(got) > 0
    comm, compute = (3.0, 1.0, 0.5), (1.0, 2.0, 0.1)
    for sched in ("blocking", "overlap"):
        assert tol.split_comm_time(comm, compute, sched) == \
            jol.split_comm_time(comm, compute, sched)
        assert tol.modeled_step_seconds(comm, compute, sched) == \
            jol.modeled_step_seconds(comm, compute, sched)
    exp, hid = tol.split_comm_time(comm, compute, "overlap")
    assert hid == sum(min(c, w) for c, w in zip(comm, compute))
    assert exp + hid == sum(comm)


def test_an_unknown_schedule_is_refused(graphs):
    pg, _ = graphs
    with pytest.raises(ValueError, match="unknown schedule"):
        GNNTrainer(GCN(pg.x.shape[-1], 16, pg.n_classes), pg,
                   SylvieConfig(schedule="eager"), runtime=CPU)
    with pytest.raises(ValueError, match="unknown schedule"):
        tol.split_comm_time((1.0,), (1.0,), "eager")
    assert ts.SCHEDULES == ("blocking", "overlap")


def test_engine_overlap_sweep_is_bit_equal_to_blocking(graphs):
    pg, _ = graphs
    params = params_to_numpy(GCN(pg.x.shape[-1], 16, pg.n_classes,
                                 generator=torch.Generator().manual_seed(1)))
    ids = np.arange(0, pg.part_of.size, 7)
    rng = np.random.default_rng(0)
    changed = rng.choice(pg.part_of.size, 12, replace=False)
    rows = rng.normal(0, 1, (12, pg.x.shape[-1])).astype(np.float32)
    out = {}
    for sched in ("blocking", "overlap"):
        for stochastic in (False, True):
            eng = InferenceEngine(
                GCN(pg.x.shape[-1], 16, pg.n_classes), pg, params,
                config=ServeConfig(bits=1, stochastic=stochastic,
                                   schedule=sched), runtime=CPU)
            eng.full_sweep()
            full = (eng.query(ids).logits, eng.embeddings(ids))
            rep = eng.refresh(changed, rows)
            out[sched, stochastic] = full + (rep.kind, eng.query(ids).logits)
    for stochastic in (False, True):
        a, b = out["blocking", stochastic], out["overlap", stochastic]
        assert a[2] == b[2] == "delta"
        for x, y in zip(a[:2] + a[3:], b[:2] + b[3:]):
            np.testing.assert_array_equal(x, y)
