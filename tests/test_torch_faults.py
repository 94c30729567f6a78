"""The port's fault injection (``repro_torch.faults``) against the JAX
reference (``repro.faults``), on the CPU.

* ``FaultPlan.events`` draws the reference's events array for array (host
  numpy, ``default_rng([seed, epoch])``), preemption and delays included;
  ``FaultCtl.expand`` gives the reference's wire masks on the dense and the
  compact plans of a ``method="skewed"`` 4-way partition;
* ``row_checksum`` and ``flip_rows`` equal the reference's on uint8, bf16 and
  f32 payloads (bit patterns compared), and ``checked_exchange`` gives the
  same received payload and ok mask under corruption and drops;
* the three faulty Functions against the ``custom_vjp``s with JAX's noise
  injected, deterministic and stochastic rounding, at 1 and 8 bits: forward
  values and gradients exactly equal (as the clean Functions are in
  ``test_torch_train_comm.py``; the JAX side runs under ``jax.jit``); a
  clean (all-false) mask block gives the clean Functions' values bit for
  bit;
* whole faulted runs of GCN (``yelp_like@smoke``, P = 4, d_hidden 16,
  deterministic rounding, ``drop=0.15,corrupt=0.05,seed=7``), sync and
  async, against JAX's ``GNNTrainer(fault_plan=...)``: per-epoch
  ``faults_injected`` / ``halos_reused`` / ``forced_syncs`` / ``stall_s``
  equal, the escalation in the same epochs (modes and bits per site equal),
  losses at rtol 1e-4;
* a rate-zero plan is bit-identical to no plan; a runtime whose backend is a
  ``FaultyBackend`` arms the trainer; the deprecated ``eps_s=`` warns and
  equals ``BoundedStaleness``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import datasets as jdatasets
from repro.core import exchange as jx
from repro.core import quantization as jq
from repro.core.sylvie import SylvieConfig as JConfig
from repro.dist.backend import SimulatedBackend as JBackend
from repro.faults import comm as jfc
from repro.faults import plan as jfp
from repro.faults import wire as jfw
from repro.graph import formats as jformats
from repro.graph import partition as jpartition
from repro.graph import synthetic as jsynthetic
from repro.models.gnn.models import GCN as JGCN
from repro.policy import builtin as jpol
from repro.train.trainer import GNNTrainer as JTrainer
from repro_torch import datasets
from repro_torch.core import exchange as tx
from repro_torch.core import quantization as tq
from repro_torch.core import sylvie as ts
from repro_torch.core.sylvie import SylvieConfig
from repro_torch.dist.backend import SimulatedBackend
from repro_torch.dist.runtime import Runtime
from repro_torch.faults import comm as tfc
from repro_torch.faults import plan as tfp
from repro_torch.faults import wire as tfw
from repro_torch.faults.backend import FaultyBackend
from repro_torch.graph import formats, partition, synthetic
from repro_torch.models.convert import params_to_numpy
from repro_torch.models.gnn.models import GCN
from repro_torch.policy import builtin as tpol
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import GNNTrainer

D = 24
REF = "yelp_like@smoke"
SPEC = dict(seed=7, drop_rate=0.15, corrupt_rate=0.05)
CPU = Runtime.simulated(4, device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skewed(layout):
    out = []
    for fm, sy, pa in ((formats, synthetic, partition),
                       (jformats, jsynthetic, jpartition)):
        g = sy.powerlaw_community(n_nodes=600, d_feat=D, avg_degree=10,
                                  seed=0)
        g, ew = fm.gcn_normalize(g)
        out.append(pa.partition_graph(g, 4, method="skewed", edge_weight=ew,
                                      layout=layout))
    return out


@pytest.fixture(scope="module", params=["dense", "compact"])
def plans(request):
    pg, jpg = _skewed(request.param)
    return (pg, tx.PlanArrays.from_plan(pg.plan),
            jx.PlanArrays.from_plan(jpg.plan))


def _masks(plan, seed, rate=0.3):
    """Four random (P, rows) masks: drop_fwd, corrupt_fwd, drop_bwd,
    corrupt_bwd, as numpy."""
    rng = np.random.default_rng(seed)
    return [rng.random((plan.n_parts, plan.halo_rows)) < rate
            for _ in range(4)]


def _site_faults(masks):
    return (tfp.SiteFaults(*(torch.from_numpy(m) for m in masks)),
            jfp.SiteFaults(*(jnp.asarray(m) for m in masks)))


# ---------------------------------------------------------------------------
# the schedule and its wire masks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    SPEC, dict(seed=3, drop_rate=0.5, preempt_rate=0.3),
    dict(seed=11, corrupt_rate=0.2, delay_rate=0.4, delay_s=0.02),
    dict(seed=0, drop_rate=1.0, warmup_clean=False)])
def test_fault_plan_draws_the_references_events(kw):
    mine, ref = tfp.FaultPlan(**kw), jfp.FaultPlan(**kw)
    for epoch in range(5):
        for n_sites, n_parts in ((2, 4), (3, 8)):
            a = mine.events(epoch, n_sites, n_parts)
            b = ref.events(epoch, n_sites, n_parts)
            for f in ("drop", "corrupt", "delay", "preempted"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.n_injected == b.n_injected
            np.testing.assert_array_equal(a.faulty_sites(), b.faulty_sites())
            assert a.stall_s(mine.delay_s) == b.stall_s(ref.delay_s)
    assert tfp.FaultPlan.n_units(2, 4) == jfp.FaultPlan.n_units(2, 4)


def test_fault_ctl_expands_to_the_references_masks(plans):
    _, plan, jplan = plans
    mine, ref = tfp.RowGeometry.from_plan(plan), \
        jfp.RowGeometry.from_plan(jplan)
    assert dataclasses.astuple(mine) == dataclasses.astuple(ref)
    for a, b in zip(mine.peers(), ref.peers()):
        np.testing.assert_array_equal(a, b)
    fp = tfp.FaultPlan(seed=5, drop_rate=0.4, corrupt_rate=0.3,
                       preempt_rate=0.2)
    for epoch in (1, 2, 3):
        ev = fp.events(epoch, 3, plan.n_parts)
        ctl = tfp.FaultCtl.expand(ev, mine, 3)
        jctl = jfp.FaultCtl.expand(ev, ref, 3)
        assert ctl.masks.dtype == torch.bool
        np.testing.assert_array_equal(ctl.masks.numpy(),
                                      np.asarray(jctl.masks))
        assert ctl.masks.any()
        for s, js_ in zip(ctl.sites, jctl.sites):
            for f in ("drop_fwd", "corrupt_fwd", "drop_bwd", "corrupt_bwd"):
                np.testing.assert_array_equal(getattr(s, f).numpy(),
                                              np.asarray(getattr(js_, f)))
    clean = tfp.FaultCtl.clean(mine, 3)
    assert clean.masks.shape == ctl.masks.shape and not clean.masks.any()


# ---------------------------------------------------------------------------
# the checksummed wire
# ---------------------------------------------------------------------------
def _payloads(seed=0):
    """The same (4, 6, 3) payload as uint8, bf16 and f32 in both packages."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (4, 6, 3), dtype=np.uint8)
    bf = rng.integers(0, 1 << 16, (4, 6, 3), dtype=np.uint16)
    f32 = rng.normal(size=(4, 6, 3)).astype(np.float32)
    return [
        (torch.from_numpy(u8), jnp.asarray(u8)),
        (torch.from_numpy(bf.view(np.int16)).view(torch.bfloat16),
         jax.lax.bitcast_convert_type(jnp.asarray(bf), jnp.bfloat16)),
        (torch.from_numpy(f32), jnp.asarray(f32)),
    ]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8).reshape(a.shape[:-1] + (-1,))


def test_row_checksum_and_flip_rows_equal_the_reference():
    mask = np.random.default_rng(1).random((4, 6)) < 0.4
    for t, j in _payloads():
        np.testing.assert_array_equal(_bits(t), _jbits(j))
        got, want = tfw.row_checksum(t), jfw.row_checksum(j)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        flipped = tfw.flip_rows(t, torch.from_numpy(mask))
        assert flipped.dtype == t.dtype and flipped.shape == t.shape
        np.testing.assert_array_equal(
            _bits(flipped), _jbits(jfw.flip_rows(j, jnp.asarray(mask))))
        changed = (tfw.row_checksum(flipped) != got).numpy()
        np.testing.assert_array_equal(changed, mask)     # exact detection
        np.testing.assert_array_equal(
            _bits(tfw.flip_rows(flipped, torch.from_numpy(mask))), _bits(t))
    # a non-contiguous payload is viewed through a contiguous copy
    t = _payloads()[2][0].transpose(0, 1).contiguous().transpose(0, 1)
    assert not t.is_contiguous()
    np.testing.assert_array_equal(tfw.row_checksum(t).numpy(),
                                  tfw.row_checksum(t.contiguous()).numpy())


@pytest.mark.parametrize("bits", [1, 32])
def test_checked_exchange_equals_the_reference(plans, bits):
    pg, plan, jplan = plans
    h = np.random.default_rng(2).normal(
        size=(plan.n_parts, plan.n_local, D)).astype(np.float32)
    buf = tx.gather_boundary(torch.from_numpy(h), plan)
    qt = tq.quantize(buf, bits, stochastic=False)
    jqt = jax.jit(lambda b: jq.quantize(b, bits, None, False, impl="jnp"))(
        jx.gather_boundary(jnp.asarray(h), jplan))
    drop, corrupt = _masks(plan, 3)[:2]
    qr, ok = tfw.checked_exchange(qt, plan, SimulatedBackend(),
                                  torch.from_numpy(corrupt),
                                  torch.from_numpy(drop))
    jqr, jok = jfw.checked_exchange(jqt, jplan, JBackend(),
                                    jnp.asarray(corrupt), jnp.asarray(drop))
    np.testing.assert_array_equal(_bits(qr.data), _jbits(jqr.data))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert (~ok.numpy()).sum() >= drop.sum()
    # the reversed rings condemn the same rows in both packages too
    qr, ok = tfw.checked_exchange(qt, plan, SimulatedBackend(),
                                  torch.from_numpy(corrupt),
                                  torch.from_numpy(drop), reverse=True)
    jqr, jok = jfw.checked_exchange(jqt, jplan, JBackend(),
                                    jnp.asarray(corrupt), jnp.asarray(drop),
                                    reverse=True)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


# ---------------------------------------------------------------------------
# the faulty Functions against the custom_vjps
# ---------------------------------------------------------------------------
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


def _rows(plan, seed, live=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (plan.n_parts, plan.halo_rows, D)).astype(np.float32)
    if live is not None:
        x = np.where(np.asarray(live)[..., None], x, 0).astype(np.float32)
    return x


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", [1, 8])
def test_faulty_quantized_halo_equals_jax(plans, bits, stochastic):
    pg, plan, jplan = plans
    h = np.random.default_rng(4).normal(
        size=(plan.n_parts, plan.n_local, D)).astype(np.float32)
    cache = _rows(plan, 5, jplan.recv_mask)
    ct = _rows(plan, 6)
    kf, kb = jax.random.split(jax.random.PRNGKey(bits))
    shape = (plan.n_parts, plan.halo_rows, D)
    uf, ub = _noise(kf, shape, stochastic), _noise(kb, shape, stochastic)
    sf, jsf = _site_faults(_masks(plan, 7))
    jout, (jg,) = _value_and_vjp(lambda x: jfc.faulty_quantized_halo(
        x, jnp.asarray(cache), jsf, jplan, kf, kb, bits, bits, stochastic,
        jnp.bfloat16, JBackend(), "jnp"), h)(ct)
    th = torch.from_numpy(h).requires_grad_()
    out = tfc.faulty_quantized_halo(th, torch.from_numpy(cache), sf, plan,
                                    bits, bits, stochastic, torch.bfloat16,
                                    SimulatedBackend(), u_fwd=uf, u_bwd=ub)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    (g,) = torch.autograd.grad(out, th, torch.from_numpy(ct))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    # a dropped live row is the cache's row
    drop = sf.drop_fwd.numpy() & np.asarray(jplan.recv_mask)
    assert drop.any()
    np.testing.assert_array_equal(out.detach().numpy()[drop], cache[drop])
    # a clean mask block is the clean Function, bit for bit
    csf, _ = _site_faults([np.zeros_like(m) for m in _masks(plan, 7)])
    th2 = torch.from_numpy(h).requires_grad_()
    clean = ts.quantized_halo(th2, plan, bits, bits, stochastic,
                              torch.bfloat16, SimulatedBackend(), u_fwd=uf,
                              u_bwd=ub)
    armed = tfc.faulty_quantized_halo(th, torch.from_numpy(cache), csf, plan,
                                      bits, bits, stochastic, torch.bfloat16,
                                      SimulatedBackend(), u_fwd=uf, u_bwd=ub)
    np.testing.assert_array_equal(armed.detach().numpy(),
                                  clean.detach().numpy())
    np.testing.assert_array_equal(
        torch.autograd.grad(armed, th, torch.from_numpy(ct))[0].numpy(),
        torch.autograd.grad(clean, th2, torch.from_numpy(ct))[0].numpy())


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", [1, 8])
def test_faulty_stale_and_fresh_halo_equal_jax(plans, bits, stochastic):
    pg, plan, jplan = plans
    h = np.random.default_rng(8).normal(
        size=(plan.n_parts, plan.n_local, D)).astype(np.float32)
    rows = (plan.n_parts, plan.halo_rows, D)
    cache = _rows(plan, 9, jplan.recv_mask)
    grad_in = _rows(plan, 10, jplan.send_mask)
    ct = _rows(plan, 11)
    kf, kb = jax.random.split(jax.random.PRNGKey(20 + bits))
    uf, ub = _noise(kf, rows, stochastic), _noise(kb, rows, stochastic)
    sf, jsf = _site_faults(_masks(plan, 12))

    def jf(x, gslot):
        return jfc.faulty_stale_halo(x, jnp.asarray(cache),
                                     jnp.asarray(grad_in), gslot, jsf, jplan,
                                     kb, bits, stochastic, jnp.bfloat16,
                                     JBackend(), "jnp")

    jout, (jgh, jgs) = _value_and_vjp(jf, h, np.zeros(rows, np.float32))(ct)
    th = torch.from_numpy(h).requires_grad_()
    gslot = torch.zeros(rows, requires_grad=True)
    out = tfc.faulty_stale_halo(th, torch.from_numpy(cache),
                                torch.from_numpy(grad_in), gslot, sf, plan,
                                bits, stochastic, torch.bfloat16,
                                SimulatedBackend(), u_bwd=ub)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    gh, gs = torch.autograd.grad(out, (th, gslot), torch.from_numpy(ct))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(jgh))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(jgs))

    jfresh = jax.jit(lambda x: jfc.faulty_fresh_halo(
        x, jnp.asarray(cache), jsf, jplan, kf, bits, stochastic,
        jnp.bfloat16, JBackend(), "jnp"))(h)
    fresh = tfc.faulty_fresh_halo(th, torch.from_numpy(cache), sf, plan,
                                  bits, stochastic, torch.bfloat16,
                                  SimulatedBackend(), u=uf)
    assert fresh.grad_fn is None
    np.testing.assert_array_equal(fresh.numpy(), np.asarray(jfresh))

    # clean masks: the clean Functions' values and gradients, bit for bit
    csf, _ = _site_faults([np.zeros_like(m) for m in _masks(plan, 12)])
    args = (plan, bits, stochastic, torch.bfloat16, SimulatedBackend())

    def stale(faulty):
        th_ = torch.from_numpy(h).requires_grad_()
        gs_ = torch.zeros(rows, requires_grad=True)
        pre = (th_, torch.from_numpy(cache), torch.from_numpy(grad_in), gs_)
        o = tfc.faulty_stale_halo(*pre, csf, *args, u_bwd=ub) if faulty \
            else ts.stale_halo(*pre, *args, u_bwd=ub)
        return [o.detach().numpy()] + [t.numpy() for t in torch.autograd.grad(
            o, (th_, gs_), torch.from_numpy(ct))]

    for a, b in zip(stale(True), stale(False)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tfc.faulty_fresh_halo(th, torch.from_numpy(cache), csf, *args,
                              u=uf).numpy(),
        ts.fresh_halo(th, *args, u=uf).numpy())


# ---------------------------------------------------------------------------
# whole faulted runs against JAX's trainer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    pg, _ = datasets.load_partitioned(
        REF, n_parts=4, cache_dir=tmp_path_factory.mktemp("tplans"))
    jpg, _ = jdatasets.load_partitioned(
        REF, n_parts=4, cache_dir=tmp_path_factory.mktemp("plans"))
    return pg, jpg


def _pair(graphs, mode, fault=None, **kw):
    pg, jpg = graphs
    dims = (pg.x.shape[-1], 16, pg.n_classes)
    cfg = dict(mode=mode, bits=1, stochastic=False)
    jtr = JTrainer(JGCN(*dims), jpg, JConfig(**cfg),
                   policy=jpol.Uniform(bits=1, stochastic=False),
                   fault_plan=jfp.FaultPlan(**fault) if fault else None)
    tr = GNNTrainer(GCN(*dims), pg, SylvieConfig(**cfg),
                    policy=tpol.Uniform(bits=1, stochastic=False),
                    runtime=CPU,
                    params=jax.tree.map(np.asarray, jtr.state.params),
                    fault_plan=tfp.FaultPlan(**fault) if fault else None,
                    **kw)
    return tr, jtr


ACCOUNTING = ("faults_injected", "halos_reused", "forced_syncs", "stall_s",
              "mode", "bits_per_site")


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_faulted_training_matches_jax_epoch_by_epoch(graphs, mode):
    tr, jtr = _pair(graphs, mode, SPEC)
    epochs = 6
    want = jtr.fit(epochs)
    got = tr.fit(epochs)
    for a, b in zip(got, want):
        assert [getattr(a, f) for f in ACCOUNTING] == \
            [getattr(b, f) for f in ACCOUNTING], a.epoch
        assert a.faults_injected == a.halos_reused + a.forced_syncs
    # the schedule escalates: a forced full-precision synchronous epoch
    assert any(m.forced_syncs for m in got)
    assert sum(m.faults_injected for m in got) > 0
    assert all(b == (32, 32) for m in got if m.forced_syncs
               for b in m.bits_per_site)
    np.testing.assert_allclose([m.loss for m in got],
                               [m.loss for m in want], rtol=1e-4)
    np.testing.assert_array_equal(tr._site_staleness, jtr._site_staleness)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_rate_zero_plan_is_bit_identical_to_none(graphs, mode):
    plain, _ = _pair(graphs, mode)
    armed, _ = _pair(graphs, mode, dict(seed=3))
    assert isinstance(armed.runtime.backend, FaultyBackend)
    a, b = plain.fit(3), armed.fit(3)
    assert [m.loss for m in a] == [m.loss for m in b]
    assert all(m.faults_injected == m.halos_reused == m.forced_syncs == 0
               for m in b)
    assert armed.state.faults is not None and plain.state.faults is None
    for x, y in zip(topt.tree_leaves(plain.state.params),
                    topt.tree_leaves(armed.state.params)):
        assert torch.equal(x, y)


def test_a_faulty_backend_arms_the_trainer(graphs):
    pg, _ = graphs
    fp = tfp.FaultPlan(**SPEC)
    runtime = Runtime(FaultyBackend(SimulatedBackend(4), fp),
                      torch.device("cpu"))
    tr = GNNTrainer(GCN(pg.x.shape[-1], 16, pg.n_classes), pg,
                    SylvieConfig(mode="sync", bits=1), runtime=runtime)
    assert tr.fault_plan == fp and tr.runtime.n_parts == 4
    tr.fit(2)
    assert tr.history[1].faults_injected == \
        fp.events(1, tr.n_sites, 4).n_injected > 0
    with pytest.raises(ValueError, match="differs"):
        GNNTrainer(GCN(pg.x.shape[-1], 16, pg.n_classes), pg,
                   runtime=runtime, fault_plan=tfp.FaultPlan(seed=1))


def test_eps_s_shim_warns_and_equals_bounded_staleness(graphs):
    pg, _ = graphs
    cfg = SylvieConfig(mode="async", bits=1, stochastic=False)
    dims = (pg.x.shape[-1], 16, pg.n_classes)
    params = params_to_numpy(GCN(*dims,
                                 generator=torch.Generator().manual_seed(0)))
    with pytest.warns(DeprecationWarning, match="eps_s"):
        old = GNNTrainer(GCN(*dims), pg, cfg, eps_s=3, runtime=CPU,
                         params=params)
    new = GNNTrainer(GCN(*dims), pg, cfg, runtime=CPU, params=params,
                     policy=tpol.BoundedStaleness(eps_s=3, bits=1,
                                                  stochastic=False))
    assert old.policy == new.policy
    a, b = old.fit(4), new.fit(4)
    assert [m.mode for m in a] == ["sync", "async", "async", "sync"]
    assert [(m.loss, m.mode) for m in a] == [(m.loss, m.mode) for m in b]
    with pytest.raises(ValueError, match="not both"):
        GNNTrainer(GCN(*dims), pg, cfg, eps_s=3, runtime=CPU,
                   policy=new.policy)
