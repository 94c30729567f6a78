"""The port's training communication against the JAX reference, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch`` on the dense
and compact plans of a ``method="skewed"`` 4-way partition (ragged ring
buckets, so the two ring directions differ):

* ``quantized_halo``, ``stale_halo`` and ``fresh_halo`` (the port's
  ``torch.autograd.Function``s against the ``jax.custom_vjp``s): forward
  values and the VJP under a random cotangent, at bits 1/2/8, deterministic
  and stochastic. Stochastic runs inject JAX's own noise
  (``jax.random.uniform`` of the forward and backward keys) into both
  directions. Equal: the quantized payloads bit for bit, the halos and the
  gradients exactly (the scatter adds the same values in slot order). The
  JAX side runs under ``jax.jit``, as its trainer does: XLA turns the
  scale's division by ``2^b - 1`` into a multiply by the reciprocal only in
  a compiled program, and that multiply is the port's scale (op by op, one
  row's bf16 scale of this input comes out one ulp apart);
* a port whose backward reused the forward ring direction fails that check;
* ``scatter_boundary_grad`` exactly equals JAX;
* the SpMM backward (the kernel's plain version over the transposed CSR,
  hub rows split into 128-edge segments) is allclose (1e-6) to ``jax.vjp``
  of ``agg_sum(gather_src(table) * w)``;
* the optimizers and global-norm clipping over 5 steps (rtol 1e-6), EF21
  over 4 rounds (exact at 2/4 bits; rtol 1e-5 at 1 bit), and every built-in
  policy's decisions over one telemetry sequence (equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exchange as jx
from repro.core import quantization as jq
from repro.core import sylvie as js
from repro.dist.backend import SimulatedBackend as JBackend
from repro.graph import formats as jformats
from repro.graph import partition as jpartition
from repro.graph import synthetic as jsynthetic
from repro.models.gnn import blocks as JB
from repro.policy import base as jpb
from repro.policy import builtin as jpol
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro_torch.core import exchange as tx
from repro_torch.core import quantization as tq
from repro_torch.core import sylvie as ts
from repro_torch.dist.backend import SimulatedBackend
from repro_torch.graph import formats, partition, synthetic
from repro_torch.kernels.spmm.ref import SEGMENT
from repro_torch.models.gnn import blocks as TB
from repro_torch.policy import base as tpb
from repro_torch.policy import builtin as tpol
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt

D = 24
BITS = (1, 2, 8)


def _skewed(layout, hub=0):
    """The same skewed partition from both packages; ``hub`` > 0 joins node
    0 to that many others in both directions (a hub row and column)."""
    out = []
    for fm, sy, pa in ((formats, synthetic, partition),
                       (jformats, jsynthetic, jpartition)):
        g = sy.powerlaw_community(n_nodes=600, d_feat=D, avg_degree=10,
                                  seed=0)
        if hub:
            others = np.arange(1, hub + 1, dtype=g.edge_index.dtype)
            extra = np.stack([np.concatenate([others, 0 * others]),
                              np.concatenate([0 * others, others])])
            g = dataclasses.replace(g, edge_index=np.concatenate(
                [g.edge_index, extra], axis=1))
        g, ew = fm.gcn_normalize(g)
        out.append(pa.partition_graph(g, 4, method="skewed", edge_weight=ew,
                                      layout=layout))
    return out


@pytest.fixture(scope="module", params=["dense", "compact"])
def plans(request):
    pg, jpg = _skewed(request.param)
    return (pg, tx.PlanArrays.from_plan(pg.plan),
            jx.PlanArrays.from_plan(jpg.plan))


def _h(pg, seed=0, d=D):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (pg.plan.n_parts, pg.plan.n_local, d)
                      ).astype(np.float32)


def _keys(seed=0):
    return jax.random.split(jax.random.PRNGKey(seed))


def _noise(key, shape, stochastic):
    if not stochastic:
        return None, None
    u = jax.random.uniform(key, shape, dtype=jnp.float32)
    return np.asarray(u), torch.tensor(np.asarray(u))


def _value_and_vjp(f, *args):
    """``f(*args)`` and its VJP under a cotangent, compiled by ``jax.jit``."""
    def run(args, ct):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(ct)
    return lambda ct: jax.jit(run)(tuple(jnp.asarray(a) for a in args),
                                   jnp.asarray(ct))


def _cotangent(plan, seed, d=D):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (plan.n_parts, plan.halo_rows, d)
                      ).astype(np.float32)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_quantized_halo_value_and_vjp_equal_jax(plans, bits, stochastic):
    pg, plan, jplan = plans
    h = _h(pg)
    kf, kb = _keys(bits)
    shape = (plan.n_parts, plan.halo_rows, D)
    _, uf = _noise(kf, shape, stochastic)
    _, ub = _noise(kb, shape, stochastic)
    ct = _cotangent(plan, 1)
    jout, (jg,) = _value_and_vjp(lambda x: js.quantized_halo(
        x, jplan, kf, kb, bits, bits, stochastic, jnp.bfloat16, JBackend(),
        "jnp"), h)(ct)
    th = torch.from_numpy(h).requires_grad_()
    out = ts.quantized_halo(th, plan, bits, bits, stochastic, torch.bfloat16,
                            SimulatedBackend(), u_fwd=uf, u_bwd=ub)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    (g,) = torch.autograd.grad(out, th, torch.from_numpy(ct))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    # the payload on the wire, both directions, bit for bit
    quant = jax.jit(lambda b, k: jq.quantize(b, bits, k, stochastic,
                                             impl="jnp"))
    for buf, key, u in ((jx.gather_boundary(jnp.asarray(h), jplan), kf, uf),
                        (jnp.where(jplan.recv_mask[..., None], ct, 0), kb,
                         ub)):
        jqt = quant(buf, key)
        qt = tq.quantize(torch.tensor(np.asarray(buf)), bits,
                         stochastic=stochastic, u=u)
        np.testing.assert_array_equal(qt.data.numpy(), np.asarray(jqt.data))
        np.testing.assert_array_equal(qt.scale.float().numpy(),
                                      np.asarray(jqt.scale, np.float32))


def test_quantized_halo_exchanges_nothing_back_without_a_gradient(plans):
    """Site 0's ``h`` is the input: no backward exchange runs (JAX prunes it
    too) — the halo has no gradient function to run."""
    pg, plan, _ = plans
    h = torch.from_numpy(_h(pg))
    out = ts.quantized_halo(h, plan, 1, 1, False, torch.bfloat16,
                            SimulatedBackend())
    assert out.grad_fn is None


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_stale_and_fresh_halo_equal_jax(plans, bits, stochastic):
    pg, plan, jplan = plans
    h = _h(pg)
    rows = (plan.n_parts, plan.halo_rows, D)
    rng = np.random.default_rng(5)
    cache = rng.normal(0, 1, rows).astype(np.float32)
    grad_in = np.where(np.asarray(jplan.send_mask)[..., None],
                       rng.normal(0, 1, rows), 0).astype(np.float32)
    kf, kb = _keys(10 + bits)
    _, uf = _noise(kf, rows, stochastic)
    _, ub = _noise(kb, rows, stochastic)

    def jf(x, gslot):
        return js.stale_halo(x, jnp.asarray(cache), jnp.asarray(grad_in),
                             gslot, jplan, kb, bits, stochastic,
                             jnp.bfloat16, JBackend(), "jnp")

    ct = _cotangent(plan, 2)
    jout, (jgh, jgs) = _value_and_vjp(jf, h, np.zeros(rows, np.float32))(ct)
    th = torch.from_numpy(h).requires_grad_()
    gslot = torch.zeros(rows, requires_grad=True)
    out = ts.stale_halo(th, torch.from_numpy(cache), torch.from_numpy(grad_in),
                        gslot, plan, bits, stochastic, torch.bfloat16,
                        SimulatedBackend(), u_bwd=ub)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    gh, gs = torch.autograd.grad(out, (th, gslot), torch.from_numpy(ct))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(jgh))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(jgs))

    jfresh = jax.jit(lambda x: js.fresh_halo(
        x, jplan, kf, bits, stochastic, jnp.bfloat16, JBackend(), "jnp"))(h)
    fresh = ts.fresh_halo(th, plan, bits, stochastic, torch.bfloat16,
                          SimulatedBackend(), u=uf)
    assert fresh.grad_fn is None
    np.testing.assert_array_equal(fresh.numpy(), np.asarray(jfresh))


def test_a_backward_over_the_forward_rings_fails_the_check(monkeypatch):
    """On the compact skewed plan the reversed rings matter: run the parity
    check with the port's backward exchange forced onto the forward rings and
    it must disagree with JAX (and agree again once restored)."""
    pg, jpg = _skewed("compact")
    plan, jplan = tx.PlanArrays.from_plan(pg.plan), \
        jx.PlanArrays.from_plan(jpg.plan)
    h, ct = _h(pg), _cotangent(plan, 3)
    kf, kb = _keys()
    _, (want,) = _value_and_vjp(lambda x: js.quantized_halo(
        x, jplan, kf, kb, 8, 8, False, jnp.bfloat16, JBackend(), "jnp"),
        h)(ct)
    want = np.asarray(want)

    def grad():
        th = torch.from_numpy(h).requires_grad_()
        out = ts.quantized_halo(th, plan, 8, 8, False, torch.bfloat16,
                                SimulatedBackend())
        return torch.autograd.grad(out, th, torch.from_numpy(ct))[0].numpy()

    np.testing.assert_array_equal(grad(), want)
    real = ts.exchange_quantized_halo
    monkeypatch.setattr(ts, "exchange_quantized_halo",
                        lambda qt, p, be, reverse=False: real(qt, p, be))
    assert not np.array_equal(grad(), want)


def test_scatter_boundary_grad_equals_jax(plans):
    """The fixed 0/1 scatter CSR (slot order within each owner row) gives
    JAX's ``.at[idx].add`` exactly, masked slots adding nothing."""
    pg, plan, jplan = plans
    g = _cotangent(plan, 4, d=7)
    got = tx.scatter_boundary_grad(torch.from_numpy(g), plan)
    want = jx.scatter_boundary_grad(jnp.asarray(g), jplan)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    csr = plan.scatter
    assert csr.nnz == int(np.asarray(jplan.send_mask).sum())
    assert csr.n_rows == plan.n_parts * plan.n_local
    assert csr.n_cols == plan.n_parts * plan.halo_rows


@pytest.mark.parametrize("layout", ["dense", "compact"])
def test_spmm_backward_matches_jax_vjp(layout):
    """``aggregate``'s gradient is the plain SpMM over the transposed CSR:
    allclose (rtol and atol 1e-6) to ``jax.vjp`` of ``agg_sum(gather_src(
    table) * w)``. A 300-neighbour hub makes split rows in both the CSR and
    its transpose."""
    pg, jpg = _skewed(layout, hub=300)
    blk, jblk = TB.build_block(pg), JB.build_block(jpg)
    assert blk.csr.long_rows.numel() and blk.csr_t.long_rows.numel()
    assert int(torch.diff(blk.csr_t.row_ptr).max()) > 2 * SEGMENT
    p, n_ext = pg.plan.n_parts, pg.plan.n_local + pg.plan.halo_rows
    rng = np.random.default_rng(6)
    table = rng.normal(0, 1, (p, n_ext, 13)).astype(np.float32)
    ct = rng.normal(0, 1, (p, pg.plan.n_local, 13)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: JB.agg_sum(
        jblk, JB.gather_src(jblk, t) * jblk.edge_weight[..., None]),
        jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    tt = torch.from_numpy(table).requires_grad_()
    (got,) = torch.autograd.grad(TB.aggregate(blk, tt), tt,
                                 torch.from_numpy(ct))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _param_tree(seed):
    rng = np.random.default_rng(seed)
    return {"layer0": {"w": rng.normal(0, 1, (6, 5)).astype(np.float32),
                       "b": rng.normal(0, 1, (5,)).astype(np.float32)},
            "layer1": {"w": rng.normal(0, 1, (5, 3)).astype(np.float32)}}


def _to_torch(tree):
    return topt.tree_map(torch.from_numpy, tree)


def _assert_trees_close(a, b, rtol, atol=1e-7):
    for x, y in zip(topt.tree_leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("name,clip", [
    ("sgd", None), ("sgd_momentum", 0.5), ("adam", None), ("adam", 1.0),
    ("adamw", 0.3)])
def test_optimizers_and_clipping_match_jax(name, clip):
    make = {"sgd": lambda m: m.sgd(0.1),
            "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9),
            "adam": lambda m: m.adam(1e-2),
            "adamw": lambda m: m.adamw(1e-2, weight_decay=0.05)}[name]
    opt, jo = make(topt), make(jopt)
    params, jparams = _to_torch(_param_tree(0)), \
        jax.tree.map(jnp.asarray, _param_tree(0))
    state, jstate = opt.init(params), jo.init(jparams)
    for step in range(5):
        grads = _param_tree(10 + step)
        g, jg = _to_torch(grads), jax.tree.map(jnp.asarray, grads)
        if clip is not None:
            g, n = topt.clip_by_global_norm(g, clip)
            jg, jn = jopt.clip_by_global_norm(jg, clip)
            np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
        upd, state = opt.update(g, state, params)
        jupd, jstate = jo.update(jg, jstate, jparams)
        params = topt.apply_updates(params, upd)
        jparams = jopt.apply_updates(jparams, jupd)
        _assert_trees_close(params, jparams, 1e-6)
    _assert_trees_close(state, jstate, 1e-6)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_ef21_matches_jax(bits):
    """EF21 over 4 rounds. At 2 and 4 bits the compressor is the Low-bit
    Module's deterministic quantize: estimates and residuals equal JAX's
    exactly. At 1 bit (scaled sign) the row means of ``|x|`` sum in another
    order than XLA's (one ulp apart), which the feedback carries from round
    to round: allclose at rtol 1e-5, atol 1e-6."""
    state = tcomp.EFState.zeros_like(_to_torch(_param_tree(0)))
    jstate = jcomp.EFState.zeros_like(jax.tree.map(jnp.asarray,
                                                   _param_tree(0)))
    for r in range(4):
        grads = _param_tree(20 + r)
        est, state = tcomp.ef_allreduce(_to_torch(grads), state, bits=bits)
        jest, jstate = jcomp.ef_allreduce(jax.tree.map(jnp.asarray, grads),
                                          jstate, bits=bits)
        tol = (1e-5, 1e-6) if bits == 1 else (0, 0)
        _assert_trees_close(est, jest, *tol)
        _assert_trees_close(state.error, jstate.error, *tol)
    assert tcomp.ef_wire_bytes(_to_torch(_param_tree(0)), bits) == \
        jcomp.ef_wire_bytes(jax.tree.map(jnp.asarray, _param_tree(0)), bits)


def _policies(m):
    return [m.Uniform(bits=1), m.Uniform(bits=3, sync=True),
            m.Warmup(epochs=2, bits=1), m.BoundedStaleness(eps_s=3, bits=2),
            m.BoundedStaleness(eps_s=None, stochastic=False),
            m.AdaQPVariance(budget_bits=4),
            m.Chain(m.Warmup(epochs=1, bits=4), m.BoundedStaleness(eps_s=2),
                    m.Uniform(bits=1, ef_bits=2))]


def test_builtin_policies_decide_as_jax():
    """Every built-in policy over one telemetry sequence (stats appearing at
    epoch 1, a needs_sync resume at epoch 4): equal decisions, snapped and
    unsnapped, and equal names."""
    dims = (64, 16, 16)
    for pol, jp in zip(_policies(tpol), _policies(jpol)):
        assert pol.name == jp.name
        for epoch in range(7):
            kw = dict(epoch=epoch, n_parts=4, n_sites=3, site_dims=dims,
                      needs_sync=epoch == 4, val_history=(0.5,) * epoch)
            stats = [(d, 100 + 10 * i, 0.3 * (i + 1) ** 2)
                     for i, d in enumerate(dims)] if epoch else None
            tel = tpb.Telemetry(site_stats=stats and tuple(
                tpb.SiteStats(*s) for s in stats), **kw)
            jtel = jpb.Telemetry(site_stats=stats and tuple(
                jpb.SiteStats(*s) for s in stats), **kw)
            d, jd = pol.decide(tel), jp.decide(jtel)
            for mine, ref in ((d, jd), (d.snapped(), jd.snapped())):
                assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
            assert dataclasses.asdict(d.with_bits(32)) == \
                dataclasses.asdict(jd.with_bits(32))
            assert d.bits_per_site() == jd.bits_per_site()
