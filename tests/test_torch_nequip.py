"""NequIP of the port against the JAX reference, on the CPU.

* ``so3``: ``gaunt`` equals the reference's for all 27 triples (array for
  array, ``None`` for ``None``), ``coupled_paths`` is the same 11 paths,
  ``real_sh`` is within 1e-6 of ``jso3.real_sh`` and ``wigner_d_numeric``
  equal.
* ``_rbf``: the centers bit for bit ``jnp.linspace``, the enveloped
  Gaussians within 1e-6. ``tensor_product`` within 1e-5 of the
  reference's per-path einsum; one
  ``agg_sum`` over the flat (E, width) messages bit for bit the three calls
  of the reference's layer (one an l), forward and backward.
* ``params_from_numpy`` takes the JAX tree's integer keys (``w_self`` /
  ``w_agg``); ``param_tree`` gives them back, its leaves in
  ``jax.tree.leaves`` order; a JAX checkpoint of a training state restores
  into the port.
* At 32 bits the reduced and full configs are rotation-invariant on
  ``molecules(n_nodes=40)`` without self-loops (2 partitions; rtol 1e-5),
  and layer 0's l = 1 messages turn by ``wigner_d_numeric(R, 1)``. With
  self-loops (``gcn_normalize``) a self-loop's ``Y_20`` does not rotate, so
  the logits move under R, in both packages by the same amounts (1e-5).
* ``_gnn_model_flops("nequip", ...)`` equals the reference's.

The zoo's cases (logits, steps, 10-epoch runs, launches, the entry point,
one rank's block) are in ``tests/test_torch_zoo.py``.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.sylvie import SylvieComm as JComm
from repro.core.sylvie import SylvieConfig as JConfig
from repro.graph import formats as jformats
from repro.graph import partition as jpartition
from repro.graph import synthetic as jsynthetic
from repro.launch import cells as jcells
from repro.models.gnn import blocks as JB
from repro.models.gnn import so3 as jso3
from repro.train import checkpoint as jckpt
from repro.train.trainer import GNNTrainer as JTrainer
from repro_torch import configs
from repro_torch.core.sylvie import SylvieComm, SylvieConfig
from repro_torch.graph import formats, partition, synthetic
from repro_torch.launch import cells
from repro_torch.launch import train as launch
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.gnn import blocks as B
from repro_torch.models.gnn import nequip as NQ
from repro_torch.models.gnn import so3
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import GNNTrainer

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(which="reduced", d_in=16, d_out=4):
    return (getattr(configs.get("nequip"), which)().make(d_in, d_out),
            getattr(jconfigs.get("nequip"), which)().make(d_in, d_out))


def _jparams(jmodel, seed=0):
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# so3
# ---------------------------------------------------------------------------
def test_so3_equals_the_reference():
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(3):
                a, b = so3.gaunt(l1, l2, l3), jso3.gaunt(l1, l2, l3)
                if b is None:
                    assert a is None, (l1, l2, l3)
                    continue
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    ls = (0, 1, 2)
    paths = so3.coupled_paths(ls, ls, ls)
    assert paths == jso3.coupled_paths(ls, ls, ls) and len(paths) == 11
    for p, q in zip(so3._quad_points(), jso3._quad_points()):
        np.testing.assert_array_equal(p, q)
    v = np.random.default_rng(0).normal(0, 1, (300, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    for l_max in (0, 1, 2):
        got = so3.real_sh(torch.from_numpy(v), l_max)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jso3.real_sh(v, l_max)),
                                   rtol=0, atol=1e-6)
        assert so3.sh_slice(l_max) == jso3.sh_slice(l_max)
    rot = _rotation(3)
    for l in (0, 1, 2):
        np.testing.assert_array_equal(so3.wigner_d_numeric(rot, l),
                                      jso3.wigner_d_numeric(rot, l))


def test_tensor_product_matches_the_reference_einsum():
    """``tensor_product`` on random (P, E) inputs against the reference's
    loop (``nequip.py:112-119``) in JAX: each path's ``einsum`` times its
    radial weights, summed into ``msg[l3]`` in path order."""
    for mul in (4, 32):
        _, jm = _models("config")
        paths = jm.paths
        rng = np.random.default_rng(mul)
        src = rng.normal(0, 1, (2, 37, mul * 9)).astype(np.float32)
        v = rng.normal(0, 1, (2, 37, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        sh = so3.real_sh_np(v).astype(np.float32)
        w = rng.normal(0, 1, (2, 37, len(paths) * mul)).astype(np.float32)
        got = NQ.tensor_product(torch.from_numpy(src), torch.from_numpy(sh),
                                torch.from_numpy(w), mul, paths)
        jm = dataclasses.replace(jm, mul=mul)
        src_l = jm._split(jnp.asarray(src))
        wj = jnp.asarray(w).reshape(2, 37, len(paths), mul)
        msg = {l: 0.0 for l in range(3)}
        for pi, (l1, l2, l3) in enumerate(paths):
            m = jnp.einsum("abc,peua,peb->peuc", jnp.asarray(
                jso3.gaunt(l1, l2, l3)), src_l[l1], sh[..., so3.sh_slice(l2)])
            msg[l3] = msg[l3] + m * wj[..., pi, :, None]
        want = np.asarray(jm._flat(msg))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_rbf_matches_the_reference():
    """The centers (cached per device) are ``jnp.linspace(0, cutoff,
    n_rbf)`` bit for bit; the Gaussians under the cosine envelope within
    1e-6, also past the cutoff and at 0 (a self-loop's distance)."""
    from repro_torch.models.gnn.models import rbf_centers
    dist = np.concatenate([[0.0, 2.5, 3.0, 5.0, 7.5], np.random.default_rng(
        0).uniform(0, 6, 500)]).astype(np.float32)
    for which in ("reduced", "config"):
        model, jmodel = _models(which)
        got = rbf_centers(model.cutoff, model.n_rbf, "cpu").numpy()
        want = np.asarray(jnp.linspace(0.0, jmodel.cutoff, jmodel.n_rbf))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert rbf_centers(model.cutoff, model.n_rbf, "cpu") is rbf_centers(
            model.cutoff, model.n_rbf, "cpu")
        rbf = model._rbf(torch.from_numpy(dist)).numpy()
        np.testing.assert_allclose(rbf, np.asarray(jmodel._rbf(
            jnp.asarray(dist))), rtol=1e-6, atol=1e-7)
        assert (rbf[3:5] == 0).all() and rbf[0].max() > 0


def _zoo_block(which="config"):
    pg = launch.gnn_graph(getattr(configs.get("nequip"), which)(),
                          "molecule_like@smoke", 4)
    return pg, B.build_block(pg, "cpu")


def test_one_agg_sum_of_the_flat_messages_is_the_three_calls():
    """The port sums the flat (E, 288) messages in one ``agg_sum``; the
    reference calls it once an l (widths 32, 96, 160). Every column sums in
    the same CSR order, so the sums and their gradient are the same bits."""
    pg, blk = _zoo_block()
    model, _ = _models("config", pg.x.shape[-1], pg.n_classes)
    rng = np.random.default_rng(0)
    msgs = torch.from_numpy(rng.normal(0, 1, (*pg.edge_mask.shape,
                                              model.width)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (4, blk.n_local, model.width))
                         .astype(np.float32))
    a = msgs.clone().requires_grad_()
    one = B.agg_sum(blk, a)
    (ga,) = torch.autograd.grad(one, a, g)
    b = msgs.clone().requires_grad_()
    parts = NQ.split_irreps(b, model.mul, model.l_max)
    three = {l: B.agg_sum(blk, parts[l].reshape(*b.shape[:2], -1)).reshape(
        4, blk.n_local, model.mul, 2 * l + 1) for l in parts}
    three = NQ.flat_irreps(three)
    (gb,) = torch.autograd.grad(three, b, g)
    assert torch.equal(one.view(torch.int32), three.view(torch.int32))
    assert torch.equal(ga.view(torch.int32), gb.view(torch.int32))


# ---------------------------------------------------------------------------
# parameters and checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["reduced", "config"])
def test_params_from_numpy_takes_the_integer_keys(which):
    model, jmodel = _models(which)
    tree = _jparams(jmodel)
    assert set(tree["layer0"]["w_self"]) == {0, 1, 2}
    # the port's own tree: the reference's keys, shapes and leaf order
    mine = model.param_tree()
    assert jax.tree.structure(jax.tree.map(lambda t: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, tree))
    assert [tuple(t.shape) for t in topt.tree_leaves(mine)] == \
        [a.shape for a in jax.tree.leaves(tree)]
    params_from_numpy(model, tree)
    for a, b in zip(topt.tree_leaves(model.param_tree()),
                    jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    bad = jax.tree.map(lambda a: a, tree)
    del bad["layer1"]["w_agg"][2]
    with pytest.raises(KeyError, match="layer1/w_agg/2"):
        params_from_numpy(model, bad)


def test_port_init_draws_the_reference_distributions():
    """glorot linears; ``w_self`` / ``w_agg`` normal x 1/sqrt(mul)."""
    model = NQ.NequIP(16, 4, generator=torch.Generator().manual_seed(0))
    lim = np.sqrt(6 / (model.n_rbf + model.mul))
    w = model.get_parameter("layer0.radial.l0.w").detach()
    assert float(w.abs().max()) <= lim and float(w.abs().max()) > 0.9 * lim
    mixes = torch.stack([model.get_parameter(f"layer{i}.{n}.{l}").detach()
                         for i in range(5) for n in ("w_self", "w_agg")
                         for l in range(3)])
    std = float(mixes.std()) * np.sqrt(model.mul)
    assert 0.95 < std < 1.05
    assert not model.get_parameter("layer0.gate.b").detach().any()


def test_a_jax_checkpoint_of_a_nequip_state_restores_into_the_port():
    pg = launch.gnn_graph(configs.get("nequip").reduced(),
                          "molecule_like@smoke", 4)
    jpg = _jax_graph_molecule_smoke()
    model, jmodel = _models("reduced", pg.x.shape[-1], pg.n_classes)
    cfg = dict(mode="async", bits=1, stochastic=False)
    jtr = JTrainer(jmodel, jpg, JConfig(**cfg))
    jtr.train_epoch()                   # Adam moments and halo caches set
    tr = GNNTrainer(model, pg, SylvieConfig(**cfg), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 1, jtr.state)
        tree, _, needs_sync = ckpt.restore(d, tr.state)
        assert ckpt.latest_step(d) == 1
    assert not needs_sync
    assert set(tree.params["layer1"]["w_agg"]) == {0, 1, 2}
    got = ckpt._flatten(tree)
    want = jckpt._flatten(jtr.state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), k)


def _jax_graph_molecule_smoke():
    from repro import datasets as jdatasets
    g = jdatasets.load("molecule_like@smoke")
    g, ew = jformats.gcn_normalize(g)
    g.edge_attr = JB.geometry_edge_attr(g)
    return jpartition.partition_graph(g, 4, edge_weight=ew)


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------
def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(0, 1, (3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def _molecule_graphs(fm, sy, geometry, rot, self_loops):
    """``molecules(40)`` with positions turned by ``rot``, edge geometry,
    2 partitions; with self-loops through ``gcn_normalize``."""
    g = sy.molecules(n_nodes=40, d_feat=8, seed=1)
    g.pos = (g.pos.astype(np.float64) @ rot.T).astype(np.float32)
    ew = None
    if self_loops:
        g, ew = fm.gcn_normalize(g)
    g.edge_attr = geometry(g)
    return g, ew


def _port_logits(model, rot, self_loops, record=None):
    g, ew = _molecule_graphs(formats, synthetic, B.geometry_edge_attr, rot,
                             self_loops)
    pg = partition.partition_graph(g, 2, edge_weight=ew)
    blk = B.build_block(pg, "cpu")
    comm = SylvieComm(SylvieConfig(mode="vanilla"), blk.plan)
    with torch.no_grad():
        return model(blk, torch.from_numpy(pg.x), comm).numpy(), pg


@pytest.mark.parametrize("which", ["reduced", "config"])
def test_logits_are_rotation_invariant_without_self_loops(which,
                                                          monkeypatch):
    model, jmodel = _models(which, 8, 4)
    params_from_numpy(model, _jparams(jmodel))
    msgs = []
    real = NQ.tensor_product

    def recorded(*a):
        out = real(*a)
        msgs.append(out)
        return out
    monkeypatch.setattr(NQ, "tensor_product", recorded)
    rot = _rotation(7)
    base, pg = _port_logits(model, np.eye(3), False)
    turned, pg_r = _port_logits(model, rot, False)
    np.testing.assert_array_equal(pg.edges, pg_r.edges)
    assert np.abs(base).max() > 1e-3
    np.testing.assert_allclose(turned, base, rtol=1e-5,
                               atol=1e-5 * np.abs(base).max())
    # layer 0's l = 1 messages turn by D_1(R): Y_1(R r) = D_1(R) Y_1(r)
    n_layers = model.n_layers
    m0, m1 = msgs[0], msgs[n_layers]
    mask = torch.from_numpy(pg.edge_mask)
    parts0 = NQ.split_irreps(m0, model.mul, model.l_max)[1][mask]
    parts1 = NQ.split_irreps(m1, model.mul, model.l_max)[1][mask]
    d1 = torch.from_numpy(so3.wigner_d_numeric(rot, 1).astype(np.float32))
    want = parts0 @ d1.T
    assert float(parts0.abs().max()) > 1e-3
    np.testing.assert_allclose(parts1.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_self_loops_break_invariance_in_both_packages_alike():
    """A self-loop's unit vector is 0, so its ``Y_20 = C2B (3 z^2 - 1)`` is
    ``-C2B`` whatever R is: the logits move under R, by the same amounts in
    both packages."""
    sh0 = so3.real_sh_np(np.zeros((1, 3)))
    np.testing.assert_array_equal(sh0, jso3.real_sh_np(np.zeros((1, 3))))
    assert sh0[0, 6] == -so3._C2B and np.count_nonzero(sh0) == 2
    model, jmodel = _models("reduced", 8, 4)
    params = _jparams(jmodel)
    params_from_numpy(model, params)
    rot = _rotation(7)
    moved = {}
    for pkg in ("port", "jax"):
        logits = []
        for r in (np.eye(3), rot):
            if pkg == "port":
                logits.append(_port_logits(model, r, True)[0])
                continue
            g, ew = _molecule_graphs(jformats, jsynthetic,
                                     JB.geometry_edge_attr, r, True)
            jpg = jpartition.partition_graph(g, 2, edge_weight=ew)
            jblk = JB.build_block(jpg)
            fwd = jax.jit(lambda p, x: jmodel.apply(p, jblk, x, JComm(
                JConfig(mode="vanilla"), jblk.plan, KEY)))
            logits.append(np.asarray(fwd(params, jnp.asarray(jpg.x))))
        moved[pkg] = logits[1] - logits[0]
    # without self-loops the logits move by float rounding only
    noise = np.abs(_port_logits(model, rot, False)[0]
                   - _port_logits(model, np.eye(3), False)[0]).max()
    assert np.abs(moved["jax"]).max() > 100 * noise
    np.testing.assert_allclose(moved["port"], moved["jax"], rtol=0,
                               atol=1e-5)


def test_model_flops_equal_the_reference():
    for which in ("reduced", "config"):
        model, jmodel = _models(which, 16, 4)
        for train in (False, True):
            got = cells._gnn_model_flops("nequip", model, 400, 3556, 16,
                                         train)
            want = jcells._gnn_model_flops("nequip", jmodel, 400, 3556, 16,
                                           train)
            assert got == want
    # a name it does not know: the reference's generic estimate
    for train in (False, True):
        assert cells._gnn_model_flops("nosuch", model, 400, 3556, 16,
                                      train) == \
            jcells._gnn_model_flops("nosuch", jmodel, 400, 3556, 16, train)
