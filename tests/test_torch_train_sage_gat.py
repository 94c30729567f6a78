"""The port's GraphSAGE and GAT training against the JAX reference, on the
CPU.

``yelp_like@small`` partitioned 4 ways by both packages, the reduced paper
configs (d_hidden 16, 2 layers; GAT 4 heads), the JAX trainer's initial
parameters carried into the port, deterministic rounding:

* one sync and one async step from the same state (the async one from the
  state the sync step left), at 1 bit and, for GAT, at 8 bits: loss within
  rtol 1e-5, ``site_stats`` rtol 1e-5, weight gradients (``sgd(1.0)``)
  rtol 1e-5, atol 1e-5, halo features equal but for at most 8 rows per
  site, each within one bf16 ulp of its row's range (a row's bf16 scale
  rounding to its neighbour), halo gradients within 0.5% of the
  site's largest. One exception, stated: GAT's 1-bit *sync* step holds its
  weight gradients only within 2% of each leaf's largest (1.2% measured).
  GAT exchanges the projected features, so its site 0 sends a gradient
  back, and both sites' 1-bit gradient exchanges feed this step's update:
  the 3 site-1 rows whose bf16 scale rounds differently (products in
  another order than XLA's) perturb the incoming gradients by ~1e-3, and
  every 1-bit code that close to its row's midpoint flips, each by the
  row's whole range. At 8 bits the same step holds rtol 1e-5, atol 1e-5;
* 10 epochs of ``GNNTrainer`` — vanilla, Sylvie-S ``Uniform(1)``, Sylvie-A
  ``BoundedStaleness(eps_s=4)`` — for both models, losses within rtol 1e-4
  (GAT's loss falls to ~1e-4; the largest gap measured is 3.1e-5
  relative), modes, bits per site and bytes equal every epoch. For GAT at
  1 bit the JAX state is carried into the port (checkpoint format) before
  every epoch: the flips above make a free run chaotic (it drifts up to
  60% apart by epoch 9), while each epoch from the same state agrees
  within 8e-6;
* the JAX parameter trees of both models load into the port's modules and
  come back out equal (``models/convert.py``);
* GAT checkpoints resume across packages (Sylvie-A: JAX saves at epoch 3;
  the port's epochs 3-4 match JAX's uninterrupted run, rtol 1e-4);
* at the paper's widths (``reddit_like``'s 602 features, average degree
  64, 41 classes; 400 nodes) GAT 4x64 trains at 32 bits in both packages
  (losses within rtol 1e-4), but at 1 bit with stochastic rounding the
  loss starts several times higher and rises, in JAX as in the port (each
  with its own noise): the reference's GAT exchanges the projected features
  that its attention scores are computed from, and 1-bit noise there enters
  the softmax's exponent (``ROADMAP.md`` §C);
* a training step runs each kernel's plain version the documented number
  of times (``TRAIN_CALLS``, which ``chip_smoke.py``'s ``TRAIN_LAUNCHES``
  holds the card to) and never ``index_add_``, ``scatter_add_`` or
  ``torch.sparse.mm``.
"""
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro import datasets as jdatasets
from repro.core.sylvie import SylvieConfig as JConfig
from repro.graph import formats as jformats
from repro.graph import partition as jpartition
from repro.graph import synthetic as jsynthetic
from repro.models.gnn import blocks as JB
from repro.models.gnn.models import GAT as JGAT
from repro.models.gnn.models import GraphSAGE as JSAGE
from repro.policy import builtin as jpol
from repro.train import checkpoint as jckpt
from repro.train import gnn_step as jstep
from repro.train import optimizer as jopt
from repro.train.trainer import GNNTrainer as JTrainer
from repro_torch import datasets
from repro_torch.core.sylvie import SylvieConfig
from repro_torch.dist.runtime import Runtime
from repro_torch.graph import formats, partition, synthetic
from repro_torch.kernels.gat import ref as gref
from repro_torch.kernels.quant import ref as qref
from repro_torch.kernels.spmm import ref as sref
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.gnn import blocks as B
from repro_torch.models.gnn.models import GAT, GraphSAGE
from repro_torch.policy import builtin as tpol
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import gnn_step as tstep
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import GNNTrainer

REF = "yelp_like@small"
D_HIDDEN = 16
CPU = Runtime.simulated(4, device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run thousands of tiny torch ops; beside the other
    workers of a parallel test run, torch's idle threads spinning between
    them cost far more than they give. Each test here runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
ARCHS = {"graphsage": (GraphSAGE, JSAGE), "gat": (GAT, JGAT)}
CONFIGS = {
    "vanilla": (dict(mode="vanilla"), None),
    "sylvie_s": (dict(mode="sync", bits=1, stochastic=False),
                 lambda m: m.Uniform(bits=1, stochastic=False)),
    "sylvie_a": (dict(mode="async", bits=1, stochastic=False),
                 lambda m: m.BoundedStaleness(eps_s=4, bits=1,
                                              stochastic=False)),
}
# plain-version calls per training step: (quantize, dequantize, SpMM,
# per-head SpMM, softmax, SDDMM, softmax backward + transposed row sums),
# by (arch, mode, bits). GraphSAGE runs as GCN does: forward 2 SpMM over the
# unit CSR, backward 1 over its transpose (2 async: the gslot gradient at
# site 0) and 1 scatter. GAT's site 0 exchanges hw, which has a gradient:
# both sites quantize both ways in either step and scatter 2 gradients; per
# layer 1 softmax and 1 per-head SpMM forward, 1 per-head SpMM over the
# transposed CSR, 1 SDDMM and 2 softmax-backward calls backward.
TRAIN_CALLS = {
    ("graphsage", "sync", 32): (0, 0, 4, 0, 0, 0, 0),
    ("graphsage", "sync", 1): (3, 3, 4, 0, 0, 0, 0),
    ("graphsage", "async", 1): (4, 4, 5, 0, 0, 0, 0),
    ("gat", "sync", 32): (0, 0, 2, 4, 2, 2, 4),
    ("gat", "sync", 1): (4, 4, 2, 4, 2, 2, 4),
    ("gat", "async", 1): (4, 4, 2, 4, 2, 2, 4),
}
REFS = ((qref, "quantize_pack_ref"), (qref, "unpack_dequantize_ref"),
        (sref, "spmm_ref"), (sref, "spmm_heads_ref"),
        (gref, "gat_softmax_ref"), (gref, "sddmm_heads_ref"),
        (gref, ("gat_softmax_bwd_ref", "row_sums_t_ref")))


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    pg, _ = datasets.load_partitioned(
        REF, n_parts=4, cache_dir=tmp_path_factory.mktemp("tplans"))
    jpg, _ = jdatasets.load_partitioned(
        REF, n_parts=4, cache_dir=tmp_path_factory.mktemp("plans"))
    return pg, jpg


def _models(arch, pg):
    dims = (pg.x.shape[-1], D_HIDDEN, pg.n_classes)
    mine, ref = ARCHS[arch]
    return mine(*dims), ref(*dims)


def _trainers(graphs, arch, name, **kw):
    pg, jpg = graphs
    cfg, pol = CONFIGS[name]
    model, jmodel = _models(arch, pg)
    jtr = JTrainer(jmodel, jpg, JConfig(**cfg),
                   policy=pol(jpol) if pol else None, **kw)
    params = jax.tree.map(np.asarray, jtr.state.params)
    tr = GNNTrainer(model, pg, SylvieConfig(**cfg),
                    policy=pol(tpol) if pol else None, runtime=CPU,
                    params=params, **kw)
    return tr, jtr


def _jax_state_in_port(jstate, example):
    """A JAX training state carried into the port through the checkpoint
    format."""
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 0, jstate)
        tree, _, needs_sync = ckpt.restore(d, example)
    assert not needs_sync
    return CPU.place(tree)


@pytest.mark.parametrize("arch,bits", [("graphsage", 1), ("gat", 1),
                                       ("gat", 8)])
def test_one_sync_and_one_async_step_match_jax(graphs, arch, bits):
    pg, jpg = graphs
    model, jmodel = _models(arch, pg)
    cfg = dict(mode="async", bits=bits, stochastic=False)
    opt, jo = topt.sgd(1.0), jopt.sgd(1.0)
    jts, jta, _ = (jax.jit(f) for f in jstep.make_gnn_steps(
        jmodel, JConfig(**cfg), jo))
    ts, ta, _ = tstep.make_gnn_steps(model, SylvieConfig(**cfg), opt)
    jblock, block = JB.build_block(jpg), B.build_block(pg, "cpu")
    x, y, mask = (torch.as_tensor(a) for a in (pg.x, pg.y, pg.train_mask))
    jargs = [jax.numpy.asarray(a) for a in (pg.x, pg.y, pg.train_mask)]
    key = jax.random.PRNGKey(0)
    j0 = jstep.GNNTrainState.create(jmodel, jo, key, jblock.plan)
    state = tstep.GNNTrainState.create(model.param_tree(), opt,
                                       block.plan, model.comm_dims())
    for i, (f, jf) in enumerate(((ts, jts), (ta, jta))):
        state = _jax_state_in_port(j0, state)
        j1, jloss = jf(j0, jblock, *jargs, key)
        s1, loss = f(state, block, x, y, mask, (0, i))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        loose = arch == "gat" and bits == 1 and i == 0
        for a, b, a0, b0 in zip(topt.tree_leaves(s1.params),
                                jax.tree.leaves(j1.params),
                                topt.tree_leaves(state.params),
                                jax.tree.leaves(j0.params)):
            want = np.asarray(b0 - b)
            atol = 2e-2 * np.abs(want).max() if loose else 1e-5
            np.testing.assert_allclose((a0 - a).numpy(), want, rtol=1e-5,
                                       atol=atol)
        np.testing.assert_allclose(s1.site_stats.numpy(),
                                   np.asarray(j1.site_stats), rtol=1e-5)
        for a, b in zip(s1.halo.feats, j1.halo.feats):
            a, b = a.numpy(), np.asarray(b)
            diff = (a != b).any(-1)
            row_range = b.max(-1) - b.min(-1)
            assert diff.sum() <= 8
            assert (np.abs(a - b).max(-1)[diff]
                    <= 2.0 ** -7 * row_range[diff]).all()
        for a, b in zip(s1.halo.grads, j1.halo.grads):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 5e-3 * np.abs(b).max()
        if i == 1:          # the async step's new grads are the gslot grads
            assert all(float(g.abs().sum()) > 0 for g in s1.halo.grads)
        j0 = j1


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_ten_epochs_match_jax_trainer(graphs, arch, name):
    tr, jtr = _trainers(graphs, arch, name)
    lockstep = arch == "gat" and name != "vanilla"
    for _ in range(10):
        if lockstep:
            tr.state = _jax_state_in_port(jtr.state, tr.state)
        jtr.train_epoch()
        tr.train_epoch()
    got, want = tr.history, jtr.history
    np.testing.assert_allclose([m.loss for m in got],
                               [m.loss for m in want], rtol=1e-4)
    assert [(m.mode, m.comm_payload_mb, m.comm_ec_mb, m.bits_per_site,
             m.policy) for m in got] == \
        [(m.mode, m.comm_payload_mb, m.comm_ec_mb, m.bits_per_site,
          m.policy) for m in want]
    assert got[-1].loss < 0.1 * got[0].loss
    assert tr.evaluate("val") == pytest.approx(jtr.evaluate("val"))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_trees_carry_over_both_ways(graphs, arch):
    pg, _ = graphs
    model, jmodel = _models(arch, pg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3)))
    back = params_to_numpy(params_from_numpy(model, tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    bad = jax.tree.map(lambda a: a, tree)
    bad["layer0"].popitem()
    with pytest.raises(KeyError):
        params_from_numpy(model, bad)


def test_gat_resumes_across_packages(graphs, tmp_path):
    """Sylvie-A under BoundedStaleness(4): epoch 3 is pipelined (it needs
    the checkpointed halo caches), epoch 4 synchronous."""
    tr, jtr = _trainers(graphs, "gat", "sylvie_a",
                        ckpt_dir=str(tmp_path / "j"), ckpt_every=3)
    jtr.fit(3)                                   # JAX saves at epoch 3
    full_j = [m.loss for m in jtr.fit(2)[-2:]]

    t2, _ = _trainers(graphs, "gat", "sylvie_a")
    t2.ckpt_dir = str(tmp_path / "j")
    assert t2.resume() and t2.epoch == 3
    got = t2.fit(2)
    assert [m.mode for m in got] == ["async", "sync"]
    np.testing.assert_allclose([m.loss for m in got], full_j, rtol=1e-4)

    t2.ckpt_dir = str(tmp_path / "t")
    t2.save()                                    # the port saves at epoch 5
    _, j3 = _trainers(graphs, "gat", "sylvie_a")
    j3.ckpt_dir = str(tmp_path / "t")
    assert j3.resume() and j3.epoch == 5
    for a, b in zip(jax.tree.leaves(j3.state.params),
                    topt.tree_leaves(t2.state.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_gat_at_paper_widths_fails_to_train_at_one_bit_as_jax_does():
    kw = dict(n_nodes=400, avg_degree=64, d_feat=602, n_classes=41,
              p_in=0.85, gamma=0.8)
    pgs = []
    for fm, sy, pa in ((formats, synthetic, partition),
                       (jformats, jsynthetic, jpartition)):
        g, ew = fm.gcn_normalize(sy.by_name("powerlaw_community", seed=0,
                                            **kw))
        pgs.append(pa.partition_graph(g, 4, edge_weight=ew))
    pg, jpg = pgs
    dims = (602, 64, 41)
    losses = {}
    for name, cfg in (("vanilla", dict(mode="vanilla")),
                      ("one_bit", dict(mode="sync", bits=1))):
        jtr = JTrainer(JGAT(*dims), jpg, JConfig(**cfg))
        tr = GNNTrainer(GAT(*dims), pg, SylvieConfig(**cfg), runtime=CPU,
                        params=jax.tree.map(np.asarray, jtr.state.params))
        losses[name] = ([m.loss for m in jtr.fit(3)],
                        [m.loss for m in tr.fit(3)])
    want, got = losses["vanilla"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want[-1] < 0.1 * want[0]
    for one_bit in losses["one_bit"]:                # JAX's, then the port's
        assert one_bit[0] > 3 * want[0] and one_bit[-1] > one_bit[0]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_training_runs_each_kernel_as_documented(graphs, arch, monkeypatch):
    """Per step, on the CPU, the kernels' plain versions run as often as the
    kernels launch on the card (``TRAIN_CALLS``; the softmax backward's two
    modes are one kernel). Nothing on the path adds with ``index_add_``,
    ``scatter_add_`` or ``torch.sparse.mm``."""
    counts = {}
    for i, (mod, names) in enumerate(REFS):
        for name in (names if isinstance(names, tuple) else (names,)):
            real = getattr(mod, name)

            def counted(*a, _real=real, _i=i):
                counts[_i] = counts.get(_i, 0) + 1
                return _real(*a)
            monkeypatch.setattr(mod, name, counted)

    def refuse(*a, **k):
        raise AssertionError("an atomic or library scatter on the path")
    for owner, name in ((torch.Tensor, "index_add_"),
                        (torch.Tensor, "scatter_add_"),
                        (torch.Tensor, "index_add"), (torch, "index_add"),
                        (torch, "scatter_add"), (torch.sparse, "mm")):
        monkeypatch.setattr(owner, name, refuse)
    seen = []
    for name in ("vanilla", "sylvie_a"):
        tr, _ = _trainers(graphs, arch, name)
        for _ in range(2):                # epochs 0 (sync), 1 (async at 1 bit)
            counts.clear()
            m = tr.train_epoch()
            bits = m.bits_per_site[0][0]
            seen.append(((arch, m.mode, bits), tuple(
                counts.get(i, 0) for i in range(len(REFS)))))
    assert seen == [(k, TRAIN_CALLS[k]) for k, _ in seen]
    assert {k for k, _ in seen} == {k for k in TRAIN_CALLS if k[0] == arch}
