"""The port's GCN training against the JAX reference, on the CPU.

``yelp_like@small`` partitioned 4 ways (compact layout) by both packages,
GCN (d_hidden 16, 2 layers) with the JAX trainer's initial parameters
carried into the port, deterministic rounding:

* one sync and one async step from the same state (the async one from the
  state the sync step left, so its caches are live): loss and ``site_stats``
  allclose (rtol 1e-5), weight gradients (``sgd(1.0)``: the update is minus
  the gradient) at rtol 1e-5, atol 1e-5. The halo caches are equal but for
  rows counted and bounded here. The products run in another order than
  XLA's (ulps apart), so (a) a row's bf16 scale can round to the neighbouring
  bf16 value: the sync step's site-1 ``feats`` have 3 such rows of 3,424
  here (at most 8 pass), each within one bf16 ulp of its row's largest
  value, and they move the layer-1 gradient by up to 4.2e-6; (b) a gradient
  row that is cancellation noise (mathematically zero: ~1e-8 against
  gradients up to ~1e-4) takes other 1-bit codes: the async step's ``grads``
  differ in 71 / 113 such rows at sites 0 / 1 here (at most 10% pass), each
  below 1e-3 of the site's largest gradient;
* 10 epochs of ``GNNTrainer`` — vanilla (losses within rtol 1e-5), Sylvie-S
  ``Uniform(1)`` and Sylvie-A ``BoundedStaleness(eps_s=4)`` (rtol 1e-4);
  and 6 epochs (fewer, for time) of ``AdaQPVariance(budget_bits=4)``,
  ``Warmup(3)``, EF21 at 1 and 2 bits and Sylvie-A at 2 bits (rtol 1e-4),
  modes, bits per site, payload and EC bytes equal every epoch;
* Boundary-Node Sampling (``boundary_sample_p = 0.5``), sync and Sylvie-A
  (``eps_s = 3``), 6 epochs: the port gets the keep-masks the JAX
  reference draws (``bernoulli(fold_in(epoch key, 999))``, recomputed
  here) and the losses match within rtol 1e-4 (1.6e-7 / 3.9e-6 measured);
* checkpoints resume across packages (JAX saves at epoch 3, the port's
  epochs 4-5 match JAX's uninterrupted run, rtol 1e-4; and the reverse),
  and a 4-part checkpoint resumed at 2 parts forces a synchronous epoch;
* a training step runs the kernels' plain versions the documented number of
  times (quantize / dequantize / SpMM: 3 / 3 / 4 sync, 4 / 4 / 5 async) and
  never ``index_add_``, ``scatter_add_`` or ``torch.sparse.mm``;
* the entry points (``launch.train --arch gcn``, ``api.train``,
  ``GNNTrainer``) need a card unless asked for the CPU; ``--arch
  graphsage`` and ``--arch gat`` train on the CPU when asked.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import datasets as jdatasets
from repro.core.sylvie import SylvieConfig as JConfig
from repro.models.gnn import blocks as JB
from repro.models.gnn.models import GCN as JGCN
from repro.policy import builtin as jpol
from repro.train import checkpoint as jckpt
from repro.train import gnn_step as jstep
from repro.train import optimizer as jopt
from repro.train.trainer import GNNTrainer as JTrainer
from repro_torch import api, datasets
from repro_torch.core.sylvie import SylvieConfig
from repro_torch.dist.runtime import Runtime
from repro_torch.kernels.quant import ref as qref
from repro_torch.kernels.spmm import ref as sref
from repro_torch.launch import train as launch
from repro_torch.models.gnn import blocks as B
from repro_torch.models.gnn.models import GCN
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


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    pg, _ = datasets.load_partitioned(
        REF, n_parts=4, cache_dir=tmp_path_factory.mktemp("tplans"))
    jpg, _ = jdatasets.load_partitioned(
        REF, n_parts=4, cache_dir=tmp_path_factory.mktemp("plans"))
    return pg, jpg


def _models(pg):
    dims = (pg.x.shape[-1], D_HIDDEN, pg.n_classes)
    return GCN(*dims), JGCN(*dims)


CONFIGS = {
    "vanilla": (dict(mode="vanilla"), None, 1e-5),
    "sylvie_s": (dict(mode="sync", bits=1, stochastic=False),
                 lambda m: m.Uniform(bits=1, stochastic=False), 1e-4),
    "sylvie_a": (dict(mode="async", bits=1, stochastic=False),
                 lambda m: m.BoundedStaleness(eps_s=4, bits=1,
                                              stochastic=False), 1e-4),
    "adaqp_4": (dict(mode="sync", bits=1, stochastic=False),
                lambda m: m.AdaQPVariance(budget_bits=4, stochastic=False),
                1e-4),
    "warmup_3": (dict(mode="sync", bits=1, stochastic=False),
                 lambda m: m.Warmup(epochs=3, bits=1, stochastic=False),
                 1e-4),
    "ef21_1": (dict(mode="sync", bits=1, stochastic=False),
               lambda m: m.Uniform(bits=1, stochastic=False, ef_bits=1),
               1e-4),
    "ef21_2": (dict(mode="sync", bits=1, stochastic=False),
               lambda m: m.Uniform(bits=1, stochastic=False, ef_bits=2),
               1e-4),
    "sylvie_a_2": (dict(mode="async", bits=2, stochastic=False),
                   lambda m: m.BoundedStaleness(eps_s=4, bits=2,
                                                stochastic=False), 1e-4),
}
# these three run 10 epochs; the other cases 6, for the tests' time
TEN_EPOCHS = ("vanilla", "sylvie_s", "sylvie_a")


def _trainers(graphs, name, **kw):
    pg, jpg = graphs
    cfg, pol, _ = CONFIGS[name]
    model, jmodel = _models(pg)
    jtr = JTrainer(jmodel, jpg, JConfig(**cfg),
                   policy=pol(jpol) if pol else None, **kw)
    params = jax.tree.map(np.asarray, jtr.state.params)
    tr = GNNTrainer(model, pg, SylvieConfig(**cfg),
                    policy=pol(tpol) if pol else None, runtime=CPU,
                    params=params, **kw)
    return tr, jtr


def _jax_state_in_port(jstate, example, tmp_path):
    """A JAX training state carried into the port through the checkpoint
    format (which also holds the two trees' paths equal)."""
    jckpt.save(tmp_path, 0, jstate)
    tree, _, needs_sync = ckpt.restore(tmp_path, example)
    assert not needs_sync
    # the same paths (JAX's ``faults=None`` leaves none): "halo/feats/0", ...
    assert sorted(ckpt._flatten(example)) == sorted(jckpt._flatten(jstate))
    assert "halo/grads/1" in ckpt._flatten(example)
    return CPU.place(tree)


def test_one_sync_and_one_async_step_match_jax(graphs, tmp_path):
    pg, jpg = graphs
    model, jmodel = _models(pg)
    cfg = dict(mode="async", bits=1, stochastic=False)
    opt, jo = topt.sgd(1.0), jopt.sgd(1.0)
    jts, jta, _ = (jax.jit(f) for f in jstep.make_gnn_steps(
        jmodel, JConfig(**cfg), jo))
    ts, ta, _ = tstep.make_gnn_steps(model, SylvieConfig(**cfg), opt)
    jblock = JB.build_block(jpg)
    block = B.build_block(pg, "cpu")
    x, y, mask = (torch.as_tensor(a) for a in (pg.x, pg.y, pg.train_mask))
    jx_, jy, jmask = (jax.numpy.asarray(a) for a in (pg.x, pg.y,
                                                     pg.train_mask))
    key = jax.random.PRNGKey(0)
    j0 = jstep.GNNTrainState.create(jmodel, jo, key, jblock.plan)
    state = tstep.GNNTrainState.create(model.param_tree(), opt,
                                       block.plan, model.comm_dims())
    for i, (f, jf) in enumerate(((ts, jts), (ta, jta))):
        state = _jax_state_in_port(j0, state, tmp_path / str(i))
        j1, jloss = jf(j0, jblock, jx_, jy, jmask, key)
        s1, loss = f(state, block, x, y, mask, (0, i))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for a, b, a0, b0 in zip(topt.tree_leaves(s1.params),
                                jax.tree.leaves(j1.params),
                                topt.tree_leaves(state.params),
                                jax.tree.leaves(j0.params)):
            np.testing.assert_allclose((a0 - a).numpy(),
                                       np.asarray(b0 - b), rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(s1.site_stats.numpy(),
                                   np.asarray(j1.site_stats), rtol=1e-5)
        rows = [_differing_rows(a, b, 2.0 ** -7)
                for a, b in zip(s1.halo.feats, j1.halo.feats)]
        assert rows[0] == 0 and rows[1] <= 8, rows       # site 0 is x
        rows = [_differing_rows(a, b, 1e-3, noise=True)
                for a, b in zip(s1.halo.grads, j1.halo.grads)]
        assert max(rows) <= 0.1 * s1.halo.grads[0].shape[1] * 4, rows
        if i == 1:          # the async step's new grads are the gslot grads
            assert all(float(g.abs().sum()) > 0 for g in s1.halo.grads)
        j0 = j1


def _differing_rows(mine, ref, bound, noise=False) -> int:
    """The halo rows where the port and JAX differ. Each must be within
    ``bound`` of its row's largest value, or with ``noise``, a row whose
    values are all below ``bound`` times the site's largest value."""
    a, b = mine.numpy(), np.asarray(ref)
    diff = (a != b).any(-1)
    row_max = np.abs(b).max(-1)
    if noise:
        assert (row_max[diff] <= bound * np.abs(b).max()).all()
    else:
        assert (np.abs(a - b).max(-1)[diff] <= bound * row_max[diff]).all()
    return int(diff.sum())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ten_epochs_match_jax_trainer(graphs, name):
    tr, jtr = _trainers(graphs, name)
    epochs = 10 if name in TEN_EPOCHS else 6
    want = [m.loss for m in jtr.fit(epochs)]
    got = tr.fit(epochs)
    np.testing.assert_allclose([m.loss for m in got], want,
                               rtol=CONFIGS[name][2])
    assert [m.mode for m in got] == [m.mode for m in jtr.history]
    assert [(m.comm_payload_mb, m.comm_ec_mb, m.bits_per_site, m.policy)
            for m in got] == [(m.comm_payload_mb, m.comm_ec_mb,
                               m.bits_per_site, m.policy)
                              for m in jtr.history]
    assert tr.evaluate("val") == pytest.approx(jtr.evaluate("val"))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_bns_training_matches_jax_with_its_masks(graphs, mode):
    """BNS at p = 0.5 (sync; Sylvie-A with eps_s = 3, whose sync epochs
    sample): the port takes the JAX reference's keep-masks, one per epoch
    shared by every site (``repro/core/sylvie.py`` draws them from
    ``fold_in(epoch key, 999)``), and trains to the same losses."""
    pg, jpg = graphs
    p, kw = 0.5, dict(bits=1, stochastic=False)
    cfg = dict(mode=mode, boundary_sample_p=p, **kw)
    pol = (lambda m: m.BoundedStaleness(eps_s=3, boundary_sample_p=p, **kw)
           ) if mode == "async" else None
    model, jmodel = _models(pg)
    jtr = JTrainer(jmodel, jpg, JConfig(**cfg),
                   policy=pol(jpol) if pol else None)
    shape = tuple(B.build_block(pg).plan.recv_mask.shape)

    def masks(epoch):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                                    epoch), 999)
        keep = torch.from_numpy(np.array(
            jax.random.bernoulli(key, 1.0 - p, shape)))
        return (keep,) * len(model.comm_dims())
    tr = GNNTrainer(model, pg, SylvieConfig(**cfg),
                    policy=pol(tpol) if pol else None, runtime=CPU,
                    params=jax.tree.map(np.asarray, jtr.state.params),
                    bns_masks=masks)
    want = [m.loss for m in jtr.fit(6)]
    got = tr.fit(6)
    assert [m.mode for m in got] == [m.mode for m in jtr.history]
    np.testing.assert_allclose([m.loss for m in got], want, rtol=1e-4)
    # the masks matter: without them the port samples its own rows
    own = GNNTrainer(_models(pg)[0], pg, SylvieConfig(**cfg),
                     policy=pol(tpol) if pol else None, runtime=CPU,
                     params=jax.tree.map(np.asarray, JTrainer(
                         _models(pg)[1], jpg, JConfig(**cfg)).state.params))
    assert own.fit(2)[-1].loss != pytest.approx(want[1], rel=1e-4)


def test_resume_across_packages_both_ways(graphs, tmp_path):
    """Sylvie-A under BoundedStaleness(4): epoch 3 is pipelined (it needs
    the checkpointed halo caches), epoch 4 synchronous."""
    tr, jtr = _trainers(graphs, "sylvie_a", ckpt_dir=str(tmp_path / "j"),
                        ckpt_every=3)
    jtr.fit(3)                                   # JAX saves at epoch 3
    tr.ckpt_dir, tr.ckpt_every = str(tmp_path / "t"), 3
    tr.fit(3)                                    # the port saves at epoch 3
    full_j = [m.loss for m in jtr.fit(2)[-2:]]
    full_t = [m.loss for m in tr.fit(2)[-2:]]

    t2, j2 = _trainers(graphs, "sylvie_a")
    t2.ckpt_dir, j2.ckpt_dir = str(tmp_path / "j"), str(tmp_path / "t")
    assert t2.resume() and j2.resume() and t2.epoch == j2.epoch == 3
    got_t = t2.fit(2)
    got_j = [m.loss for m in j2.fit(2)]
    assert [m.mode for m in got_t] == ["async", "sync"]
    np.testing.assert_allclose([m.loss for m in got_t], full_j, rtol=1e-4)
    np.testing.assert_allclose(got_j, full_t, rtol=1e-4)


def test_elastic_resume_forces_a_sync_epoch(graphs, tmp_path):
    """A 4-part JAX checkpoint resumed by the port at 2 parts: the halo
    caches no longer fit, come back as zeros, and the next epoch is
    synchronous although the policy would pipeline it."""
    _, jtr = _trainers(graphs, "sylvie_a", ckpt_dir=str(tmp_path),
                       ckpt_every=3)
    jtr.fit(3)
    pg2, _ = datasets.load_partitioned(REF, n_parts=2,
                                       cache_dir=tmp_path / "plans")
    tr = GNNTrainer(_models(pg2)[0], pg2, SylvieConfig(mode="async", bits=1),
                    policy=tpol.BoundedStaleness(eps_s=4),
                    runtime=Runtime.simulated(2, device="cpu"),
                    ckpt_dir=str(tmp_path))
    assert tr.resume() and tr.epoch == 3 and tr._needs_sync
    assert all(float(f.abs().sum()) == 0 for f in tr.state.halo.feats)
    for a, b in zip(topt.tree_leaves(tr.state.params),
                    jax.tree.leaves(jtr.state.params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ms = tr.fit(2)
    assert [m.mode for m in ms] == ["sync", "sync"]      # epoch 4: eps_s
    assert all(np.isfinite(m.loss) for m in ms)


def test_training_runs_each_kernel_as_documented(graphs, monkeypatch):
    """Per step, on the CPU, the kernels' plain versions run as often as the
    kernels launch on the card (``chip_smoke.py`` holds the card to the same
    figures): sync 3 quantize / 3 dequantize / 4 SpMM (2 forward, 1
    transposed, 1 scatter; site 0 exchanges no gradient), async 4 / 4 / 5
    (the fresh exchanges, and the gslot gradients at both sites, so layer 0's
    table needs the transposed SpMM too; one scatter). Nothing on the path
    adds with ``index_add_``, ``scatter_add_`` or ``torch.sparse.mm``."""
    tr, _ = _trainers(graphs, "sylvie_a")
    counts = {}
    for mod, name in ((qref, "quantize_pack_ref"),
                      (qref, "unpack_dequantize_ref"), (sref, "spmm_ref")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name):
            counts[_name] = counts.get(_name, 0) + 1
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
    for _ in range(3):                    # epochs 0 (sync), 1, 2 (async)
        counts.clear()
        m = tr.train_epoch()
        seen.append((m.mode, counts["quantize_pack_ref"],
                     counts["unpack_dequantize_ref"], counts["spmm_ref"]))
    assert seen == [("sync", 3, 3, 4), ("async", 4, 4, 5),
                    ("async", 4, 4, 5)]


def test_overlap_schedule_is_not_ported(graphs):
    """The overlap schedule, which this test once found refused, is ported
    (``dist/overlap.py``): the trainer runs it, with the same losses as the
    blocking schedule bit for bit (``tests/test_torch_overlap.py`` holds it
    to blocking and to JAX in full)."""
    pg, _ = graphs
    cfg, pol, _ = CONFIGS["sylvie_a"]
    params = jax.tree.map(np.asarray, _models(pg)[1].init(
        jax.random.PRNGKey(0)))
    losses = {}
    for sched in ("overlap", "blocking"):
        tr = GNNTrainer(_models(pg)[0], pg,
                        SylvieConfig(**cfg, schedule=sched),
                        policy=pol(tpol), runtime=CPU, params=params)
        ms = tr.fit(2)
        assert [m.schedule for m in ms] == [sched] * 2
        losses[sched] = [m.loss for m in ms]
    assert losses["overlap"] == losses["blocking"]


def test_entry_points_need_a_card_unless_asked_for_the_cpu(
        graphs, monkeypatch, capsys, tmp_path):
    pg, _ = graphs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GNNTrainer(_models(pg)[0], pg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.train(_models(pg)[0], pg, mode="sync")
    argv = ["--arch", "gcn", "--reduced", "--graph", "yelp_like@smoke",
            "--mode", "async", "--eps-s", "2", "--epochs", "3",
            "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(argv)
    launch.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert sum(ln.startswith("epoch ") for ln in lines) == 3
    assert "[async]" in out and "test acc" in out
    assert ckpt.latest_step(tmp_path) == 3
    for bad in (["--arch", "pna"], ["--arch", "schnet"]):
        with pytest.raises(SystemExit, match="not ported yet"):
            launch.main(bad)
    # the overlap schedule trains (it was refused before it was ported)
    launch.main(["--arch", "gcn", "--reduced", "--graph", "yelp_like@smoke",
                 "--schedule", "overlap", "--epochs", "2", "--log-every",
                 "1", "--device", "cpu"])
    assert "test acc" in capsys.readouterr().out
    for arch in ("graphsage", "gat"):
        argv = ["--arch", arch, "--reduced", "--graph", "yelp_like@smoke",
                "--mode", "async", "--eps-s", "2", "--epochs", "2",
                "--log-every", "1"]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.main(argv)
        launch.main(argv + ["--device", "cpu"])
        out = capsys.readouterr().out
        assert "[sync]" in out and "[async]" in out and "test acc" in out
    small = api.partition(datasets.load("yelp_like@smoke"), 4)
    tr = api.train(_models(small)[0], small, mode="vanilla", epochs=2,
                   device="cpu")
    assert len(tr.history) == 2 and tr.device == torch.device("cpu")
    assert dataclasses.asdict(tr.cfg)["mode"] == "vanilla"
