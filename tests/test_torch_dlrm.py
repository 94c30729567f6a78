"""DLRM of the port against the JAX reference, one process, on the CPU.

* ``configs.get("dlrm-mlperf")``: ``config()`` and ``reduced()`` equal the
  reference's field for field, with ``row_offsets``, ``interaction_dim``
  and ``param_count()``; the two registries hold the same ids.
* ``criteo_stream`` array-equal to the reference's (reduced and full
  config, 2 seeds).
* ``dlrm_forward`` from the JAX weights carried across
  (``dlrm_params_from_numpy``): the reduced config at batch 16 and the
  published widths with 26 tables of 64 rows at batch 8, rtol 1e-5.
* The reference's ``test_dlrm_arch_smoke`` program: 5 Adam 1e-2 steps
  (losses 1e-5, dense leaves and table 1e-4, the loss falls), the serve
  step's CTR (1e-6) and the retrieval step's top 8 (values 1e-5, ids
  equal).
* The table's gradient from ``torch.autograd.grad`` against ``jax.grad``'s
  on a reduced stream batch whose ids repeat: within 1e-6 of the largest,
  and bit for bit the position-order sums of the SpMM's plan (the
  reference's scatter-add order differs on rows read more than 128 times);
  the id plan itself against an explicit loop.
* ``_dlrm_model_flops`` for the four ``RECSYS_SHAPES``; the converter's
  refusals; the launcher; the plain versions' calls per step
  (``chip_smoke.DLRM_LAUNCHES``) and no atomic or library scatter on the
  path.

The four-rank runs are in ``tests/test_torch_sharded_dlrm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import criteo_stream as jax_criteo_stream
from repro.launch import cells as jcells
from repro.models.recsys import dlrm as JD
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.data import Prefetcher, criteo_stream
from repro_torch.kernels.quant import ref as qref
from repro_torch.kernels.spmm import ref as sref
from repro_torch.launch import cells
from repro_torch.launch import train as launch
from repro_torch.models.convert import (dlrm_params_from_numpy,
                                        dlrm_params_to_numpy)
from repro_torch.models.recsys import dlrm as D
from repro_torch.train import optimizer as topt

KEY = jax.random.PRNGKey(0)


def _cfgs(which: str, rows: int | None = None):
    """(port config, reference config) of ``which``; ``rows`` gives every
    table that many rows."""
    mine = getattr(configs.get("dlrm-mlperf"), which)()
    ref = getattr(jconfigs.get("dlrm-mlperf"), which)()
    if rows is not None:
        sizes = (rows,) * mine.n_sparse
        mine = dataclasses.replace(mine, table_sizes=sizes)
        ref = dataclasses.replace(ref, table_sizes=sizes)
    return mine, ref


def _weights(jcfg):
    """The reference's initial weights, as numpy and as the port's."""
    dp = JD.init_dense_params(KEY, jcfg)
    tb = JD.init_table(jax.random.fold_in(KEY, 1), jcfg)
    return (dp, tb), dlrm_params_from_numpy(jax.tree.map(np.asarray, dp),
                                            np.asarray(tb))


def _batch(cfg, b: int, seed: int = 0):
    """The reference test's batch: uniform ids per field, normal dense
    features, random labels."""
    rng = np.random.default_rng(seed)
    offs = cfg.row_offsets
    ids = np.concatenate([rng.integers(offs[f], offs[f + 1], (b, h))
                          for f, h in enumerate(cfg.hots)],
                         axis=1).reshape(-1).astype(np.int32)
    dx = rng.normal(0, 1, (b, cfg.n_dense)).astype(np.float32)
    lb = rng.integers(0, 2, b).astype(np.float32)
    return dx, ids, lb


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def test_config_equals_the_reference_field_for_field():
    assert sorted(configs.REGISTRY) == sorted(jconfigs.REGISTRY)
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    spec, jspec = configs.get("dlrm-mlperf"), jconfigs.get("dlrm-mlperf")
    assert (spec.kind, spec.source, spec.notes) == \
        (jspec.kind, jspec.source, jspec.notes)
    assert [dataclasses.asdict(c) for c in spec.shapes] == \
        [dataclasses.asdict(c) for c in jspec.shapes]
    for which in ("config", "reduced"):
        mine, ref = _cfgs(which)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        for prop in ("n_sparse", "hots", "total_ids_per_sample",
                     "total_rows", "interaction_dim"):
            assert getattr(mine, prop) == getattr(ref, prop)
        np.testing.assert_array_equal(mine.row_offsets, ref.row_offsets)
        assert mine.param_count() == ref.param_count()
        for n_dev in (1, 4, 8):
            assert D.rows_per_device(mine, n_dev) == \
                JD.rows_per_device(ref, n_dev)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("nosuch")


def test_capped_config_keeps_every_width():
    full = configs.get("dlrm-mlperf").config()
    cut = D.capped(full, 2 ** 22)
    assert cut.total_rows == 25_035_512
    assert sum(s > 2 ** 22 for s in full.table_sizes) == 5
    assert dataclasses.replace(cut, table_sizes=full.table_sizes) == full
    assert D.capped(full, None) is full


@pytest.mark.parametrize("which", ("reduced", "config"))
@pytest.mark.parametrize("seed", (0, 3))
def test_criteo_stream_equals_the_reference(which, seed):
    mine, ref = _cfgs(which)
    got = list(criteo_stream(mine, 8, seed, n_batches=2))
    want = list(jax_criteo_stream(ref, 8, seed, n_batches=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which,rows,b", (("reduced", None, 16),
                                          ("config", 64, 8)))
def test_forward_equals_the_reference(which, rows, b):
    cfg, jcfg = _cfgs(which, rows)
    (dp, tb), (tdp, ttb) = _weights(jcfg)
    dx, ids, _ = _batch(cfg, b)
    want = JD.dlrm_forward(dp, tb, jnp.asarray(dx), jnp.asarray(ids), jcfg)
    got = D.dlrm_forward(tdp, ttb, *_t(dx, ids), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    bot = JD.mlp(dp["bot"], jnp.asarray(dx))
    emb = JD.bag_reduce(jnp.take(tb, jnp.asarray(ids), axis=0), jcfg, b)
    np.testing.assert_allclose(
        D.dot_interaction(torch.tensor(np.asarray(bot)),
                          torch.tensor(np.asarray(emb))).numpy(),
        np.asarray(JD.dot_interaction(bot, emb)), rtol=1e-5, atol=1e-6)


def test_arch_smoke_program_equals_the_reference():
    """``tests/test_arch_smoke.py::test_dlrm_arch_smoke`` in both
    packages from the same weights."""
    cfg, jcfg = _cfgs("reduced")
    (dp, tb), (tdp, ttb) = _weights(jcfg)
    dx, ids, lb = _batch(cfg, 16)
    o, to = jopt.adam(1e-2), topt.adam(1e-2)
    step = jax.jit(JD.make_train_step(jcfg, o, None))
    tstep = D.make_train_step(cfg, to)
    st = (dp, tb, o.init(dp), o.init(tb), jnp.zeros((), jnp.int32))
    tst = (tdp, ttb, to.init(tdp), to.init(ttb),
           torch.zeros((), dtype=torch.int32))
    losses, tlosses = [], []
    for i in range(5):
        st, loss = step(st, jnp.asarray(dx), jnp.asarray(ids),
                        jnp.asarray(lb), jax.random.fold_in(KEY, i))
        tst, tloss = tstep(tst, *_t(dx, ids, lb),
                           D.step_generator(0, i))
        losses.append(float(loss))
        tlosses.append(float(tloss))
    np.testing.assert_allclose(tlosses, losses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    assert int(tst[4]) == 5 and int(tst[2]["t"]) == int(tst[3]["t"]) == 5
    dense, table = dlrm_params_to_numpy(tst[0], tst[1])
    for a, b in zip(jax.tree.leaves(dense), jax.tree.leaves(st[0])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(table, np.asarray(st[1]), rtol=1e-4,
                               atol=1e-4)

    ctr = D.make_serve_step(cfg)(tst[0], tst[1], *_t(dx, ids))
    want = jax.jit(JD.make_serve_step(jcfg, None))(st[0], st[1],
                                                   jnp.asarray(dx),
                                                   jnp.asarray(ids))
    assert ctr.shape == (16,) and bool(((ctr >= 0) & (ctr <= 1)).all())
    np.testing.assert_allclose(ctr.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)

    rng = np.random.default_rng(0)
    cand = rng.permutation(int(cfg.table_sizes[0]))[:32].astype(np.int32)
    q = ids[:cfg.total_ids_per_sample]
    v, got = D.make_retrieval_step(cfg, None, top_k=8)(
        tst[0], tst[1], *_t(dx[:1], q, cand))
    jv, jids = jax.jit(JD.make_retrieval_step(jcfg, None, top_k=8))(
        st[0], st[1], jnp.asarray(dx[:1]), jnp.asarray(q), jnp.asarray(cand))
    assert v.shape == (8,) and bool((v[1:] <= v[:-1]).all())
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jids))


def _explicit_rows(g: np.ndarray, ids: np.ndarray) -> dict:
    """{row: sum of g over the positions that read it}: in position order,
    a row read more than ``SEGMENT`` times summed in segments and the
    segments' sums added left to right (the SpMM's order), float32."""
    out = {}
    for row in np.unique(ids):
        pos = np.flatnonzero(ids == row)
        parts = []
        for k in range(0, pos.size, sref.SEGMENT):
            acc = np.zeros(g.shape[1], np.float32)
            for p in pos[k:k + sref.SEGMENT]:
                acc = acc + g[p]
            parts.append(acc)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        out[int(row)] = acc
    return out


def test_id_plan_is_the_transposed_id_csr():
    ids = np.array([5, 2, 5, 9, 2, 5, 0, 9], np.int32)
    plan = D.id_plan(ids)
    assert plan.rows.tolist() == [0, 2, 5, 9]
    assert plan.csr.row_ptr.tolist() == [0, 1, 3, 6, 8]
    assert plan.csr.col.tolist() == [6, 1, 4, 0, 2, 5, 3, 7]
    assert plan.csr.n_cols == 8 and plan.csr.w.tolist() == [1.0] * 8
    # rows [4, 9) of the table only: positions of ids 5 and 9, rows - 4
    part = D.id_plan(ids, lo=4, n_rows=5)
    assert part.rows.tolist() == [1] and part.csr.col.tolist() == [0, 2, 5]
    assert part.csr.n_cols == 8
    hub = D.id_plan(np.zeros(300, np.int32))
    assert hub.csr.long_rows.tolist() == [0] and hub.csr.n_partials == 3


def test_table_gradient_equals_jax_grad():
    cfg, jcfg = _cfgs("reduced")
    (dp, tb), (tdp, ttb) = _weights(jcfg)
    dx, ids, lb = next(criteo_stream(cfg, 512, 0))
    assert np.bincount(ids).max() > sref.SEGMENT      # hub rows split

    def jloss(tb_):
        return JD.bce_loss(JD.dlrm_forward(dp, tb_, jnp.asarray(dx),
                                           jnp.asarray(ids), jcfg),
                           jnp.asarray(lb))
    want = np.asarray(jax.grad(jloss)(tb))
    loss, _, gt = D.loss_and_grads(tdp, ttb, *_t(dx, ids, lb), cfg,
                                   plan=D.id_plan(ids))
    np.testing.assert_allclose(float(loss), float(jloss(tb)), rtol=1e-6)
    top = np.abs(want).max()
    assert np.abs(gt.numpy() - want).max() <= 1e-6 * top
    untouched = np.setdiff1d(np.arange(cfg.total_rows), ids)
    assert not gt[untouched].any()
    # bit for bit the SpMM's order over the cotangent of the gathered rows
    rows = torch.from_numpy(np.asarray(ttb)[ids]).requires_grad_(True)
    emb = D.bag_reduce(rows, cfg, dx.shape[0])
    bot = D.mlp(tdp["bot"], torch.from_numpy(dx))
    logits = D.mlp(tdp["top"], D.dot_interaction(bot, emb))[:, 0]
    (g,) = torch.autograd.grad(D.bce_loss(logits, torch.from_numpy(lb)),
                               rows)
    for row, acc in _explicit_rows(g.numpy(), ids).items():
        assert np.array_equal(gt[row].numpy(), acc)


def test_model_flops_equal_the_reference():
    cfg, jcfg = _cfgs("config")
    for cell in jconfigs.get("dlrm-mlperf").shapes:
        assert cells._dlrm_model_flops(cfg, cell) == \
            jcells._dlrm_model_flops(jcfg, cell)
    # a training step at batch 65,536: 4.917 MFLOP a sample forward,
    # 966.7 GFLOP a step
    train = configs.get("dlrm-mlperf").shape("train_batch")
    assert cells._dlrm_model_flops(cfg, train) == 966_719_963_136


def test_params_from_numpy_checks_every_key_and_shape():
    cfg, jcfg = _cfgs("reduced")
    dense = jax.tree.map(np.asarray, JD.init_dense_params(KEY, jcfg))
    table = np.asarray(JD.init_table(KEY, jcfg))
    tdp, ttb = dlrm_params_from_numpy(dense, table)
    back, tback = dlrm_params_to_numpy(tdp, ttb)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(dense)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tback, table)
    missing = jax.tree.map(lambda a: a, dense)      # new dicts, same leaves
    del missing["top"]["l1"]["b"]
    with pytest.raises(KeyError, match="top/l1/b"):
        dlrm_params_from_numpy(missing, table)
    with pytest.raises(KeyError, match="'top'"):
        dlrm_params_from_numpy({"bot": dense["bot"]}, table)
    extra = {**dense, "mid": dense["bot"]}
    with pytest.raises(KeyError, match="mid"):
        dlrm_params_from_numpy(extra, table)
    wrong = jax.tree.map(lambda a: a, dense)
    wrong["bot"]["l1"]["w"] = np.zeros((31, 16), np.float32)
    with pytest.raises(ValueError, match="bot/l1/w"):
        dlrm_params_from_numpy(wrong, table)
    with pytest.raises(ValueError, match="table"):
        dlrm_params_from_numpy(dense, table[:, :8])
    wrong = jax.tree.map(lambda a: a, dense)
    wrong["top"]["l0"]["w"] = np.zeros((36, 64), np.float32)
    with pytest.raises(ValueError, match="top MLP"):
        dlrm_params_from_numpy(wrong, table)


def test_entry_point_trains_and_needs_a_card_unless_asked(monkeypatch,
                                                          capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "dlrm-mlperf", "--reduced", "--steps", "3",
            "--log-every", "1"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(argv)
    launch.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines[:3]] == [["step", str(i)]
                                                    for i in (1, 2, 3)]
    assert lines[3].startswith("final loss ") and len(lines) == 4
    assert lines[3].split()[-1] == lines[2].split()[-1]
    # --serve does not change what a recsys arch does: it trains
    launch.main(argv + ["--device", "cpu", "--serve"])
    assert capsys.readouterr().out.splitlines() == lines
    with pytest.raises(KeyError, match="unknown arch"):
        launch.main(["--arch", "nosuch", "--device", "cpu"])


def test_prefetcher_moves_the_id_plan():
    cfg, _ = _cfgs("reduced")
    out = list(Prefetcher(D.with_plans(criteo_stream(cfg, 4, 0,
                                                     n_batches=2)),
                          device="cpu"))
    assert len(out) == 2
    for dense, ids, label, plan in out:
        assert isinstance(plan, D.IdPlan) and torch.is_tensor(ids)
        want = D.id_plan(ids.numpy())
        assert torch.equal(plan.rows, want.rows)
        assert torch.equal(plan.csr.col, want.csr.col)


def test_paths_run_each_kernel_as_documented(monkeypatch):
    """Per step, on the CPU, the kernels' plain versions run as often as
    ``chip_smoke.DLRM_LAUNCHES`` holds the card to; nothing on the path
    adds with ``index_add_``, ``scatter_add_``, ``scatter_reduce`` or
    ``torch.sparse.mm``."""
    import chip_smoke

    counts = [0, 0, 0]
    for i, (mod, fn) in enumerate(((qref, "quantize_pack_ref"),
                                   (qref, "unpack_dequantize_ref"),
                                   (sref, "spmm_ref"))):
        real = getattr(mod, fn)

        def counted(*a, _real=real, _i=i, **k):
            counts[_i] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, fn, counted)

    def refuse(*a, **k):
        raise AssertionError("an atomic or library scatter on the path")
    for owner, fn in ((torch.Tensor, "index_add_"), (torch.Tensor,
                                                     "scatter_add_"),
                      (torch.Tensor, "scatter_reduce"),
                      (torch.Tensor, "scatter_reduce_"),
                      (torch, "scatter_reduce"), (torch, "index_add"),
                      (torch, "scatter_add"), (torch.sparse, "mm")):
        monkeypatch.setattr(owner, fn, refuse)
    cfg, jcfg = _cfgs("config", 64)
    _, (tdp, ttb) = _weights(jcfg)
    opt = topt.adam(1e-3)
    state = (tdp, ttb, opt.init(tdp), opt.init(ttb),
             torch.zeros((), dtype=torch.int32))
    step = D.make_train_step(cfg, opt)
    seen = {}
    for i, (dx, ids, lb) in enumerate(criteo_stream(cfg, 8, 0,
                                                    n_batches=2)):
        counts[:] = [0, 0, 0]
        state, _ = step(state, *_t(dx, ids, lb),
                        plan=D.id_plan(ids) if i else None)
        seen[("train", None, i)] = tuple(counts)
    counts[:] = [0, 0, 0]
    D.make_serve_step(cfg)(state[0], state[1], *_t(dx, ids))
    seen[("serve", None)] = tuple(counts)
    counts[:] = [0, 0, 0]
    D.make_retrieval_step(cfg, None, top_k=4)(
        state[0], state[1], *_t(dx[:1], ids[:cfg.n_sparse],
                                np.arange(16, dtype=np.int32)))
    seen[("retrieval", None)] = tuple(counts)
    want = chip_smoke.DLRM_LAUNCHES
    assert seen == {("train", None, 0): want[("train", None)],
                    ("train", None, 1): want[("train", None)],
                    ("serve", None): want[("serve", None)],
                    ("retrieval", None): want[("retrieval", None)]}
