"""The port's fan-out sampler and sampled training against the JAX reference,
on the CPU.

* ``Graph.n_edges``, ``degrees`` and ``to_csr`` return the reference's
  arrays (int64 ``indptr``, int32 ``indices``, edge-list order within a
  node); ``SamplerShapes`` equals the reference's at (1024, (15, 10)) and
  (16, (5, 3)).
* Over hypothesis' seeds 0-20 and batches 4-32 on ``powerlaw(300,
  avg_degree=10)`` (the graph of ``tests/test_graph.py``'s sampler test),
  ``NeighborSampler(g, (5, 3), seed).sample(...)`` returns the reference's
  subgraph array for array, twice in a row (the generator's draws stay in
  step), and the reference's invariants hold for it: at most
  ``max_nodes`` nodes and ``max_edges`` edges, edge ids in range, every
  sampled edge an edge of the graph, the seeds (at most the batch) marked.
* Sampled training: ``chip_smoke.sampled_train`` (the loop ``[sampled]``
  runs on the card) at ``device="cpu"``: 3 batches of 16 seeds at fan-outs
  (5, 3), GraphSAGE 16 -> 32 x 2, P = 2, Adam 1e-2, on a seeded
  ``powerlaw_community`` graph, against the same loop written with
  ``repro``'s functions (the reference's Table-1 loop: sample, self-loops,
  ``partition_graph``, ``build_block``, the jitted sync step, the
  parameters and the optimizer's state carried, ``HaloState.zeros`` for each
  plan), from the same initial weights (``convert.params_from_numpy``):
  vanilla losses within rtol 1e-5 and parameters within 1e-5, Sylvie-S at
  1 bit with deterministic rounding losses within 1e-4.
* Per step the kernels' plain versions run as often as
  ``chip_smoke.TRAIN_LAUNCHES[("graphsage", run, "sync")]`` holds the card
  to; the loop refuses Sylvie-A; each batch's host work reports its parts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.staleness import HaloState as JHalo
from repro.core.sylvie import SylvieConfig as JConfig
from repro.graph import formats as jformats
from repro.graph import partition as jpartition
from repro.graph import sampling as jsampling
from repro.graph import synthetic as jsynthetic
from repro.models.gnn import blocks as JB
from repro.models.gnn.models import GraphSAGE as JSAGE
from repro.train import gnn_step as jstep
from repro.train import optimizer as jopt
from repro_torch.core.sylvie import SylvieConfig
from repro_torch.graph import formats, sampling, synthetic
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.gnn.models import GraphSAGE
from repro_torch.train import optimizer as topt

BATCH, FANOUTS, PARTS, N_BATCHES, LR = 16, (5, 3), 2, 3, 1e-2
GRAPH = dict(n_nodes=600, n_classes=4, d_feat=16, avg_degree=12, p_in=0.85,
             gamma=0.8, seed=3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graphs_equal(a, b):
    assert a.n_nodes == b.n_nodes and a.n_classes == b.n_classes
    for f in ("edge_index", "x", "y", "train_mask", "val_mask", "test_mask",
              "pos", "edge_attr"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_and_degrees_equal_the_references(seed):
    jg = jsynthetic.powerlaw(n_nodes=300, avg_degree=10, seed=seed)
    g = synthetic.powerlaw(n_nodes=300, avg_degree=10, seed=seed)
    _graphs_equal(g, jg)
    assert g.n_edges == jg.n_edges
    for kind in ("in", "out"):
        a, b = g.degrees(kind), jg.degrees(kind)
        assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b)
    (ip, ix), (jp, jx) = g.to_csr(), jg.to_csr()
    assert ip.dtype == jp.dtype == np.int64 and np.array_equal(ip, jp)
    assert ix.dtype == jx.dtype == np.int32 and np.array_equal(ix, jx)
    # stable: a node's destinations keep their edge-list order
    src, dst = g.edge_index
    for v in (0, 7, 299):
        assert np.array_equal(ix[ip[v]:ip[v + 1]], dst[src == v])


@pytest.mark.parametrize("batch,fanouts", [(1024, (15, 10)), (16, (5, 3))])
def test_sampler_shapes_equal_the_references(batch, fanouts):
    a = sampling.SamplerShapes(batch, fanouts)
    b = jsampling.SamplerShapes(batch, fanouts)
    assert (a.max_nodes, a.max_edges) == (b.max_nodes, b.max_edges)
    if batch == 1024:
        assert (a.max_nodes, a.max_edges) == (169_984, 168_960)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 20), batch=st.integers(4, 32))
def test_sampler_returns_the_references_subgraphs(seed, batch):
    g = synthetic.powerlaw(n_nodes=300, avg_degree=10, seed=seed)
    jg = jsynthetic.powerlaw(n_nodes=300, avg_degree=10, seed=seed)
    s = sampling.NeighborSampler(g, fanouts=(5, 3), seed=seed)
    js = jsampling.NeighborSampler(jg, fanouts=(5, 3), seed=seed)
    shapes = sampling.SamplerShapes(batch, (5, 3))
    edges = set(map(tuple, g.edge_index.T.tolist()))
    for _ in range(2):
        sub, jsub = s.sample(batch_nodes=batch), js.sample(batch_nodes=batch)
        _graphs_equal(sub, jsub)
        assert sub.n_nodes <= shapes.max_nodes
        assert sub.n_edges <= shapes.max_edges
        assert sub.edge_index.min() >= 0
        assert sub.edge_index.max() < sub.n_nodes
        assert 0 < sub.train_mask.sum() <= batch
        # every sampled edge is an edge of the graph, relabelled back
        ids = _sampled_ids(g, sub)
        assert np.all(np.diff(ids) > 0)          # relabelling keeps order
        assert all((int(ids[u]), int(ids[v])) in edges
                   for u, v in sub.edge_index.T)


def _sampled_ids(g, sub):
    """The global ids of a subgraph's nodes, found through their features
    (the powerlaw graph's rows are distinct Gaussians)."""
    rows = {r.tobytes(): i for i, r in enumerate(g.x)}
    return np.array([rows[r.tobytes()] for r in sub.x])


def test_seeds_given_are_the_references():
    g = synthetic.powerlaw(n_nodes=300, avg_degree=10, seed=4)
    jg = jsynthetic.powerlaw(n_nodes=300, avg_degree=10, seed=4)
    seeds = np.array([5, 9, 9, 250])
    sub = sampling.NeighborSampler(g, (4, 2), seed=1).sample(seeds)
    _graphs_equal(sub, jsampling.NeighborSampler(jg, (4, 2), seed=1)
                  .sample(seeds))
    assert sub.train_mask.sum() == 3          # the repeated seed once


def _jax_loop(jg, cfg: JConfig, n_batches: int):
    """The reference's Table-1 loop at this file's shape, on the simulated
    stack: sample, self-loops, partition, block, the jitted sync step (one
    compile a batch), the parameters and Adam's state carried and the halo
    caches zeroed for each plan. Returns (losses, final params, initial
    params)."""
    key = jax.random.PRNGKey(0)
    model = JSAGE(jg.x.shape[1], 32, jg.n_classes, n_layers=2)
    o = jopt.adam(LR)
    sampler = jsampling.NeighborSampler(jg, fanouts=FANOUTS, seed=0)
    ts, _, _ = jstep.make_gnn_steps(model, cfg, o)
    state, losses = None, []
    for b in range(n_batches):
        sub = sampler.sample(batch_nodes=BATCH)
        ei = jformats.add_self_loops(sub.edge_index, sub.n_nodes)
        sub2 = jformats.Graph(sub.n_nodes, ei, sub.x, sub.y, sub.train_mask,
                              sub.val_mask, sub.test_mask,
                              n_classes=jg.n_classes)
        pg = jpartition.partition_graph(sub2, PARTS)
        block = JB.build_block(pg)
        if state is None:
            state = jstep.GNNTrainState.create(model, o, key, block.plan)
            init = jax.tree.map(np.asarray, state.params)
        else:
            state = dataclasses.replace(state, halo=JHalo.zeros(
                block.plan, model.comm_dims()))
        state, loss = jax.jit(ts)(state, block, jnp.asarray(pg.x),
                                  jnp.asarray(pg.y),
                                  jnp.asarray(pg.train_mask),
                                  jax.random.fold_in(key, b))
        losses.append(float(loss))
    return losses, [np.asarray(p) for p in jax.tree.leaves(state.params)], \
        init


@pytest.fixture(scope="module")
def graphs():
    jg = jsynthetic.powerlaw_community(**GRAPH)
    g = synthetic.powerlaw_community(**GRAPH)
    _graphs_equal(g, jg)
    return g, jg


def _port_loop(g, cfg: SylvieConfig, init, n_batches=N_BATCHES):
    import chip_smoke as cs
    model = params_from_numpy(GraphSAGE(g.x.shape[1], 32, g.n_classes),
                              init)
    return cs.sampled_train(sampling.NeighborSampler(g, FANOUTS, seed=0),
                            model, cfg, topt.adam(LR), n_batches,
                            batch_nodes=BATCH, parts=PARTS, seed=0,
                            device="cpu")


@pytest.mark.parametrize("run", ["vanilla", "sylvie_s"])
def test_sampled_training_matches_the_references_loop(graphs, run):
    g, jg = graphs
    kw = dict(mode="vanilla") if run == "vanilla" else \
        dict(mode="sync", bits=1, stochastic=False)
    jlosses, jparams, init = _jax_loop(jg, JConfig(**kw), N_BATCHES)
    out = _port_loop(g, SylvieConfig(**kw), init)
    rtol = 1e-5 if run == "vanilla" else 1e-4
    np.testing.assert_allclose(out["losses"], jlosses, rtol=rtol)
    assert len(out["losses"]) == N_BATCHES and np.all(np.isfinite(jlosses))
    if run == "vanilla":
        for a, b in zip(out["params"], jparams):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
    shapes = sampling.SamplerShapes(BATCH, FANOUTS)
    for info in out["info"]:
        assert info["nodes"] <= shapes.max_nodes
        assert info["edges"] <= shapes.max_edges
        assert info["block_edges"] == info["edges"] + info["nodes"]
        assert min(info[k] for k in ("sample_ms", "partition_ms",
                                     "block_ms")) >= 0
        assert info["halo_rows"] >= info["real_halo_rows"] > 0
    assert len(out["wait_ms"]) == len(out["step_ms"]) == N_BATCHES
    assert out["device_ms"] == [] and out["launches"] == []


@pytest.mark.parametrize("run", ["vanilla", "sylvie_s"])
def test_each_step_runs_the_plain_versions_as_the_card_launches(
        graphs, run, monkeypatch):
    import chip_smoke as cs
    from repro_torch.kernels.quant import ref as qref
    from repro_torch.kernels.spmm import ref as sref

    counts = [0, 0, 0]
    for i, (mod, fn) in enumerate(((qref, "quantize_pack_ref"),
                                   (qref, "unpack_dequantize_ref"),
                                   (sref, "spmm_ref"))):
        real = getattr(mod, fn)

        def counted(*a, _real=real, _i=i):
            counts[_i] += 1
            return _real(*a)
        monkeypatch.setattr(mod, fn, counted)
    g, _ = graphs
    cfg = SylvieConfig(mode="vanilla") if run == "vanilla" else \
        SylvieConfig(mode="sync", bits=1)
    model = GraphSAGE(g.x.shape[1], 32, g.n_classes,
                      generator=torch.Generator().manual_seed(0))
    out = cs.sampled_train(sampling.NeighborSampler(g, FANOUTS, seed=0),
                           model, cfg, topt.adam(LR), 2, batch_nodes=BATCH,
                           parts=PARTS, device="cpu",
                           launches=lambda: tuple(counts) + (0,) * 4)
    want = cs.TRAIN_LAUNCHES[("graphsage", run, "sync")]
    assert out["launches"] == [want, want]
    assert all(np.isfinite(out["losses"]))


def test_the_loop_refuses_sylvie_a(graphs):
    import chip_smoke as cs
    g, _ = graphs
    model = GraphSAGE(g.x.shape[1], 32, g.n_classes)
    with pytest.raises(ValueError, match="one plan"):
        cs.sampled_train(sampling.NeighborSampler(g, FANOUTS, seed=0),
                         model, SylvieConfig(mode="async", bits=1),
                         topt.adam(LR), 1, batch_nodes=BATCH, parts=PARTS,
                         device="cpu")


def test_the_phase_dry_runs_on_the_cpu():
    """``chip_smoke.sampled_phase`` at a small size on the CPU: its gates
    (bounds, finite losses, vanilla's descent) pass and it reports each
    part of the host work."""
    import chip_smoke as cs
    out = cs.sampled_phase(cs.kernel_table(), device="cpu",
                           graph=dict(n_nodes=3000, avg_degree=12, d_feat=24,
                                      n_classes=4, p_in=0.85, gamma=0.8),
                           n_batches=8, batch_nodes=32, fanouts=(5, 3))
    for run in ("vanilla", "sylvie_s"):
        r = out[run]
        assert r["n_batches"] == 8 and len(r["losses"]) == 8
        assert set(r["host_ms"]) == {"sample", "partition", "block"}
        assert r["step_device_ms"] is None and r["gflop_per_step"] > 0
