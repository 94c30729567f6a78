"""Sylvie-A's gradient slots are wired only where the exchanged ``h`` needs
a gradient, on the CPU.

* Bit-equality with the fully wired path: GCN and GraphSAGE trained for six
  Sylvie-A epochs (epoch 0 sync, 1-3 async, 4 the Bounded Staleness
  refresh, 5 async; stochastic 1 bit) on the blocking and overlap schedules
  and fault-armed, once with ``x`` as given (site 0, whose ``h`` is ``x``,
  gets no slot) and once with ``x.requires_grad_()`` (site 0 wired, as every
  site once was). Every loss and parameter is equal bit for bit; site 0's
  gradient cache stays exactly zero where it is not wired.
* Where the mechanism engages: under the fake host and device clocks of
  ``tests/test_torch_obs_device.py``, a GraphSAGE async step has no site-0
  backward ``halo`` span and no backward ``agg`` span at the input's width,
  and counts one ``halo.gslot_skipped`` and one ``halo.gslot_wired``; with
  ``x.requires_grad_()`` both spans are there and every site is wired, and
  so is every site of GAT, whose site 0 ships ``hw = x @ w`` (its attention
  aggregation opens no ``agg`` span: the site-0 backward ``halo`` span
  shows it).
* Every other model keeps every slot: one async step of PNA, MeshGraphNet,
  SchNet and NequIP (reduced, on the zoo's smoke graphs) and of GAT wires
  each site and skips none; GCN and GraphSAGE skip site 0 alone.
"""
import pytest
import torch

from repro_torch import configs, datasets, obs
from repro_torch.core.sylvie import SylvieConfig
from repro_torch.dist.runtime import Runtime
from repro_torch.faults import plan as tfp
from repro_torch.launch import train as launch
from repro_torch.models.gnn import blocks as B
from repro_torch.models.gnn.models import GAT, GCN, GraphSAGE
from repro_torch.policy import builtin as tpol
from repro_torch.train import gnn_step as tstep
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import GNNTrainer

CPU = Runtime.simulated(4, device="cpu")
D_HIDDEN = 16
EPOCHS = 6
ARCHS = {"gcn": GCN, "graphsage": GraphSAGE, "gat": GAT}
COUNTERS = ("halo.gslot_skipped", "halo.gslot_wired")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    obs.disable()
    monkeypatch.setattr(obs.metrics, "REGISTRY", obs.MetricsRegistry())
    yield
    obs.disable()


@pytest.fixture(scope="module")
def pg(tmp_path_factory):
    pg, _ = datasets.load_partitioned(
        "yelp_like@smoke", n_parts=4,
        cache_dir=tmp_path_factory.mktemp("plans"))
    return pg


def _trainer(pg, arch, schedule="blocking", fault_plan=None, wired=False):
    model = ARCHS[arch](pg.x.shape[-1], D_HIDDEN, pg.n_classes,
                        generator=torch.Generator().manual_seed(0))
    tr = GNNTrainer(model, pg, SylvieConfig(mode="async", bits=1,
                                            schedule=schedule),
                    policy=tpol.BoundedStaleness(eps_s=4, bits=1),
                    runtime=CPU, fault_plan=fault_plan)
    if wired:
        tr.x = tr.x.clone().requires_grad_()
    return tr


def _counts():
    got = obs.snapshot()["counters"]
    return tuple(got.get(k, 0) for k in COUNTERS)


@pytest.mark.parametrize("variant", ["blocking", "overlap", "faulty"])
@pytest.mark.parametrize("arch", ["gcn", "graphsage"])
def test_unwired_site_0_trains_bit_equal_to_the_wired_path(pg, arch, variant):
    kw = (dict(fault_plan=tfp.FaultPlan(seed=7, drop_rate=0.15,
                                        corrupt_rate=0.05))
          if variant == "faulty" else dict(schedule=variant))
    runs = {}
    for wired in (False, True):
        tr = _trainer(pg, arch, wired=wired, **kw)
        ms = tr.fit(EPOCHS)
        runs[wired] = (tr, ms)
    (skip, ms), (full, ms_full) = runs[False], runs[True]
    assert [m.mode for m in ms] == ["sync", "async", "async", "async",
                                    "sync", "async"]
    if variant == "faulty":
        assert sum(m.faults_injected for m in ms) > 0
    assert [m.loss for m in ms] == [m.loss for m in ms_full]
    for a, b in zip(topt.tree_leaves(skip.state.params),
                    topt.tree_leaves(full.state.params)):
        assert torch.equal(a, b)
    assert not skip.state.halo.grads[0].any()
    assert full.state.halo.grads[0].any()       # the wired run did fill it
    for a, b in zip(skip.state.halo.grads[1:], full.state.halo.grads[1:]):
        assert torch.equal(a, b)


def _async_step(pg, arch, wired):
    """An async step (epoch 1) traced under fake clocks, after the sync
    warm-up epoch: its ``halo`` and ``agg`` spans and its counters."""
    tr = _trainer(pg, arch, wired=wired)
    tr.fit(1)
    before = _counts()
    host = obs.FakeClock(start=50.0, tick=1e-3)
    obs.enable(host, device_clock=obs.FakeDeviceClock(host))
    assert tr.fit(1)[-1].mode == "async"
    events = obs.drain()
    halos = {(e["args"]["site"], e["args"]["dir"]) for e in events
             if e["name"] == "halo"}
    aggs = {(e["args"]["dir"], e["args"]["width"]) for e in events
            if e["name"] == "agg"}
    counts = tuple(a - b for a, b in zip(_counts(), before))
    return tr, halos, aggs, counts


@pytest.mark.parametrize("arch,wired", [("graphsage", False),
                                        ("graphsage", True), ("gat", False),
                                        ("gat", True)])
def test_site_0_backward_runs_only_where_its_h_needs_a_gradient(pg, arch,
                                                                wired):
    tr, halos, aggs, counts = _async_step(pg, arch, wired)
    engaged = arch == "graphsage" and not wired
    assert ((0, "bwd") in halos) is not engaged
    assert (1, "bwd") in halos and (0, "fwd") in halos
    if arch == "graphsage":
        assert (("bwd", tr.site_dims[0]) in aggs) is not engaged
        assert ("bwd", D_HIDDEN) in aggs
    else:
        # GAT aggregates through its attention kernels, which open no
        # ``agg`` span; its site-0 ``halo`` backward shows that the
        # gradient of its layer-0 table (hw) ran
        assert aggs == set()
    assert counts == ((1, 1) if engaged else (0, 2))
    # the sync warm-up epoch wires no slot and counts nothing
    assert sum(_counts()) == 2


# model -> (graph, sites skipped in an async step)
ZOO = {"gcn": ("yelp_like@smoke", 1), "graphsage": ("yelp_like@smoke", 1),
       "gat": ("yelp_like@smoke", 0), "pna": ("yelp_like@smoke", 0),
       "meshgraphnet": ("mesh_like@smoke", 0),
       "schnet": ("molecule_like@smoke", 0),
       "nequip": ("molecule_like@smoke", 0)}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_only_a_site_whose_h_is_the_input_goes_unwired(name):
    graph, skipped = ZOO[name]
    spec = configs.get(name).reduced()
    pg = launch.gnn_graph(spec, graph, 4)
    model = spec.make(pg.x.shape[-1], pg.n_classes)
    opt = topt.sgd(0.1)
    _, step, _ = tstep.make_gnn_steps(
        model, SylvieConfig(mode="async", bits=1), opt)
    block = B.build_block(pg, "cpu")
    state = tstep.GNNTrainState.create(model.param_tree(), opt, block.plan,
                                       model.comm_dims())
    x, y, mask = (torch.as_tensor(a) for a in (pg.x, pg.y, pg.train_mask))
    new, loss = step(state, block, x, y, mask, (0, 1))
    n_sites = len(model.comm_dims())
    assert _counts() == (skipped, n_sites - skipped)
    assert torch.isfinite(loss)
    for i, g in enumerate(new.halo.grads):
        # an unwired site keeps its cache: the state's own tensor
        assert (g is state.halo.grads[i]) is (i < skipped)
