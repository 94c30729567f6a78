"""The port's serving slice against the JAX reference, on the CPU.

``yelp_like@smoke`` partitioned 4 ways (compact layout) by both packages,
GCN (d_hidden 16, 2 layers) with the JAX ``model.init`` parameters carried
into the port by ``params_from_numpy``:

* 32 bits: port logits allclose to the JAX ``InferenceEngine.full_sweep()``
  logits at ``rtol 1e-5, atol 1e-5`` (float32 summation order);
* 1 bit, deterministic: allclose at ``atol 1e-4``. Site 0 quantizes the
  features themselves, bit-identical on both sides; a site-1 value whose
  hbar sits within float noise of .5 could round the other way — the seed
  here hits none, and one that did would be changed, not the tolerance;
* a port ``refresh()`` equals a port full recompute exactly, and ships the
  bytes the JAX engine reports for the same refresh;
* checkpoints cross in both directions (``arrays.npz`` + ``manifest.json``,
  ``format_version`` 2).
"""
import jax
import numpy as np
import pytest
import torch

from repro import datasets as jdatasets
from repro.models.gnn.models import GCN as JGCN
from repro.policy.base import EpochDecision as JDecision
from repro.policy.base import SiteDecision as JSite
from repro.serve import InferenceEngine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.train import checkpoint as jckpt
from repro_torch import datasets
from repro_torch.core.quantization import comm_bytes
from repro_torch.dist.runtime import Runtime
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.gnn.models import GCN
from repro_torch.policy.base import EpochDecision, SiteDecision
from repro_torch.serve import InferenceEngine, ServeConfig
from repro_torch.train import checkpoint as ckpt

REF = "yelp_like@smoke"
D_HIDDEN = 16


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    pg = datasets.load_partitioned(REF, n_parts=4)
    jpg, _ = jdatasets.load_partitioned(
        REF, n_parts=4, cache_dir=tmp_path_factory.mktemp("plans"))
    jmodel = JGCN(pg.x.shape[-1], D_HIDDEN, pg.n_classes, n_layers=2)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return pg, jpg, jmodel, params


def _model(pg):
    return GCN(pg.x.shape[-1], D_HIDDEN, pg.n_classes, n_layers=2)


def _engine(pg, params, **cfg):
    decision = cfg.pop("decision", None)
    return InferenceEngine(_model(pg), pg, params, config=ServeConfig(**cfg),
                           decision=decision,
                           runtime=Runtime.simulated(4, device="cpu"))


def _jengine(jpg, jmodel, params, **cfg):
    decision = cfg.pop("decision", None)
    return JEngine(jmodel, jpg, params, config=JServeConfig(**cfg),
                   decision=decision)


def test_fp32_logits_match_jax(setup):
    pg, jpg, jmodel, params = setup
    eng = _engine(pg, params, bits=32)
    jeng = _jengine(jpg, jmodel, params, bits=32)
    eng.full_sweep()
    jeng.full_sweep()
    np.testing.assert_allclose(eng.logits, jeng.logits, rtol=1e-5, atol=1e-5)


def test_one_bit_logits_match_jax(setup):
    pg, jpg, jmodel, params = setup
    eng = _engine(pg, params, bits=1)
    jeng = _jengine(jpg, jmodel, params, bits=1)
    rep, jrep = eng.full_sweep(), jeng.full_sweep()
    # site 0 quantizes the features: the dequantized halos agree to the
    # documented FMA tolerance
    np.testing.assert_allclose(eng._halos[0].numpy(),
                               np.asarray(jeng._halos[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(eng.logits, jeng.logits, rtol=1e-5, atol=1e-4)
    assert (rep.payload_bytes, rep.ec_bytes, rep.meta_bytes,
            rep.affected_rows) == (jrep.payload_bytes, jrep.ec_bytes,
                                   jrep.meta_bytes, jrep.affected_rows)


def test_per_site_bits_via_decision(setup):
    """Per-site widths ride the same decision lattice as in JAX, and the
    sweep ships (and reports) what JAX reports for the same decision."""
    pg, jpg, jmodel, params = setup
    eng = _engine(pg, params, decision=EpochDecision(sites=(
        SiteDecision(1, 1, stochastic=False),
        SiteDecision(3, 3, stochastic=False))))
    jeng = _jengine(jpg, jmodel, params, decision=JDecision(sites=(
        JSite(1, 1, stochastic=False), JSite(3, 3, stochastic=False))))
    rep, jrep = eng.full_sweep(), jeng.full_sweep()
    assert [s.fwd_bits for s in eng.decision.sites] == [1, 4]   # snapped
    d0, d1 = eng.site_dims
    rows = rep.affected_rows
    assert rep.payload_bytes == comm_bytes(rows[0], d0, 1)[0] + \
        comm_bytes(rows[1], d1, 4)[0]
    assert (rep.payload_bytes, rep.ec_bytes) == (jrep.payload_bytes,
                                                 jrep.ec_bytes)


def test_delta_refresh_equals_full_sweep(setup):
    pg, jpg, jmodel, params = setup
    rng = np.random.default_rng(7)
    ids = rng.choice(pg.part_of.size, size=6, replace=False)
    rows = rng.normal(0, 1, (6, pg.x.shape[-1])).astype(np.float32)
    a, b = _engine(pg, params, bits=1), _engine(pg, params, bits=1)
    a.full_sweep()
    b.full_sweep()
    da = a.refresh(ids, rows)                   # k-hop delta
    db = b.refresh(ids, rows, full=True)        # ground truth
    assert da.kind == "delta" and db.kind == "full"
    np.testing.assert_array_equal(a._logits_host, b._logits_host)
    for la, lb in zip(a._layers + a._halos, b._layers + b._halos):
        assert torch.equal(la, lb)
    assert all(r1 < r2 for r1, r2 in zip(da.affected_rows, db.affected_rows))
    assert da.meta_bytes > 0 and db.meta_bytes == 0
    assert da.wire_bytes < db.wire_bytes
    # the same refresh through the JAX engine: same bytes, same logits
    j = _jengine(jpg, jmodel, params, bits=1)
    j.full_sweep()
    jd = j.refresh(ids, rows)
    assert (da.affected_rows, da.payload_bytes, da.ec_bytes, da.meta_bytes) \
        == (jd.affected_rows, jd.payload_bytes, jd.ec_bytes, jd.meta_bytes)
    np.testing.assert_allclose(a.logits, j.logits, rtol=1e-5, atol=1e-4)


def test_staleness_bound_and_refresh_escalation(setup):
    pg, _, _, params = setup
    eng = _engine(pg, params, bits=1, max_staleness=2)
    ids, rows = [5], np.zeros((1, pg.x.shape[-1]), np.float32)
    first = eng.refresh(ids, rows)              # never swept: full, forced
    kinds = [eng.refresh(ids, rows) for _ in range(3)]
    assert (first.kind, first.forced) == ("full", True)
    assert [(r.kind, r.forced) for r in kinds] == [
        ("delta", False), ("delta", False), ("full", True)]
    with pytest.raises(ValueError):
        eng.refresh([pg.part_of.size], rows)
    with pytest.raises(ValueError):
        eng.refresh(ids, np.zeros((2, pg.x.shape[-1]), np.float32))


def test_query_and_embeddings_are_lookups(setup):
    pg, _, _, params = setup
    eng = _engine(pg, params, bits=1)
    with pytest.raises(RuntimeError):
        eng.query([0])
    eng.full_sweep()
    ids = np.array([0, 7, 123, pg.part_of.size - 1])
    out = eng.query(ids)
    np.testing.assert_array_equal(out.logits, eng.logits[ids])
    np.testing.assert_array_equal(out.predictions, eng.logits[ids].argmax(-1))
    np.testing.assert_array_equal(eng.embeddings(ids, site=0),
                                  pg.unpartition(pg.x)[ids])
    assert eng.embeddings(ids).shape == (4, D_HIDDEN)
    with pytest.raises(ValueError):
        eng.query([-1])


def test_stochastic_serving_is_seeded(setup):
    pg, _, _, params = setup

    def logits(seed):
        eng = InferenceEngine(_model(pg), pg, params,
                              config=ServeConfig(bits=1, stochastic=True),
                              runtime=Runtime.simulated(4, device="cpu"),
                              seed=seed)
        eng.full_sweep()
        return eng.logits

    assert np.array_equal(logits(0), logits(0))
    assert not np.array_equal(logits(0), logits(1))


def test_checkpoints_cross_between_packages(setup, tmp_path):
    pg, jpg, jmodel, params = setup
    # JAX save -> port restore (and an engine from it)
    jckpt.save(tmp_path / "jax", 4, {"params": params}, meta={"by": "jax"})
    model = _model(pg)
    got, meta = ckpt.restore_for_inference(tmp_path / "jax",
                                           params_to_numpy(model))
    assert meta["by"] == "jax" and meta["step"] == 4
    assert meta["format_version"] == ckpt.FORMAT_VERSION == jckpt.FORMAT_VERSION
    for layer in params:
        for leaf in params[layer]:
            np.testing.assert_array_equal(got[layer][leaf],
                                          params[layer][leaf])
    eng, _ = InferenceEngine.from_checkpoint(
        tmp_path / "jax", model, pg, config=ServeConfig(bits=32),
        runtime=Runtime.simulated(4, device="cpu"))
    ref = _engine(pg, params, bits=32)
    eng.full_sweep()
    ref.full_sweep()
    np.testing.assert_array_equal(eng.logits, ref.logits)
    # port save -> JAX restore
    ckpt.save(tmp_path / "port", 9, {"params": params_to_numpy(model)},
              meta={"by": "port"})
    jparams, jmeta = jckpt.restore_for_inference(
        tmp_path / "port", jmodel.init(jax.random.PRNGKey(1)))
    assert jmeta["by"] == "port" and jmeta["step"] == 9
    for layer in params:
        for leaf in params[layer]:
            np.testing.assert_array_equal(np.asarray(jparams[layer][leaf]),
                                          params[layer][leaf])


def test_restore_refuses_missing_or_misshaped_params(setup, tmp_path):
    pg, _, _, params = setup
    ckpt.save(tmp_path, 0, {"params": params})
    wide = GCN(pg.x.shape[-1], D_HIDDEN + 1, pg.n_classes)
    with pytest.raises(ValueError):
        ckpt.restore_for_inference(tmp_path, params_to_numpy(wide))
    extra = dict(params, layer2={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError):
        ckpt.restore_for_inference(tmp_path, extra)
    deep = GCN(pg.x.shape[-1], D_HIDDEN, pg.n_classes, n_layers=3)
    with pytest.raises(KeyError):
        params_from_numpy(deep, dict(params, layer1={   # no layer2 in it
            "w": np.zeros((D_HIDDEN, D_HIDDEN), np.float32),
            "b": np.zeros(D_HIDDEN, np.float32)}))
    with pytest.raises(ValueError):
        params_from_numpy(wide, params)


def test_params_round_trip(setup):
    pg, _, _, params = setup
    back = params_to_numpy(params_from_numpy(_model(pg), params))
    assert back.keys() == params.keys()
    for layer in params:
        assert back[layer].keys() == params[layer].keys()
        for leaf in params[layer]:
            np.testing.assert_array_equal(back[layer][leaf],
                                          params[layer][leaf])
