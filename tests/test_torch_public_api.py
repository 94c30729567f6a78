"""The rest of the reference's public functions in modules the port already
has, each against ``repro``'s on the same numpy inputs, on the CPU.

* ``graph.formats``: ``mean_edge_weights``, ``pad_edges`` (with and without
  per-edge rows) and ``pad_to`` equal the reference's arrays;
* ``graph.synthetic.powerlaw`` equals the reference's graph;
* ``graph.partition``: ``HaloPlan.real_send_counts`` and ``pad_efficiency``
  of both layouts equal the reference's;
* ``core.exchange``: ``exchange`` and ``exchange_quantized`` through the
  port's simulated backend (and ``None``) equal the reference's dense
  all-to-all of the same buffer bit for bit;
* ``core.quantization``: ``theoretical_variance`` within 1e-6;
  ``fake_quantize`` given the reference's noise ``u`` equal to the
  reference's ``dequantize(quantize(h, key))`` bit for bit (bits 1, 2, 3,
  4, 8, stochastic and deterministic); ``straight_through_quantize`` that
  value forward and the identity backward (a ``torch.autograd.Function``);
  ``QuantizedTensor.payload_bits_per_value``; and the reference's
  statistical checks (``tests/test_quantization.py``: stochastic rounding
  unbiased within 5 standard errors, the empirical variance within
  [0.05, 2] x ``theoretical_variance``) repeated for the port with noise
  from a seeded generator;
* ``models.nn``: ``layer_norm`` and ``rms_norm`` (with and without
  ``gamma``, float32 and bfloat16) within 1e-6 of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exchange as JX
from repro.core import quantization as jq
from repro.graph import formats as jformats
from repro.graph import partition as jpartition
from repro.graph import synthetic as jsynthetic
from repro.models import nn as jnn
from repro_torch.core import exchange as X
from repro_torch.core import quantization as q
from repro_torch.dist.backend import SimulatedBackend
from repro_torch.graph import formats, partition, synthetic
from repro_torch.models import nn as tnn

KEY = jax.random.PRNGKey(0)


def _ei(n=50, e=300, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, (2, e)).astype(np.int32)


def test_mean_edge_weights_equal_the_references():
    ei = _ei()
    a, b = formats.mean_edge_weights(ei, 60), jformats.mean_edge_weights(
        ei, 60)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("extra", [None, "rows"])
@pytest.mark.parametrize("e_pad", [300, 317])
def test_pad_edges_equals_the_references(extra, e_pad):
    ei = _ei()
    ex = None if extra is None else np.random.default_rng(1).normal(
        size=(300, 3)).astype(np.float32)
    got = formats.pad_edges(ei, e_pad, fill_node=7, extra=ex)
    want = jformats.pad_edges(ei, e_pad, fill_node=7, extra=ex)
    assert len(got) == len(want) == (2 if ex is None else 3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        formats.pad_edges(ei, 299)


@pytest.mark.parametrize("axis,n", [(0, 9), (1, 5), (0, 6)])
def test_pad_to_equals_the_references(axis, n):
    arr = np.arange(24, dtype=np.float32).reshape(6, 4)
    if n < arr.shape[axis]:
        with pytest.raises(ValueError):
            formats.pad_to(arr, n, axis)
        return
    a, b = formats.pad_to(arr, n, axis), jformats.pad_to(arr, n, axis)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(n_nodes=500, avg_degree=7,
                                             d_feat=9, n_classes=3, seed=5)])
def test_powerlaw_equals_the_references(kw):
    if not kw:
        kw = dict(n_nodes=2000)
    a, b = synthetic.powerlaw(**kw), jsynthetic.powerlaw(**kw)
    assert a.n_nodes == b.n_nodes and a.n_classes == b.n_classes
    for f in ("edge_index", "x", "y", "train_mask", "val_mask", "test_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert synthetic.by_name("powerlaw", n_nodes=300).n_nodes == 300


@pytest.mark.parametrize("layout", ["dense", "compact"])
def test_plan_counts_equal_the_references(layout):
    jg = jsynthetic.powerlaw_community(n_nodes=400, d_feat=4, seed=2)
    g = synthetic.powerlaw_community(n_nodes=400, d_feat=4, seed=2)
    plan = partition.partition_graph(g, 4, layout=layout).plan
    jplan = jpartition.partition_graph(jg, 4, layout=layout).plan
    assert np.array_equal(plan.real_send_counts(), jplan.real_send_counts())
    assert plan.real_send_counts().sum() == plan.real_rows()
    assert plan.pad_efficiency() == jplan.pad_efficiency()
    assert 0.0 < plan.pad_efficiency() <= 1.0


@pytest.mark.parametrize("d,dtype", [(5, np.float32), (3, np.int32)])
def test_exchange_equals_the_references(d, dtype):
    p, h_pad = 4, 3
    x = np.random.default_rng(0).normal(0, 9, (p, p * h_pad, d)).astype(dtype)
    want = np.asarray(JX.exchange(jnp.asarray(x)))
    for be in (None, SimulatedBackend(p)):
        got = X.exchange(torch.as_tensor(x), be)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [1, 8])
def test_exchange_quantized_equals_the_references(bits):
    p, h_pad, d = 4, 3, 20
    h = np.random.default_rng(1).normal(size=(p, p * h_pad, d)).astype(
        np.float32)
    jqt = jq.quantize(jnp.asarray(h), bits, stochastic=False)
    qt = q.quantize(torch.as_tensor(h), bits, stochastic=False)
    want = JX.exchange_quantized(jqt)
    for be in (None, SimulatedBackend(p)):
        got = X.exchange_quantized(qt, be)
        assert np.array_equal(got.data.numpy(), np.asarray(want.data))
        for a, b in ((got.scale, want.scale), (got.zero, want.zero)):
            assert np.array_equal(a.float().numpy(),
                                  np.asarray(b.astype(jnp.float32)))
        assert (got.bits, got.feat_dim) == (want.bits, want.feat_dim)


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16, 32])
def test_payload_bits_per_value(bits):
    h = torch.randn(3, 10, generator=torch.Generator().manual_seed(0))
    qt = q.quantize(h, bits, stochastic=False)
    assert qt.payload_bits_per_value == jq.quantize(
        jnp.asarray(h.numpy()), bits, stochastic=False).payload_bits_per_value
    assert qt.payload_bits_per_value == float(bits)


@pytest.mark.parametrize("bits", [1, 2, 8])
def test_theoretical_variance_equals_the_references(bits):
    h = np.array(jax.random.normal(KEY, (5, 33)))
    np.testing.assert_allclose(
        q.theoretical_variance(torch.as_tensor(h), bits).numpy(),
        np.asarray(jq.theoretical_variance(jnp.asarray(h), bits)),
        rtol=1e-6)


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_fake_quantize_equals_the_references(bits, stochastic):
    key = jax.random.fold_in(KEY, bits)
    h = jax.random.normal(KEY, (12, 37))
    u = np.array(jax.random.uniform(key, h.shape, dtype=jnp.float32))
    want = np.asarray(jq.fake_quantize(h, bits, key, stochastic))
    got = q.fake_quantize(torch.as_tensor(np.array(h)), bits,
                          stochastic=stochastic, u=torch.as_tensor(u))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_straight_through_is_fake_quantize_forward_and_identity_backward():
    h = torch.as_tensor(np.array(jax.random.normal(KEY, (4, 8))))
    u = torch.rand(h.shape, generator=torch.Generator().manual_seed(3))
    x = h.clone().requires_grad_()
    y = q.straight_through_quantize(x, 1, u=u)
    assert torch.equal(y.detach(), q.fake_quantize(h, 1, u=u))
    g = torch.randn(h.shape, generator=torch.Generator().manual_seed(4))
    (grad,) = torch.autograd.grad(y, x, g)
    assert torch.equal(grad, g)
    (ones,) = torch.autograd.grad(
        q.straight_through_quantize(x, 1, torch.Generator().manual_seed(5))
        .sum(), x)
    assert torch.equal(ones, torch.ones_like(h))
    assert issubclass(q._StraightThrough, torch.autograd.Function)


def test_stochastic_rounding_unbiased():
    """The reference's check for the port: the mean of 600 one-bit fake
    quantizations (noise from a seeded generator) within 5 standard errors
    of ``h``."""
    h = torch.as_tensor(np.array(jax.random.normal(KEY, (16, 24))))
    gen = torch.Generator().manual_seed(0)
    n = 600
    acc = torch.zeros_like(h)
    for _ in range(n):
        acc += q.fake_quantize(h, 1, gen)
    mean = (acc / n).numpy()
    scale = (h.amax(-1) - h.amin(-1))[:, None].numpy()
    tol = 5 * scale / np.sqrt(6 * n)
    assert (np.abs(mean - h.numpy()) < tol + 1e-4).all()


def test_variance_matches_theorem1():
    """The reference's check for the port: the empirical per-row variance
    of 800 one-bit fake quantizations within [0.05, 2] x Theorem 1's."""
    h = torch.as_tensor(np.array(jax.random.normal(KEY, (4, 64))))
    gen = torch.Generator().manual_seed(1)
    samples = np.stack([q.fake_quantize(h, 1, gen).numpy()
                        for _ in range(800)])
    emp_var = samples.var(axis=0).sum(-1)
    theo = q.theoretical_variance(h, 1).numpy()
    assert (emp_var < 2.0 * theo).all()
    assert (emp_var > 0.05 * theo).all()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_norms_equal_the_references(dtype):
    x = np.random.default_rng(0).normal(2, 3, (6, 40)).astype(np.float32)
    gamma = np.random.default_rng(1).normal(size=40).astype(np.float32)
    tx = torch.as_tensor(x)
    jx = jnp.asarray(x)
    if dtype == "bfloat16":
        tx, jx = tx.bfloat16(), jx.astype(jnp.bfloat16)
    np.testing.assert_allclose(
        tnn.layer_norm(tx.float()).numpy(),
        np.asarray(jnn.layer_norm(jx.astype(jnp.float32))), rtol=1e-6,
        atol=1e-6)
    for g in (None, gamma):
        got = tnn.rms_norm(tx, None if g is None else torch.as_tensor(g))
        want = jnn.rms_norm(jx, None if g is None else jnp.asarray(g))
        assert str(got.dtype).split(".")[1] == str(want.dtype)
        rtol = 1e-6 if dtype == np.float32 else 1e-2
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=rtol, atol=rtol)


def test_plan_refresh_equals_the_references():
    from repro.serve import delta as jdelta
    from repro_torch.serve import delta
    g = synthetic.powerlaw_community(n_nodes=300, d_feat=4, seed=1)
    jg = jsynthetic.powerlaw_community(n_nodes=300, d_feat=4, seed=1)
    pg, jpg = partition.partition_graph(g, 4), jpartition.partition_graph(
        jg, 4)
    ids = np.array([3, 77, 150])
    got = delta.plan_refresh(pg, ids, 2)
    want = jdelta.plan_refresh(jpg, ids, 2)
    assert got.affected_rows == want.affected_rows
    assert (got.changed, got.full) == (want.changed, want.full)
    for a, b in zip(got.send_affected, want.send_affected):
        assert np.array_equal(a, b)
    again = delta.FrontierIndex.build(pg).plan_refresh(ids, 2)
    assert again.affected_rows == got.affected_rows
