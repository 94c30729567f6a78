"""The port's graph copies and halo exchange against the JAX reference.

* The numpy copies (generators, registry, normalization, partitioner,
  frontier) give exactly the JAX package's arrays.
* ``gather_boundary``, the dense transpose, the compact ring exchange in both
  directions, and the quantized exchange (payload + scale + zero) are
  *exactly* equal to JAX, on dense and compact plans of a ``method="skewed"``
  partition (ragged ring buckets, as in ``tests/test_halo_compact.py``).
* On those plans the forward and reversed rings differ, so a port that
  reused the forward direction for ``reverse=True`` would fail here.
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
from repro.dist.backend import SimulatedBackend as JBackend
from repro.graph import formats as jformats
from repro.graph import partition as jpartition
from repro.graph import synthetic as jsynthetic
from repro_torch import datasets
from repro_torch.core import exchange as tx
from repro_torch.core import quantization as tq
from repro_torch.dist.backend import SimulatedBackend
from repro_torch.graph import formats, partition, synthetic


def _graphs(n=900, d=16):
    """The same power-law graph (self-loops + GCN weights) from both packages."""
    g = synthetic.powerlaw_community(n_nodes=n, d_feat=d, avg_degree=10,
                                     seed=0)
    jg = jsynthetic.powerlaw_community(n_nodes=n, d_feat=d, avg_degree=10,
                                       seed=0)
    return formats.gcn_normalize(g), jformats.gcn_normalize(jg)


def _assert_same_fields(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if va is None or vb is None:
                assert va is vb, f.name
            else:
                np.testing.assert_array_equal(va, vb, err_msg=f.name)
        elif dataclasses.is_dataclass(va):
            _assert_same_fields(va, vb)
        else:
            assert va == vb, f.name


@pytest.fixture(scope="module", params=["dense", "compact"])
def skewed(request):
    (g, ew), (jg, jew) = _graphs()
    pg = partition.partition_graph(g, 4, method="skewed", edge_weight=ew,
                                   layout=request.param)
    jpg = jpartition.partition_graph(jg, 4, method="skewed", edge_weight=jew,
                                     layout=request.param)
    return pg, jpg


def test_partition_copy_matches_jax(skewed):
    pg, jpg = skewed
    _assert_same_fields(pg, jpg)
    for fn in (partition.global_edges, partition.halo_source_globals):
        jfn = getattr(jpartition, fn.__name__)
        for a, b in zip(np.atleast_2d(fn(pg)), np.atleast_2d(jfn(jpg))):
            np.testing.assert_array_equal(a, b)
    seeds = [3, 57, 101]
    np.testing.assert_array_equal(partition.khop_frontier(pg, seeds, 2),
                                  jpartition.khop_frontier(jpg, seeds, 2))
    for a, b in zip(partition.global_to_slot(pg),
                    jpartition.global_to_slot(jpg)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ref", ["yelp_like@smoke", "reddit_like@smoke",
                                 "amazon_like@smoke"])
def test_registry_copy_matches_jax(ref, tmp_path):
    pg = datasets.load_partitioned(ref, n_parts=4)
    jpg, _ = jdatasets.load_partitioned(ref, n_parts=4, cache_dir=tmp_path)
    _assert_same_fields(pg, jpg)
    name = ref.split("@")[0]
    assert dataclasses.asdict(datasets.get(name).target) == \
        dataclasses.asdict(jdatasets.get(name).target)
    assert datasets.get(name).tiers == jdatasets.get(name).tiers


def test_plan_arrays_and_byte_accounting_match_jax(skewed):
    pg, jpg = skewed
    plan, jplan = tx.PlanArrays.from_plan(pg.plan), jx.PlanArrays.from_plan(
        jpg.plan)
    for f in ("send_idx", "send_mask", "recv_mask"):
        np.testing.assert_array_equal(getattr(plan, f).numpy(),
                                      np.asarray(getattr(jplan, f)))
    for f in ("n_local", "h_pad", "n_parts", "bucket_sizes", "wire_rows",
              "real_rows", "halo_rows"):
        assert getattr(plan, f) == getattr(jplan, f), f
    for bits in (1, 2, 4, 8, 16, 32):
        assert tx.exchange_bytes(plan, 64, bits) == jx.exchange_bytes(
            jplan, 64, bits)
        assert tx.wire_bytes(plan, 64, bits) == jx.wire_bytes(jplan, 64, bits)


def test_gather_and_exchange_exactly_equal_jax(skewed):
    pg, jpg = skewed
    plan, jplan = tx.PlanArrays.from_plan(pg.plan), jx.PlanArrays.from_plan(
        jpg.plan)
    x = np.asarray(pg.x, np.float32)
    buf = tx.gather_boundary(torch.from_numpy(x), plan)
    jbuf = jx.gather_boundary(jnp.asarray(x), jplan)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    be, jbe = SimulatedBackend(), JBackend()
    for reverse in (False, True):
        y = tx.exchange_halo(buf, plan, be, reverse=reverse)
        jy = jx.exchange_halo(jbuf, jplan, jbe, reverse=reverse)
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    if plan.bucket_sizes is None:
        np.testing.assert_array_equal(be.exchange(be.exchange(buf)).numpy(),
                                      buf.numpy())      # an involution
    else:
        # ragged buckets: the two ring directions really differ, so reusing
        # the forward exchange for reverse=True cannot pass the check above
        fwd = tx.exchange_halo(buf, plan, be).numpy()
        back = jx.exchange_halo(jbuf, jplan, jbe, reverse=True)
        assert not np.array_equal(fwd, np.asarray(back))
        np.testing.assert_array_equal(
            be.exchange_compact(torch.from_numpy(fwd), plan.bucket_sizes,
                                reverse=True).numpy(), buf.numpy())


@pytest.mark.parametrize("bits", [1, 3, 16])
def test_quantized_exchange_exactly_equal_jax(skewed, bits):
    pg, jpg = skewed
    plan, jplan = tx.PlanArrays.from_plan(pg.plan), jx.PlanArrays.from_plan(
        jpg.plan)
    x = np.asarray(pg.x, np.float32)
    key = jax.random.PRNGKey(bits)
    jbuf = jx.gather_boundary(jnp.asarray(x), jplan)
    u = np.array(jax.random.uniform(key, jbuf.shape, dtype=jnp.float32))
    jqt = jq.quantize(jbuf, bits, key, stochastic=True, impl="jnp")
    qt = tq.quantize(tx.gather_boundary(torch.from_numpy(x), plan), bits,
                     u=torch.from_numpy(u))
    for reverse in (False, True):
        got = tx.exchange_quantized_halo(qt, plan, reverse=reverse)
        want = jx.exchange_quantized_halo(jqt, jplan, reverse=reverse)
        for f in ("data", "scale", "zero"):
            a, b = getattr(got, f), np.asarray(getattr(want, f))
            if a.dtype == torch.bfloat16:
                a = a.view(torch.int16).numpy().view(np.uint16)
                b = b.view(np.uint16)
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)
        np.testing.assert_array_equal(
            tq.dequantize(got).numpy(), np.asarray(jq.dequantize(want,
                                                                 impl="jnp")))
