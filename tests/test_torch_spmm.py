"""The port's SpMM aggregation against the JAX reference, on the CPU.

The port's kernel takes a true CSR; the JAX Pallas kernel a padded one.
``csr_from_padded`` turns the JAX layout into the port's (every slot kept),
so both compute ``out[r] = sum_s w[r, s] * table[idx[r, s]]`` on the same
numpy inputs. Tolerance ``rtol 2e-4, atol 1e-4``: the two sum in different
orders (the Pallas kernel per source tile, ``segment_sum`` per edge list,
the port per CSR row).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import formats as jformats
from repro.graph import partition as jpartition
from repro.graph import synthetic as jsynthetic
from repro.kernels.spmm.ref import spmm_ref as jax_spmm_ref
from repro.kernels.spmm.spmm import spmm as jax_spmm
from repro.models.gnn import blocks as JB
from repro_torch.graph import formats, partition, synthetic
from repro_torch.kernels.spmm.ops import spmm
from repro_torch.kernels.spmm.ref import csr_from_edges, csr_from_padded
from repro_torch.models.gnn import blocks as TB

RTOL, ATOL = 2e-4, 1e-4


@pytest.mark.parametrize("n_src,n_rows,max_deg,d",
                         [(50, 40, 6, 16), (1000, 300, 12, 200),
                          (700, 700, 32, 75), (4000, 128, 64, 288)])
def test_spmm_matches_pallas_kernel(n_src, n_rows, max_deg, d):
    rng = np.random.default_rng(n_src)
    table = rng.normal(0, 1, (n_src, d)).astype(np.float32)
    idx = rng.integers(0, n_src, (n_rows, max_deg)).astype(np.int32)
    w = (rng.normal(0, 1, (n_rows, max_deg))
         * (rng.random((n_rows, max_deg)) > 0.3)).astype(np.float32)
    out_j = jax_spmm(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w),
                     interpret=True, src_tile=max(64, n_src // 3))
    ref_j = jax_spmm_ref(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w))
    out_t = spmm(torch.from_numpy(table), csr_from_padded(idx, w, n_src))
    assert tuple(out_t.shape) == (n_rows, d)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_j), rtol=RTOL,
                               atol=ATOL)


def test_spmm_gcn_aggregation_equivalence():
    """The SpMM reproduces the JAX runtime's gather + segment_sum GCN
    aggregation on the same graph (one partition, self-loops, symmetric
    weights)."""
    g = synthetic.planted_partition(n_nodes=300, d_feat=32)
    ei = formats.add_self_loops(g.edge_index, g.n_nodes)
    ew = formats.gcn_edge_weights(ei, g.n_nodes)
    src, dst = ei
    msgs = jnp.asarray(g.x)[src] * ew[:, None]
    ref = jax.ops.segment_sum(msgs, jnp.asarray(dst), num_segments=g.n_nodes)
    csr = csr_from_edges(src, dst, ew, g.n_nodes, g.n_nodes)
    out = spmm(torch.from_numpy(g.x), csr)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_spmm_plain_version_sums_in_csr_order():
    """On the CPU the plain version is exactly a row-by-row sum in CSR order
    (what the CUDA kernel computes): compare with an explicit float32 loop."""
    rng = np.random.default_rng(5)
    table = rng.normal(0, 1, (30, 7)).astype(np.float32)
    src = rng.integers(0, 30, 200)
    dst = rng.integers(0, 12, 200)
    w = rng.normal(0, 1, 200).astype(np.float32)
    csr = csr_from_edges(src, dst, w, 12, 30)
    out = spmm(torch.from_numpy(table), csr).numpy()
    rp, col, cw = csr.row_ptr.numpy(), csr.col.numpy(), csr.w.numpy()
    want = np.zeros((12, 7), np.float32)
    for r in range(12):
        for e in range(rp[r], rp[r + 1]):
            want[r] = want[r] + cw[e] * table[col[e]]
    np.testing.assert_array_equal(out, want)
    # rows keep their edge-list order
    order = np.argsort(dst, kind="stable")
    np.testing.assert_array_equal(col, src[order])


def test_csr_from_edges_rejects_out_of_range():
    with pytest.raises(ValueError):
        csr_from_edges(np.array([0, 5]), np.array([0, 1]), np.ones(2), 2, 5)
    with pytest.raises(ValueError):
        spmm(torch.zeros(4, 3), csr_from_edges(np.array([0]), np.array([0]),
                                               np.ones(1), 1, 5))


def _skewed(n=500, p=4, layout="compact"):
    g = synthetic.powerlaw_community(n_nodes=n, d_feat=16, avg_degree=10)
    g, ew = formats.gcn_normalize(g)
    tpg = partition.partition_graph(g, p, method="skewed", edge_weight=ew,
                                    layout=layout)
    jg = jsynthetic.powerlaw_community(n_nodes=n, d_feat=16, avg_degree=10)
    jg, jew = jformats.gcn_normalize(jg)
    jpg = jpartition.partition_graph(jg, p, method="skewed", edge_weight=jew,
                                     layout=layout)
    return tpg, jpg


@pytest.mark.parametrize("layout", ["dense", "compact"])
def test_block_aggregation_matches_jax_blocks(layout):
    """Over a partitioned stack: the port's one-launch SpMM over the
    flattened stack == its own gather_src + agg_sum == JAX's
    ``agg_sum(gather_src(table) * edge_weight)``; degrees equal JAX's."""
    tpg, jpg = _skewed(layout=layout)
    tblk, jblk = TB.build_block(tpg), JB.build_block(jpg)
    rng = np.random.default_rng(1)
    p, n_ext = tpg.plan.n_parts, tpg.plan.n_local + tpg.plan.halo_rows
    table = rng.normal(0, 1, (p, n_ext, 16)).astype(np.float32)
    ref = JB.agg_sum(jblk, JB.gather_src(jblk, jnp.asarray(table))
                     * jblk.edge_weight[..., None])
    tt = torch.from_numpy(table)
    out = TB.aggregate(tblk, tt)
    plain = TB.agg_sum(tblk, TB.gather_src(tblk, tt)
                       * tblk.edge_weight[..., None])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(TB.degrees(tblk).numpy(),
                                  np.asarray(JB.degrees(jblk)))
    assert tblk.csr.nnz == int(tpg.edge_mask.sum())
