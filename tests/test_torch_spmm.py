"""The port's SpMM aggregation against the JAX reference, on the CPU.

The port's kernel takes a true CSR; the JAX Pallas kernel a padded one.
``csr_from_padded`` turns the JAX layout into the port's (every slot kept),
so both compute ``out[r] = sum_s w[r, s] * table[idx[r, s]]`` on the same
numpy inputs. Tolerance ``rtol 2e-4, atol 1e-4``: the two sum in different
orders (the Pallas kernel per source tile, ``segment_sum`` per edge list,
the port per CSR row, with rows longer than ``SEGMENT`` edges split into
segments whose partials add left to right).
"""
import dataclasses

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
from repro_torch.kernels.spmm.ref import (SEGMENT, csr_from_edges,
                                          csr_from_padded, split_plan)
from repro_torch.models.gnn import blocks as TB

RTOL, ATOL = 2e-4, 1e-4


@pytest.mark.parametrize("n_src,n_rows,max_deg,d",
                         [(50, 40, 6, 16), (1000, 300, 12, 200),
                          (700, 700, 32, 75), (4000, 128, 64, 288),
                          (3000, 6, 20 * SEGMENT + 7, 24)])
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


def _hub_graph(seed=3, n_src=400, d=9):
    """Rows of 0, 1, SEGMENT, SEGMENT + 1 and ~20 * SEGMENT edges, and a
    tail of short random rows, in a shuffled edge list."""
    rng = np.random.default_rng(seed)
    degs = [0, 1, SEGMENT, SEGMENT + 1, 20 * SEGMENT + 13, 2 * SEGMENT, 5]
    degs += list(rng.integers(0, 40, 30))
    dst = np.repeat(np.arange(len(degs)), degs)
    perm = rng.permutation(dst.size)
    dst = dst[perm]
    src = rng.integers(0, n_src, dst.size)
    w = rng.normal(0, 1, dst.size).astype(np.float32)
    table = rng.normal(0, 1, (n_src, d)).astype(np.float32)
    return table, src, dst, w, len(degs)


def test_spmm_plain_version_splits_long_rows():
    """Rows of at most SEGMENT edges sum from 0 in CSR order; longer rows sum
    each SEGMENT-edge segment from 0 in CSR order and add the partials left
    to right. Compare with an explicit float32 loop, bit for bit."""
    table, src, dst, w, n_rows = _hub_graph()
    csr = csr_from_edges(src, dst, w, n_rows, table.shape[0])
    out = spmm(torch.from_numpy(table), csr).numpy()
    rp, col, cw = csr.row_ptr.numpy(), csr.col.numpy(), csr.w.numpy()
    want = np.zeros((n_rows, table.shape[1]), np.float32)
    for r in range(n_rows):
        parts = []
        for s0 in range(rp[r], max(rp[r + 1], rp[r] + 1), SEGMENT):
            acc = np.zeros(table.shape[1], np.float32)
            for e in range(s0, min(s0 + SEGMENT, rp[r + 1])):
                acc = acc + cw[e] * table[col[e]]
            parts.append(acc)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        want[r] = acc
    np.testing.assert_array_equal(out, want)
    assert int(np.diff(rp).max()) > 20 * SEGMENT


def test_spmm_hub_rows_match_segment_sum_and_pallas_kernel():
    """With hub rows split into segments the port still computes the JAX
    package's aggregation (``segment_sum``, and the Pallas kernel on the
    same rows padded to the largest degree)."""
    table, src, dst, w, n_rows = _hub_graph(seed=7, n_src=600, d=40)
    csr = csr_from_edges(src, dst, w, n_rows, table.shape[0])
    out = spmm(torch.from_numpy(table), csr).numpy()
    ref = jax.ops.segment_sum(jnp.asarray(table)[src] * w[:, None],
                              jnp.asarray(dst), num_segments=n_rows)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)
    rp, col, cw = csr.row_ptr.numpy(), csr.col.numpy(), csr.w.numpy()
    deg = np.diff(rp)
    idx = np.zeros((n_rows, deg.max()), np.int32)
    pw = np.zeros((n_rows, deg.max()), np.float32)
    for r in range(n_rows):
        idx[r, :deg[r]] = col[rp[r]:rp[r + 1]]
        pw[r, :deg[r]] = cw[rp[r]:rp[r + 1]]
    out_j = jax_spmm(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(pw),
                     interpret=True, src_tile=256)
    np.testing.assert_allclose(out, np.asarray(out_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("segment", [SEGMENT, 4, 1])
def test_split_plan_covers_every_edge_once_in_csr_order(segment):
    """The host plan: no unit longer than the segment, units in CSR order
    (every edge in exactly one unit, in order), every row written once
    (whole or through its partials), and a split row's partials in segment
    order."""
    _, src, dst, w, n_rows = _hub_graph()
    csr = csr_from_edges(src, dst, w, n_rows, 400)
    rp = csr.row_ptr.numpy().astype(np.int64)
    units, long_rows, long_ptr, n_partials = split_plan(rp, segment)
    units, long_rows = units.numpy(), long_rows.numpy()
    long_ptr = long_ptr.numpy()
    length = units[:, 1] - units[:, 0]
    assert length.max() <= segment and (length >= 0).all()
    covered = np.concatenate([np.arange(a, b) for a, b, _ in units])
    np.testing.assert_array_equal(covered, np.arange(rp[-1]))
    deg = np.diff(rp)
    whole = units[units[:, 2] < n_rows, 2]
    assert sorted(whole.tolist() + long_rows.tolist()) == list(range(n_rows))
    np.testing.assert_array_equal(long_rows, np.nonzero(deg > segment)[0])
    assert n_partials == long_ptr[-1] == int(
        np.ceil(deg[long_rows] / segment).sum())
    seg = units[units[:, 2] >= n_rows]
    slot_start = dict(zip((seg[:, 2] - n_rows).tolist(), seg[:, 0].tolist()))
    for i, r in enumerate(long_rows):
        starts = [slot_start[s] for s in range(long_ptr[i], long_ptr[i + 1])]
        assert starts == list(range(rp[r], rp[r + 1], segment))


def test_plain_version_does_not_depend_on_the_unit_order():
    """The sums' order is the CSR's, not the plan's: the same plan with its
    units shuffled gives the same bits."""
    table, src, dst, w, n_rows = _hub_graph(seed=11)
    csr = csr_from_edges(src, dst, w, n_rows, table.shape[0])
    perm = torch.from_numpy(np.random.default_rng(0).permutation(
        csr.units.shape[0]))
    shuffled = dataclasses.replace(csr, units=csr.units[perm].contiguous())
    t = torch.from_numpy(table)
    assert torch.equal(spmm(t, csr), spmm(t, shuffled))


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
