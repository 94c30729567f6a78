"""GAT's CSR kernels (their plain versions) against the JAX reference, on the
CPU.

The same numpy inputs go through ``repro.models.gnn.blocks`` and
``repro_torch`` on a ``method="skewed"`` 4-way partition of a power-law graph
with a 300-neighbour hub (split rows, longer than ``SEGMENT``, in the CSR
and in its transpose) and padding rows without edges:

* ``kernels.gat.softmax`` equals ``edge_softmax(leaky_relu(gather_src(s_src)
  + gather_dst(s_dst), 0.2))`` within rtol 1e-6, atol 1e-7 (``exp`` and the
  sums run in another order than XLA's); the port's ``gather_src`` /
  ``gather_dst`` equal JAX's;
* ``blocks.gat_aggregate`` (softmax + per-head SpMM, and in the backward the
  per-head SpMM over the transposed CSR, the SDDMM, the softmax backward and
  the transposed row sums) against ``jax.vjp`` of the reference's GAT
  aggregation (``repro/models/gnn/models.py:131-142``): the value within
  rtol 1e-5, atol 1e-6, the three gradients within rtol 1e-4, atol 2e-5 of
  values up to ~7 (the gradients of the scores cancel: ``d s_dst`` is a row
  sum of ``alpha (dalpha - c)``, mathematically small, so its error is held
  absolutely); padding rows get 0 in both; the backward calls no
  ``torch.index_select``, and hands the per-head SpMM over the transposed
  CSR the forward's alpha with ``w_idx = perm_t``;
* the plain versions sum in the order the CSR's plan fixes (the order the
  CUDA kernels keep): softmax, softmax_bwd, row_sums_t and the SDDMM bit
  for bit an explicit loop over each row's edges, a split row by 128-edge
  segments whose partials add left to right, at 1, 4 and 8 heads, over the
  300-edge hub and over rows of 1,300 (11 segments), 0, 1, 128 and 129
  edges; ``spmm_heads`` at one head equals
  ``spmm_ref`` bit for bit, and at four heads equals four one-head SpMMs;
  with ``w_idx`` it equals ``spmm_heads`` of ``w[w_idx]`` bit for bit, and
  the wrapper refuses a ``w_idx`` of another length, dtype or device; the
  SDDMM's plain version sums each (edge, head) in k order, bit for bit an
  explicit float32 loop at dh 3, 16 and 64;
* the wrappers refuse devices other than the CPU and CUDA.
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
from repro.models.gnn import blocks as JB
from repro_torch.graph import formats, partition, synthetic
from repro_torch.kernels.gat import ops as gops
from repro_torch.kernels.gat import ref as gref
from repro_torch.kernels.spmm import ops as sops
from repro_torch.kernels.spmm import ref as sref
from repro_torch.kernels.spmm.ref import (SEGMENT, csr_from_edges, spmm_ref,
                                          split_plan)
from repro_torch.models.gnn import blocks as TB

H, DH = 4, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run thousands of tiny torch ops; beside the other
    workers of a parallel test run, torch's idle threads spinning between
    them cost far more than they give. Each test here runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skewed(layout):
    """The same skewed partition from both packages, node 0 joined to 300
    others in both directions (a hub row and column)."""
    out = []
    for fm, sy, pa in ((formats, synthetic, partition),
                       (jformats, jsynthetic, jpartition)):
        g = sy.powerlaw_community(n_nodes=600, d_feat=8, avg_degree=10,
                                  seed=0)
        others = np.arange(1, 301, dtype=g.edge_index.dtype)
        extra = np.stack([np.concatenate([others, 0 * others]),
                          np.concatenate([0 * others, others])])
        g = dataclasses.replace(g, edge_index=np.concatenate(
            [g.edge_index, extra], axis=1))
        g, ew = fm.gcn_normalize(g)
        out.append(pa.partition_graph(g, 4, method="skewed", edge_weight=ew,
                                      layout=layout))
    return out


@pytest.fixture(scope="module", params=["dense", "compact"])
def blocks(request):
    pg, jpg = _skewed(request.param)
    blk, jblk = TB.build_block(pg), JB.build_block(jpg)
    assert blk.csr.long_rows.numel() and blk.csr_t.long_rows.numel()
    assert int(torch.diff(blk.csr.row_ptr).max()) > 2 * SEGMENT
    assert (~pg.node_mask).any()                        # padding rows
    return pg, blk, jblk


def _inputs(pg, seed):
    rng = np.random.default_rng(seed)
    p, n_ext = pg.plan.n_parts, pg.plan.n_local + pg.plan.halo_rows
    return (rng.normal(0, 1, (p, n_ext, H * DH)).astype(np.float32),
            rng.normal(0, 1, (p, n_ext, H)).astype(np.float32),
            rng.normal(0, 1, (p, pg.plan.n_local, H)).astype(np.float32),
            rng.normal(0, 1, (p, pg.plan.n_local, H * DH)).astype(np.float32))


def _csr_order(pg) -> tuple[np.ndarray, np.ndarray]:
    """(partition, edge slot) of every forward CSR position."""
    p_idx, e_idx = np.nonzero(pg.edge_mask)
    dst = pg.edges[p_idx, e_idx, 1] + p_idx * pg.plan.n_local
    order = np.argsort(dst, kind="stable")
    return p_idx[order], e_idx[order]


def _jax_alpha(jblk, s_src, s_dst):
    score = jax.nn.leaky_relu(JB.gather_src(jblk, s_src)
                              + JB.gather_dst(jblk, s_dst), 0.2)
    return JB.edge_softmax(jblk, score)


def _jax_gat(jblk):
    """The reference's GAT aggregation (models.py:131-142) of a table."""
    def f(table, s_src, s_dst):
        alpha = _jax_alpha(jblk, s_src, s_dst)
        v = JB.gather_src(jblk, table).reshape(alpha.shape[:2] + (H, DH))
        msg = (alpha[..., None] * v).reshape(alpha.shape[:2] + (H * DH,))
        return JB.agg_sum(jblk, msg)
    return f


def test_softmax_matches_jax_edge_softmax(blocks):
    pg, blk, jblk = blocks
    _, s_src, s_dst, _ = _inputs(pg, 0)
    for mine, ref, a in ((TB.gather_src, JB.gather_src, s_src),
                         (TB.gather_dst, JB.gather_dst, s_dst)):
        np.testing.assert_array_equal(mine(blk, torch.from_numpy(a)).numpy(),
                                      np.asarray(ref(jblk, a)))
    want = np.asarray(jax.jit(lambda a, b: _jax_alpha(jblk, a, b))(
        s_src, s_dst))
    got = gops.softmax(torch.from_numpy(s_src.reshape(-1, H)),
                       torch.from_numpy(s_dst.reshape(-1, H)), blk.csr)
    np.testing.assert_allclose(got.numpy(), want[_csr_order(pg)], rtol=1e-6,
                               atol=1e-7)


def test_gat_aggregate_value_and_vjp_match_jax(blocks, monkeypatch):
    """Also: the backward gathers no transposed copy of alpha
    (``torch.index_select`` raises), but hands the per-head SpMM over
    ``csr_t`` the forward's alpha itself with ``w_idx = perm_t``."""
    pg, blk, jblk = blocks
    table, s_src, s_dst, ct = _inputs(pg, 1)

    def run(args, ct):
        out, vjp = jax.vjp(_jax_gat(jblk), *args)
        return out, vjp(ct)
    want, want_grads = jax.jit(run)(tuple(jnp.asarray(a) for a in (
        table, s_src, s_dst)), jnp.asarray(ct))

    def no_gather(*args, **kwargs):
        raise AssertionError("the GAT step gathers with torch.index_select")
    calls, real = [], TB.spmm_heads

    def spmm_heads(table, csr, w, w_idx=None):
        calls.append((csr, w, w_idx))
        return real(table, csr, w, w_idx)
    monkeypatch.setattr(torch, "index_select", no_gather)
    monkeypatch.setattr(TB, "spmm_heads", spmm_heads)
    args = [torch.from_numpy(a).requires_grad_() for a in (table, s_src,
                                                          s_dst)]
    got = TB.gat_aggregate(blk, *args)
    grads = torch.autograd.grad(got, args, torch.from_numpy(ct))
    (fwd_csr, alpha, fwd_idx), (bwd_csr, bwd_w, bwd_idx) = calls
    assert fwd_csr is blk.csr and fwd_idx is None
    assert bwd_csr is blk.csr_t and bwd_idx is blk.perm_t
    assert bwd_w is alpha                          # forward order, no copy
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=2e-5)
    pad = ~pg.node_mask
    assert not got.detach().numpy()[pad].any()
    assert not grads[2].numpy()[pad].any()


def _small_csr():
    """12 rows (one of 300 edges: 3 segments; empty rows) over 30 sources."""
    rng = np.random.default_rng(3)
    dst = np.concatenate([np.full(300, 4), rng.integers(0, 12, 60)])
    dst = dst[(dst != 7) & (dst != 9)]                     # two empty rows
    src = rng.integers(0, 30, dst.size)
    return csr_from_edges(src, dst, np.ones(dst.size), 12, 30), rng


def _loop_rows(csr, value, reduce):
    """``reduce`` over each row's edges, in CSR order, a row of more than
    SEGMENT edges by segments from 0 whose partials combine left to
    right."""
    rp = csr.row_ptr.numpy()
    out = []
    for r in range(csr.n_rows):
        parts = []
        for s0 in range(rp[r], rp[r + 1], SEGMENT):
            acc = None
            for e in range(s0, min(s0 + SEGMENT, rp[r + 1])):
                acc = value(e, r) if acc is None else reduce(acc, value(e, r))
            parts.append(acc)
        tot = parts[0] if parts else None
        for p in parts[1:]:
            tot = reduce(tot, p)
        out.append(tot)
    return out


def _hub_csr():
    """Rows of 1,300 edges (11 segments, more than the 8 a hub-row block of
    the CUDA kernels once walked), 0, 1, 128 (one whole unit) and 129 (two
    segments) edges, then 40 short rows, over 50 sources; each row's edges
    in a random order of sources."""
    rng = np.random.default_rng(5)
    lengths = np.concatenate([[1300, 0, 1, 128, 129], rng.integers(0, 40, 40)])
    dst = np.repeat(np.arange(lengths.size), lengths)
    src = rng.integers(0, 50, dst.size)
    return csr_from_edges(src, dst, np.ones(dst.size), lengths.size, 50), rng


@pytest.mark.parametrize("n_heads", [1, 4, 8])
@pytest.mark.parametrize("make_csr,long_rows", [(_small_csr, [4]),
                                                (_hub_csr, [0, 4])],
                         ids=["small", "hub"])
def test_plain_versions_reduce_in_csr_order(make_csr, long_rows, n_heads):
    """The order the CUDA kernels keep, bit for bit: softmax, softmax_bwd,
    row_sums_t (over the CSR, a random edge permutation standing for
    perm_t) and the SDDMM against explicit loops over each row's edges, a
    row of more than SEGMENT edges by segments whose partials combine left
    to right."""
    csr, rng = make_csr()
    assert csr.long_rows.tolist() == long_rows
    h, n_rows = n_heads, csr.n_rows
    s_src = torch.from_numpy(rng.normal(0, 1, (csr.n_cols, h)).astype(
        np.float32))
    s_dst = torch.from_numpy(rng.normal(0, 1, (n_rows, h)).astype(
        np.float32))
    col, rows = csr.col.long(), gref.edge_rows(csr)
    x = s_src[col] + s_dst[rows]
    score = torch.where(x >= 0, x, 0.2 * x)
    m = _loop_rows(csr, lambda e, r: score[e], torch.maximum)
    m = torch.stack([t if t is not None else torch.zeros(h) for t in m])
    ex = gref.exp_rounded(score - m[rows])   # exp as the plain version takes it
    z = _loop_rows(csr, lambda e, r: ex[e], torch.add)
    alpha = gops.softmax(s_src, s_dst, csr)
    for e, r in enumerate(rows.tolist()):
        assert torch.equal(alpha[e], ex[e] / torch.clamp(z[r], min=1e-16))

    dalpha = torch.from_numpy(rng.normal(0, 1, alpha.shape).astype(
        np.float32))
    dx, ds_dst = gops.softmax_bwd(alpha, dalpha, s_src, s_dst, csr)
    c = _loop_rows(csr, lambda e, r: alpha[e] * dalpha[e], torch.add)
    for e, r in enumerate(rows.tolist()):
        d = alpha[e] * (dalpha[e] - c[r])
        assert torch.equal(dx[e], torch.where(x[e] < 0, 0.2 * d, d))
    want = _loop_rows(csr, lambda e, r: dx[e], torch.add)
    for r in range(n_rows):
        assert torch.equal(ds_dst[r], want[r] if want[r] is not None
                           else torch.zeros(h))

    perm = torch.from_numpy(rng.permutation(csr.nnz).astype(np.int32))
    got = gops.row_sums_t(dx, csr, perm)
    want = _loop_rows(csr, lambda e, r: dx[perm[e]], torch.add)
    for r in range(n_rows):
        assert torch.equal(got[r], want[r] if want[r] is not None
                           else torch.zeros(h))

    g = torch.from_numpy(rng.normal(0, 1, (n_rows, h * DH)).astype(
        np.float32))
    table = torch.from_numpy(rng.normal(0, 1, (csr.n_cols, h * DH)).astype(
        np.float32))
    da = gops.sddmm_heads(g, table, csr, h)
    for e, r in enumerate(rows.tolist()):
        for k in range(h):
            acc = torch.zeros(())
            for i in range(DH):
                acc = acc + g[r, k * DH + i] * table[col[e], k * DH + i]
            assert torch.equal(da[e, k], acc)


def test_row_sums_over_the_transposed_csr(blocks):
    """``row_sums_t`` of per-edge values given in forward order: bit for bit
    the plan-ordered loop over the transposed CSR of ``vals[perm_t]``; and
    ``perm_t`` takes each transposed edge to the forward edge of the same
    (source, destination)."""
    pg, blk, jblk = blocks
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(rng.normal(0, 1, (blk.csr.nnz, H)).astype(
        np.float32))
    got = gops.row_sums_t(vals, blk.csr_t, blk.perm_t)
    perm = blk.perm_t.long()
    want = _loop_rows(blk.csr_t, lambda e, r: vals[perm[e]], torch.add)
    for r, w in enumerate(want):
        assert torch.equal(got[r], w if w is not None else torch.zeros(H))
    fwd_dst = gref.edge_rows(blk.csr)
    t_src = gref.edge_rows(blk.csr_t)
    assert torch.equal(blk.csr.col.long()[perm], t_src)
    assert torch.equal(fwd_dst[perm], blk.csr_t.col.long())


def test_spmm_heads_is_spmm_per_head():
    csr, rng = _small_csr()
    table = torch.from_numpy(rng.normal(0, 1, (30, H * DH)).astype(
        np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (csr.nnz, H)).astype(np.float32))
    one = sops.spmm_heads(table, csr, w[:, :1].contiguous())
    assert torch.equal(one, spmm_ref(table, dataclasses.replace(
        csr, w=w[:, 0].contiguous())))
    got = sops.spmm_heads(table, csr, w)
    for h in range(H):
        per = spmm_ref(table[:, h * DH:(h + 1) * DH].contiguous(),
                       dataclasses.replace(csr, w=w[:, h].contiguous()))
        assert torch.equal(got[:, h * DH:(h + 1) * DH], per)
    with pytest.raises(ValueError):
        sops.spmm_heads(table, csr, torch.ones((csr.nnz, 5)))  # 5 ∤ 12


def _small_csr_pair():
    """``_small_csr``'s edges as a forward CSR (a 300-edge hub row of 3
    segments, two empty rows), its transpose and ``perm_t``."""
    rng = np.random.default_rng(3)
    dst = np.concatenate([np.full(300, 4), rng.integers(0, 12, 60)])
    dst = dst[(dst != 7) & (dst != 9)]
    src = rng.integers(0, 30, dst.size)
    w = np.ones(dst.size)
    return (csr_from_edges(src, dst, w, 12, 30),
            csr_from_edges(dst, src, w, 30, 12),
            torch.from_numpy(TB.transpose_perm(src, dst)), rng)


@pytest.mark.parametrize("which", ["forward", "transposed"])
def test_spmm_heads_reads_w_through_w_idx(which):
    """``spmm_heads(table, csr, w, w_idx)`` equals ``spmm_heads(table, csr,
    w[w_idx])`` bit for bit, the plain version and the wrapper alike: over
    the transposed CSR with ``perm_t`` (GAT's backward), and over the
    forward CSR (its hub row split into 3 segments, its empty rows) with an
    index that repeats rows of a ``w`` longer than nnz."""
    csr, csr_t, perm_t, rng = _small_csr_pair()
    assert csr_t.col.tolist() == gref.edge_rows(csr)[perm_t.long()].tolist()
    if which == "transposed":
        csr, w_idx = csr_t, perm_t
        w = torch.from_numpy(rng.normal(0, 1, (csr.nnz, H)).astype(
            np.float32))
    else:
        assert csr.long_rows.tolist() == [4] and csr.n_partials == 3
        assert (torch.diff(csr.row_ptr) == 0).sum() == 2
        w = torch.from_numpy(rng.normal(0, 1, (csr.nnz + 50, H)).astype(
            np.float32))
        w_idx = torch.from_numpy(rng.integers(0, w.shape[0], csr.nnz).astype(
            np.int32))
    table = torch.from_numpy(rng.normal(0, 1, (csr.n_cols, H * DH)).astype(
        np.float32))
    want = sref.spmm_heads_ref(table, csr, w[w_idx.long()])
    assert torch.equal(sref.spmm_heads_ref(table, csr, w, w_idx=w_idx), want)
    assert torch.equal(sops.spmm_heads(table, csr, w, w_idx=w_idx), want)


def test_spmm_heads_reads_alpha_through_perm_t_over_the_stack(blocks):
    """The same over the stacked block's transposed CSR (hub rows split)."""
    pg, blk, _ = blocks
    assert blk.csr_t.long_rows.numel()
    rng = np.random.default_rng(5)
    alpha = torch.from_numpy(rng.normal(0, 1, (blk.csr.nnz, H)).astype(
        np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (blk.csr_t.n_cols, H * DH)).astype(
        np.float32))
    assert torch.equal(
        sops.spmm_heads(g, blk.csr_t, alpha, w_idx=blk.perm_t),
        sref.spmm_heads_ref(g, blk.csr_t, alpha[blk.perm_t.long()]))


def test_spmm_heads_refuses_a_bad_w_idx():
    csr, csr_t, perm_t, rng = _small_csr_pair()
    table = torch.zeros((csr_t.n_cols, H * DH))
    w = torch.zeros((csr.nnz, H))
    for bad in (perm_t[:-1], perm_t.long(), perm_t.float(),
                torch.zeros(csr.nnz, dtype=torch.int32, device="meta"),
                torch.zeros((csr.nnz, 2), dtype=torch.int32)[:, 0]):
        with pytest.raises(ValueError, match="w_idx"):
            sops.spmm_heads(table, csr_t, w, w_idx=bad)
    with pytest.raises(ValueError, match="w must be"):   # w_idx's rows of w
        sops.spmm_heads(table, csr_t, torch.zeros((csr.nnz, 5)),
                        w_idx=perm_t)


@pytest.mark.parametrize("dh", [3, 16, 64])
def test_sddmm_heads_ref_sums_in_k_order(dh):
    """``sddmm_heads_ref`` (the plain version the card's staged kernel is
    held to bit for bit) against an explicit float32 loop over k, edge by
    edge and head by head, each product rounded before its add; the hub
    row's segments and the empty rows included."""
    csr, _ = _small_csr()
    rng = np.random.default_rng(dh)
    g = rng.normal(0, 1, (12, H * dh)).astype(np.float32)
    table = rng.normal(0, 1, (30, H * dh)).astype(np.float32)
    got = gops.sddmm_heads(torch.from_numpy(g), torch.from_numpy(table), csr,
                           H).numpy()
    col, rows = csr.col.numpy(), gref.edge_rows(csr).numpy()
    want = np.empty((csr.nnz, H), np.float32)
    for e in range(csr.nnz):
        for h in range(H):
            gr = g[rows[e], h * dh:(h + 1) * dh].tolist()
            tr = table[col[e], h * dh:(h + 1) * dh].tolist()
            acc = np.float32(0)
            for a, b in zip(gr, tr):
                acc = np.float32(acc + np.float32(np.float32(a)
                                                  * np.float32(b)))
            want[e, h] = acc
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_split_plan_segments_the_hub_row_as_the_kernels_read_it():
    """The hub kernels walk a split row's segments from ``row_ptr`` and
    ``SEGMENT``; the plan's units must be exactly those segments."""
    csr, _ = _small_csr()
    units, long_rows, long_ptr, _ = split_plan(csr.row_ptr.numpy())
    r, rp = int(long_rows[0]), csr.row_ptr.numpy()
    segs = units[units[:, 2] >= csr.n_rows].numpy()
    want = [(s, min(s + SEGMENT, rp[r + 1]), csr.n_rows + k)
            for k, s in enumerate(range(rp[r], rp[r + 1], SEGMENT))]
    assert [tuple(u) for u in segs] == want
    assert long_ptr.tolist() == [0, len(want)]


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    csr, _ = _small_csr()
    meta = torch.empty((30, H), device="meta")
    with pytest.raises(ValueError):
        gops.softmax(meta, torch.empty((12, H), device="meta"), csr)
    with pytest.raises(ValueError):
        gops.sddmm_heads(torch.empty((12, H * DH), device="meta"),
                         torch.empty((30, H * DH), device="meta"), csr, H)
    with pytest.raises(ValueError):
        gops.row_sums_t(torch.empty((csr.nnz, H), device="meta"), csr,
                        torch.zeros(csr.nnz, dtype=torch.int32))
