"""PNA, MeshGraphNet, SchNet and NequIP of the port against the JAX
reference, on the CPU.

The same numpy graphs and the JAX parameters (``model.init``, carried in by
``params_from_numpy``) go to both packages; the JAX side runs as
``tests/test_arch_smoke.py`` runs it. Graphs: the smoke tiers the reference
trains these models on (``yelp_like`` for PNA, ``mesh_like`` for
MeshGraphNet, ``molecule_like`` for SchNet and NequIP; 4 partitions,
self-loops, edge geometry for the last three), ``molecules(n_nodes=40)``
with self-loops, and a graph of rows of 0, 1, 128, 129 and 1,300 edges (two
partitions). NequIP's own cases (``so3``, the tensor product, rotations,
its integer-keyed tree) are in ``tests/test_torch_nequip.py``.

* The generators, both registry workloads, ``geometry_edge_attr`` and
  ``real_sh_np`` equal the reference's array for array.
* The edge CSRs (``ecsr``, ``ecsr_t``) of one rank's block (``part=p``)
  are the stack's rows of partition ``p``; every sum over them
  (``agg_sum``; the gradients of ``gather_src`` / ``gather_dst``) is bit
  for bit an explicit loop in CSR order with the split plan, and within
  1e-6 of ``jax.ops.segment_sum`` (relative to each row's sum of |terms|:
  float32 sums in another order).
* ``seg_max_ref`` and the fused ``seg_max_min_ref`` (through ``agg_max``
  / ``agg_min``, the halves of ``agg_max_min``) and their backward are
  equal to ``jax.ops.segment_max`` and ``jax.vjp`` (signed zeros compare
  equal), on ReLU'd messages with ties of 2, 3 and 7 and on empty rows,
  whatever the split plan; ``agg_max_min``'s VJP within rtol 1e-6 of
  ``jax.vjp`` of the pair. ``seg_max_min_ref`` is bit for bit
  ``seg_max_ref`` and ``-seg_max_ref(-msgs)`` (±0 ties, a NaN, -0 on empty
  rows) under plans of 1, 7, 64 and 128 edges, and ``seg_max_min_vjp_ref``
  bit for bit the autograd chain of the separate max and ``-max(-msgs)``;
  ``agg_std`` and its VJP, at rows where ``mu2 - mu*mu == 0``, within 1e-6
  of the reference's.
* Each model, reduced: logits at 32 bits (rtol 1e-5) and at 1 bit
  deterministic (rtol 1e-4); the full config's logits at 32 bits; one sync
  and one async step (loss 1e-5, parameters 1e-4); 10 epochs of
  ``GNNTrainer``, vanilla (losses 1e-5), Sylvie-S and Sylvie-A at 1 bit
  (1e-4; PNA's epoch by epoch from JAX's state, ``LOCKSTEP``); the plain
  versions' calls per step of the full configs, which
  ``chip_smoke.ZOO_LAUNCHES`` holds the card to.
* ``python -m repro_torch.launch.train --arch
  pna|meshgraphnet|schnet|nequip --reduced ... --device cpu`` trains, and
  raises without a card otherwise.
* One rank's block (``part=p``, as ``GNNTrainer`` builds it under a sharded
  runtime) runs PNA's, MeshGraphNet's and NequIP's forward to its rows of
  the simulated stack's, given the stack's halos.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import datasets as jdatasets
from repro.core.sylvie import SylvieComm as JComm
from repro.core.sylvie import SylvieConfig as JConfig
from repro.graph import formats as jformats
from repro.graph import partition as jpartition
from repro.graph import synthetic as jsynthetic
from repro.models import nn as jnn
from repro.models.gnn import blocks as JB
from repro.models.gnn import so3 as jso3
from repro.policy import builtin as jpol
from repro.train import checkpoint as jckpt
from repro.train import gnn_step as jstep
from repro.train import optimizer as jopt
from repro.train.trainer import GNNTrainer as JTrainer
from repro_torch import configs, datasets
from repro_torch.core.sylvie import SylvieComm, SylvieConfig
from repro_torch.dist.runtime import Runtime
from repro_torch.graph import formats, partition, synthetic
from repro_torch.kernels.quant import ref as qref
from repro_torch.kernels.seg import ops as segops
from repro_torch.kernels.seg import ref as segref
from repro_torch.kernels.spmm import ref as sref
from repro_torch.launch import train as launch
from repro_torch.models import nn as tnn
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.gnn import blocks as B
from repro_torch.models.gnn import so3
from repro_torch.policy import builtin as tpol
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import gnn_step as tstep
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import GNNTrainer

P = 4
CPU = Runtime.simulated(P, device="cpu")
GRAPHS = {"pna": "yelp_like@smoke", "meshgraphnet": "mesh_like@smoke",
          "schnet": "molecule_like@smoke", "nequip": "molecule_like@smoke"}
ZOO = tuple(GRAPHS)
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many tiny torch ops: one thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_graph(arch, ref: str, parts: int = P):
    """The reference's ``train_gnn`` graph of ``arch`` on ``ref``."""
    g = jdatasets.load(ref)
    g, ew = jformats.gcn_normalize(g)
    if arch.d_edge_attr:
        if g.pos is None:
            g.pos = np.random.default_rng(0).normal(
                0, 1, (g.n_nodes, 3)).astype(np.float32)
        g.edge_attr = JB.geometry_edge_attr(g)
    return jpartition.partition_graph(g, parts, edge_weight=ew)


@pytest.fixture(scope="module")
def zoo():
    """arch -> (port graph, JAX graph) of the reduced config."""
    return {name: (launch.gnn_graph(configs.get(name).reduced(), ref, P),
                   _jax_graph(jconfigs.get(name).reduced(), ref))
            for name, ref in GRAPHS.items()}


def _models(name, pg, which="reduced"):
    dims = (pg.x.shape[-1], pg.n_classes)
    return (getattr(configs.get(name), which)().make(*dims),
            getattr(jconfigs.get(name), which)().make(*dims))


def _jparams(jmodel, seed=0):
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# generators, workloads, geometry
# ---------------------------------------------------------------------------
def _assert_graphs_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("case", [
    ("grid", dict(nx=5, ny=7, d_feat=3, seed=2)),
    ("molecule", dict(n_nodes=40, seed=1)),
    "mesh_like@smoke", "mesh_like@paper", "molecule_like@smoke",
    "molecule_like@small", "molecule_like@paper"])
def test_generators_and_workloads_equal_the_reference(case):
    if isinstance(case, str):
        _assert_graphs_equal(datasets.load(case), jdatasets.load(case))
    else:
        name, kw = case
        _assert_graphs_equal(synthetic.by_name(name, **kw),
                             jsynthetic.by_name(name, **kw))


def test_geometry_and_sh_equal_the_reference(zoo):
    rng = np.random.default_rng(0)
    v = rng.normal(0, 1, (500, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    for l_max in (0, 1, 2):
        for vec in (v, v.astype(np.float32)):
            np.testing.assert_array_equal(so3.real_sh_np(vec, l_max),
                                          jso3.real_sh_np(vec, l_max))
    # the reference's smoke graph: molecules(40) with self-loops
    graphs = []
    for fm, sy in ((formats, synthetic), (jformats, jsynthetic)):
        g = sy.molecules(n_nodes=40, d_feat=8, seed=1)
        ei = fm.add_self_loops(g.edge_index, g.n_nodes)
        graphs.append(dataclasses.replace(g, edge_index=ei))
    a, b = B.geometry_edge_attr(graphs[0]), JB.geometry_edge_attr(graphs[1])
    assert a.dtype == b.dtype == np.float32 and a.shape[1] == 13
    np.testing.assert_array_equal(a, b)
    for name in ("meshgraphnet", "schnet"):        # through gnn_graph
        pg, jpg = zoo[name]
        np.testing.assert_array_equal(pg.edge_attr, jpg.edge_attr)
        np.testing.assert_array_equal(pg.edges, jpg.edges)


# ---------------------------------------------------------------------------
# the edge CSRs and the sums over them
# ---------------------------------------------------------------------------
# destination node -> in-degree; node 5 sends 1,300 edges (a hub row of
# ecsr_t); every other node receives 2 random edges
HUB_ROWS = {0: 0, 1: 1, 2: 128, 3: 129, 4: 1300}
HUB_N = 2000


def _hub_graphs():
    rng = np.random.default_rng(0)
    src, dst = [], []
    for v in range(HUB_N):
        k = HUB_ROWS.get(v, 2)
        s = rng.choice(np.delete(np.arange(HUB_N), v), k, replace=False)
        src.append(s)
        dst.append(np.full(k, v))
    out = rng.choice(np.arange(10, HUB_N), 1300, replace=False)
    src.append(np.full(out.size, 5))
    dst.append(out)
    ei = np.stack([np.concatenate(src), np.concatenate(dst)]).astype(
        np.int32)
    x = rng.normal(0, 1, (HUB_N, 4)).astype(np.float32)
    y = np.zeros(HUB_N, np.int32)
    m = np.ones(HUB_N, bool)
    return [pa.partition_graph(fm.Graph(HUB_N, ei, x, y, m, m, m,
                                        n_classes=2), 2)
            for fm, pa in ((formats, partition), (jformats, jpartition))]


@pytest.fixture(scope="module")
def hubs():
    pg, jpg = _hub_graphs()
    return pg, jpg, B.build_block(pg, "cpu"), JB.build_block(jpg)


def _csr_loop(csr, msgs: np.ndarray) -> np.ndarray:
    """Row sums of ``msgs[col[e]]`` in CSR order, as the split plan cuts
    them: rows of up to SEGMENT edges from 0, edge by edge; longer rows by
    SEGMENT-edge segments from 0, the partials added left to right."""
    row_ptr, col = csr.row_ptr.numpy(), csr.col.numpy()
    out = np.zeros((csr.n_rows, msgs.shape[1]), np.float32)
    for r in range(csr.n_rows):
        e0, e1 = int(row_ptr[r]), int(row_ptr[r + 1])
        parts = []
        for s0 in range(e0, max(e1, e0 + 1), sref.SEGMENT):
            acc = np.zeros(msgs.shape[1], np.float32)
            for e in range(s0, min(s0 + sref.SEGMENT, e1)):
                acc = acc + msgs[col[e]]
            parts.append(acc)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        out[r] = acc
    return out


def test_edge_sums_are_the_csr_order_loop_and_jax_segment_sum(hubs):
    pg, jpg, blk, jblk = hubs
    deg = np.diff(blk.ecsr.row_ptr.numpy())
    for want in (0, 1, 128, 129, 1300):
        assert want in deg
    # node 5's 1,300 out-edges: a hub row of ecsr_t in either partition
    assert np.diff(blk.ecsr_t.row_ptr.numpy()).max() > 4 * sref.SEGMENT
    assert blk.ecsr.long_rows.numel() and blk.ecsr_t.long_rows.numel()
    rng = np.random.default_rng(1)
    p, e_pad = pg.edge_mask.shape
    n_ext = pg.plan.n_local + pg.plan.halo_rows
    d = 5
    msgs = rng.normal(0, 1, (p, e_pad, d)).astype(np.float32)
    table = rng.normal(0, 1, (p, n_ext, d)).astype(np.float32)
    h = rng.normal(0, 1, (p, pg.plan.n_local, d)).astype(np.float32)
    g = rng.normal(0, 1, (p, e_pad, d)).astype(np.float32)
    def close(got, want, csr, terms):
        """Within 1e-6 of each row's sum of |terms|: float32 sums of the
        same terms in another order (a 1,300-edge row's differ by ~1e-5)."""
        scale = _csr_loop(csr, np.abs(terms.reshape(-1, d)))
        assert (np.abs(got - want).reshape(-1, d) <= 1e-6 * scale).all()

    flat = msgs.reshape(-1, d)
    got = B.agg_sum(blk, torch.from_numpy(msgs)).numpy()
    np.testing.assert_array_equal(got.reshape(-1, d),
                                  _csr_loop(blk.ecsr, flat))
    close(got, np.asarray(JB.agg_sum(jblk, msgs)), blk.ecsr, msgs)
    for fn, jfn, x, csr in ((B.gather_src, JB.gather_src, table, blk.ecsr_t),
                            (B.gather_dst, JB.gather_dst, h, blk.ecsr)):
        xt = torch.from_numpy(x).requires_grad_()
        out = fn(blk, xt)
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(jfn(jblk, x)))
        (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
        # padded edges' messages feed no aggregation: their gradients are 0
        gm = np.where(pg.edge_mask[..., None], g, 0).astype(np.float32)
        np.testing.assert_array_equal(dx.numpy().reshape(-1, d),
                                      _csr_loop(csr, gm.reshape(-1, d)))
        _, vjp = jax.vjp(lambda a: jfn(jblk, a), jnp.asarray(x))
        close(dx.numpy(), np.asarray(vjp(gm)[0]), csr, gm)
    # agg_sum's backward: g[dst] on real edges, 0 on padded ones
    mt = torch.from_numpy(msgs).requires_grad_()
    gs = rng.normal(0, 1, (p, pg.plan.n_local, d)).astype(np.float32)
    (dm,) = torch.autograd.grad(B.agg_sum(blk, mt), mt, torch.from_numpy(gs))
    _, vjp = jax.vjp(lambda a: JB.agg_sum(jblk, a), jnp.asarray(msgs))
    np.testing.assert_array_equal(dm.numpy(), np.asarray(vjp(gs)[0]))


def test_edge_csrs_of_one_rank_are_the_stacks_rows(zoo, hubs):
    for pg in (zoo["pna"][0], zoo["meshgraphnet"][0], hubs[0]):
        whole = B.build_block(pg, "cpu")
        p_all, e_pad = pg.edge_mask.shape
        n_ext = pg.plan.n_local + pg.plan.halo_rows
        for name, rows_per_part in (("ecsr", pg.plan.n_local),
                                    ("ecsr_t", n_ext)):
            full = getattr(whole, name)
            assert full.n_cols == p_all * e_pad
            ptr, col = full.row_ptr.numpy(), full.col.numpy()
            for p in range(p_all):
                mine = getattr(B.build_block(pg, "cpu", part=p), name)
                r0, r1 = p * rows_per_part, (p + 1) * rows_per_part
                np.testing.assert_array_equal(
                    mine.row_ptr.numpy(), ptr[r0:r1 + 1] - ptr[r0])
                np.testing.assert_array_equal(
                    mine.col.numpy(), col[ptr[r0]:ptr[r1]] - p * e_pad)
                assert mine.n_cols == e_pad and mine.n_rows == rows_per_part
                assert torch.equal(mine.w, torch.ones(mine.nnz))
        # ecsr_t reads ecsr's columns through perm_t
        np.testing.assert_array_equal(
            whole.ecsr_t.col.numpy(),
            whole.ecsr.col.numpy()[whole.perm_t.numpy()])
        if pg.edge_attr is not None:
            one = B.build_block(pg, "cpu", part=1)
            assert torch.equal(one.edge_attr, whole.edge_attr[1:2])


# ---------------------------------------------------------------------------
# max, min, std
# ---------------------------------------------------------------------------
def _tied_msgs(pg, d=6, seed=2) -> np.ndarray:
    """ReLU'd messages on a coarse grid (ties everywhere, zero rows), with
    ties of exactly 2, 3 and 7 at a row's maximum planted."""
    rng = np.random.default_rng(seed)
    p, e_pad = pg.edge_mask.shape
    msgs = np.maximum(np.round(rng.normal(0, 1, (p, e_pad, d)) * 2) / 2, 0)
    msgs = msgs.astype(np.float32)
    dst = pg.edges[..., 1] + np.arange(p)[:, None] * pg.plan.n_local
    real = pg.edge_mask
    for col, (node, ties) in enumerate(((2, 2), (3, 3), (4, 7))):
        part, slot = np.argwhere(pg.global_ids == node)[0]
        where = np.nonzero(real & (dst == slot + part * pg.plan.n_local))
        assert where[0].size >= ties
        msgs[where[0], where[1], col] = np.minimum(
            msgs[where[0], where[1], col], 4.0)
        msgs[where[0][:ties], where[1][:ties], col] = 9.0
    return msgs


def test_seg_max_and_its_vjp_equal_jax_segment_max(hubs):
    pg, jpg, blk, jblk = hubs
    msgs = _tied_msgs(pg)
    g = np.random.default_rng(3).normal(
        0, 1, (pg.edge_mask.shape[0], pg.plan.n_local, msgs.shape[-1])
    ).astype(np.float32)
    _, counts = segref.seg_max_ref(torch.from_numpy(msgs.reshape(
        -1, msgs.shape[-1])), blk.ecsr)
    for ties in (0, 1, 2, 3, 7):
        assert (counts == ties).any(), ties
    for fn, jfn in ((B.agg_max, JB.agg_max), (B.agg_min, JB.agg_min)):
        mt = torch.from_numpy(msgs).requires_grad_()
        out = fn(blk, mt)
        jout, vjp = jax.vjp(lambda a: jfn(jblk, a), jnp.asarray(msgs))
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
        (dm,) = torch.autograd.grad(out, mt, torch.from_numpy(g))
        np.testing.assert_array_equal(dm.numpy(), np.asarray(vjp(g)[0]))
    # the result does not depend on the split plan
    flat = torch.from_numpy(msgs.reshape(-1, msgs.shape[-1]))
    want = segref.seg_max_ref(flat, blk.ecsr)
    for seg in (1, 7, 64):
        for a, b in zip(segref.seg_max_ref(flat, _replan(blk.ecsr, seg)),
                        want):
            assert torch.equal(a, b)


def _replan(csr, segment: int):
    """``csr`` under the split plan of ``segment``-edge units."""
    return dataclasses.replace(csr, **dict(zip(
        ("units", "long_rows", "long_ptr", "n_partials"),
        sref.split_plan(csr.row_ptr.numpy(), segment))))


def _signed_tied_msgs(pg, seed: int) -> np.ndarray:
    """``_tied_msgs`` with half of its zeros made -0 (so +0 and -0 tie) and
    a NaN at one real edge."""
    msgs = _tied_msgs(pg, seed=seed)
    rng = np.random.default_rng(seed + 10)
    msgs[(msgs == 0) & (rng.random(msgs.shape) < 0.5)] = -0.0
    p, e = np.argwhere(pg.edge_mask)[7]
    msgs[p, e, 1] = np.nan
    return msgs


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("segment", (1, 7, 64, sref.SEGMENT))
def test_seg_max_min_ref_is_seg_max_ref_and_its_negation(hubs, segment):
    """Max and min from one scan, bit for bit the separate max and
    ``-max(-msgs)`` (what ``agg_min`` was) under any plan: the first of
    tied +0 / -0 in CSR order, a NaN that stays, -0 on an empty row."""
    pg, _, blk, _ = hubs
    msgs = _signed_tied_msgs(pg, seed=2)
    flat = torch.from_numpy(msgs.reshape(-1, msgs.shape[-1]))
    mx, cmx, mn, cmn = segref.seg_max_min_ref(flat, _replan(blk.ecsr,
                                                            segment))
    want_mx, want_cmx = segref.seg_max_ref(flat, blk.ecsr)
    neg_mx, neg_cmx = segref.seg_max_ref(-flat, blk.ecsr)
    assert torch.equal(_bits(mx), _bits(want_mx))
    assert torch.equal(_bits(mn), _bits(-neg_mx))
    assert torch.equal(cmx, want_cmx) and torch.equal(cmn, neg_cmx)
    assert cmx.dtype == cmn.dtype == torch.int32
    empty = torch.from_numpy(np.diff(blk.ecsr.row_ptr.numpy()) == 0)
    assert empty.any()
    assert (_bits(mx[empty]) == _bits(torch.tensor(0.0))).all()
    assert (_bits(mn[empty]) == _bits(torch.tensor(-0.0))).all()
    assert (cmx[empty] == 0).all() and (cmn[empty] == 0).all()
    # both zeros won a tie somewhere, and the NaN stayed
    for t in (mx[~empty], mn[~empty]):
        zero = t == 0
        assert (zero & torch.signbit(t)).any() and (zero & ~torch.signbit(
            t)).any()
    assert torch.isnan(mx).any() and torch.isnan(mn).any()


class _SegMaxBefore(torch.autograd.Function):
    """The max the port ran before the fused kernel: ``seg_max_ref``
    forward, the elementwise backward; ``agg_min`` ran it as
    ``-agg_max(-msgs)``."""

    @staticmethod
    def forward(ctx, msgs, block):
        out, count = segref.seg_max_ref(msgs, block.ecsr)
        ctx.block = block
        ctx.save_for_backward(msgs, out, count)
        return out

    @staticmethod
    def backward(ctx, g):
        msgs, out, count = ctx.saved_tensors
        blk = ctx.block
        share = g * torch.reciprocal(count.to(g.dtype))
        hit = blk.edge_mask.reshape(-1, 1) \
            & (msgs == out.index_select(0, blk.dst_flat))
        return torch.where(hit, share.index_select(0, blk.dst_flat),
                           0.0), None


def test_seg_max_min_vjp_ref_is_the_autograd_chain_before(hubs):
    """``seg_max_min_vjp_ref`` and ``agg_max_min``'s backward, bit for bit
    the gradient through the separate max and ``-max(-msgs)`` (``-((-g) *
    r) == g * r``), with the gradients column slices of a wider one, as
    PNA's ``cat`` hands them (the gradients have no -0 entry, where the two
    could differ in the sign of a zero); padded edges get 0."""
    pg, _, blk, _ = hubs
    msgs = _signed_tied_msgs(pg, seed=6)
    d = msgs.shape[-1]
    n_rows = blk.n_parts * blk.n_local
    g = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, (n_rows, 4 * d)).astype(np.float32))
    g_max, g_min = g[:, d:2 * d], g[:, 2 * d:3 * d]
    mt = torch.from_numpy(msgs).requires_grad_()
    flat = mt.reshape(-1, d)
    (want,) = torch.autograd.grad(
        (_SegMaxBefore.apply(flat, blk), -_SegMaxBefore.apply(-flat, blk)),
        mt, (g_max, g_min))
    want = want.reshape(-1, d)
    flat = flat.detach()
    got = segref.seg_max_min_vjp_ref(
        flat, blk.ecsr, *segref.seg_max_min_ref(flat, blk.ecsr), g_max,
        g_min, blk.epad)
    assert torch.equal(_bits(got), _bits(want))
    assert (got[~blk.edge_mask.reshape(-1)] == 0).all()
    assert (got != 0).sum() > 100
    shape = (blk.n_parts, blk.n_local, d)
    (dm,) = torch.autograd.grad(B.agg_max_min(blk, mt), mt,
                                (g_max.reshape(shape), g_min.reshape(shape)))
    assert torch.equal(_bits(dm.reshape(-1, d)), _bits(want))


def test_agg_max_min_and_its_vjp_match_jax(hubs):
    """``agg_max_min``'s values equal JAX's ``agg_max`` / ``agg_min``; its
    VJP is within rtol 1e-6 (atol 0) of ``jax.vjp`` of the pair: the same
    shares of the gradient, each edge's two terms added in one order or the
    other."""
    pg, _, blk, jblk = hubs
    msgs = _tied_msgs(pg, seed=8)
    mt = torch.from_numpy(msgs).requires_grad_()
    mx, mn = B.agg_max_min(blk, mt)
    (jmx, jmn), vjp = jax.vjp(
        lambda a: (JB.agg_max(jblk, a), JB.agg_min(jblk, a)),
        jnp.asarray(msgs))
    np.testing.assert_array_equal(mx.detach().numpy(), np.asarray(jmx))
    np.testing.assert_array_equal(mn.detach().numpy(), np.asarray(jmn))
    g = np.random.default_rng(9).normal(0, 1, (2, *mx.shape)).astype(
        np.float32)
    (dm,) = torch.autograd.grad((mx, mn), mt, tuple(torch.from_numpy(g)))
    (want,) = vjp((g[0], g[1]))
    np.testing.assert_allclose(dm.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_seg_wrappers_take_the_cpu_route_and_refuse_the_rest(hubs):
    """On the CPU the wrappers are the plain versions; a tensor elsewhere
    than the CPU or a CUDA device, or a wrong shape, raises."""
    pg, _, blk, _ = hubs
    msgs = torch.from_numpy(_signed_tied_msgs(pg, seed=3).reshape(
        -1, _tied_msgs(pg).shape[-1]))
    outs = segops.seg_max_min(msgs, blk.ecsr)
    for a, b in zip(outs, segref.seg_max_min_ref(msgs, blk.ecsr)):
        assert torch.equal(_bits(a), _bits(b))
    g = torch.ones_like(outs[0])
    got = segops.seg_max_min_bwd(msgs, blk.ecsr, *outs, g, g, blk.epad)
    want = segref.seg_max_min_vjp_ref(msgs, blk.ecsr, *outs, g, g, blk.epad)
    assert torch.equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="msgs must be"):
        segops.seg_max_min(msgs[1:], blk.ecsr)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        segops.seg_max_min(msgs.to("meta"), blk.ecsr)
    with pytest.raises(ValueError, match="pad must name"):
        segops.seg_max_min_bwd(msgs, blk.ecsr, *outs, g, g, blk.epad[1:])
    with pytest.raises(ValueError, match="g_min must be"):
        segops.seg_max_min_bwd(msgs, blk.ecsr, *outs, g, g[1:], blk.epad)


def test_agg_std_and_its_vjp_at_the_tie_match_jax(hubs):
    pg, jpg, blk, jblk = hubs
    msgs = _tied_msgs(pg, seed=4)
    mt = torch.from_numpy(msgs).requires_grad_()
    mu = B.agg_mean_msgs(blk, mt)
    var = B.agg_mean_msgs(blk, mt * mt) - mu * mu
    assert int((var == 0).sum()) > 100           # one-edge and zero rows
    out = B.agg_std(blk, mt)
    jout, vjp = jax.vjp(lambda a: JB.agg_std(jblk, a), jnp.asarray(msgs))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    g = np.random.default_rng(5).normal(0, 1, out.shape).astype(np.float32)
    (dm,) = torch.autograd.grad(out, mt, torch.from_numpy(g))
    want = np.asarray(vjp(g)[0])
    np.testing.assert_allclose(dm.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_schnet_centers_and_softplus_are_jaxs():
    """The RBF centers equal ``jnp.linspace(0, cutoff, n_rbf)`` bit for bit
    (``torch.linspace`` rounds from both ends); softplus is JAX's
    ``logaddexp(x, 0)``, its gradient ``exp(x - y)``, also far past
    ``F.softplus``'s threshold of 20 and at the tie x = 0."""
    for which in ("config", "reduced"):
        model = getattr(configs.get("schnet"), which)().make(4, 2)
        want = np.asarray(jnp.linspace(0.0, model.cutoff, model.n_rbf))
        got = model.centers()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    from repro_torch.models.gnn.models import softplus
    x = np.concatenate([np.linspace(-40, 40, 801), [0.0, -0.0, 20.5, 1e-8]]
                       ).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = softplus(xt)
    (dx,) = torch.autograd.grad(y.sum(), xt)
    jy, vjp = jax.vjp(jax.nn.softplus, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(dx.numpy(), np.asarray(vjp(np.ones_like(x))[0]),
                               rtol=1e-6, atol=1e-7)
    assert float(dx[801]) == 0.5


def test_mlp_tree_and_layers_match_jax():
    """``mlp_init``'s tree and ``MLP``'s parameters are the reference's
    ``mlp_init`` tree key for key and shape for shape; ``mlp`` on the
    reference's weights equals the reference's ``mlp``, with ReLU and with
    SchNet's softplus between the layers."""
    from repro_torch.models.gnn.models import softplus
    dims = (5, 7, 3)
    jtree = jnn.mlp_init(KEY, dims)
    shapes = {k: {n: tuple(t.shape) for n, t in v.items()}
              for k, v in jtree.items()}
    tree = tnn.mlp_init(dims, torch.Generator().manual_seed(0))
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in tree.items()} == shapes
    module = tnn.MLP(dims, torch.Generator().manual_seed(0))
    assert {n: tuple(t.shape) for n, t in module.named_parameters()} == {
        f"{k}.{n}": s for k, v in shapes.items() for n, s in v.items()}
    x = np.random.default_rng(0).normal(0, 1, (9, dims[0])).astype(np.float32)
    p = {k: {n: torch.from_numpy(np.array(t)) for n, t in v.items()}
         for k, v in jtree.items()}
    for act, jact in ((torch.relu, jax.nn.relu),
                      (softplus, jax.nn.softplus)):
        np.testing.assert_allclose(
            tnn.mlp(p, torch.from_numpy(x), act).numpy(),
            np.asarray(jnn.mlp(jtree, jnp.asarray(x), jact)),
            rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
def _forward(name, pgs, bits, which="reduced"):
    pg, jpg = pgs
    model, jmodel = _models(name, pg, which)
    params = _jparams(jmodel)
    params_from_numpy(model, params)
    if bits == 32:
        cfg = dict(mode="vanilla")
    else:
        cfg = dict(mode="sync", bits=bits, stochastic=False)
    block, jblock = B.build_block(pg, "cpu"), JB.build_block(jpg)
    comm = SylvieComm(SylvieConfig(**cfg), block.plan)
    with torch.no_grad():
        out = model(block, torch.from_numpy(pg.x), comm).numpy()
    jfwd = jax.jit(lambda p, x: jmodel.apply(p, jblock, x, JComm(
        JConfig(**cfg), jblock.plan, KEY)))
    return out, np.asarray(jfwd(params, jnp.asarray(jpg.x)))


@pytest.mark.parametrize("bits", [32, 1])
@pytest.mark.parametrize("name", ZOO)
def test_forward_logits_match_jax(zoo, name, bits):
    got, want = _forward(name, zoo[name], bits)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5 if bits == 32 else 1e-4,
                               atol=1e-5 if bits == 32 else 1e-4)


@pytest.mark.parametrize("name", ZOO)
def test_full_config_forward_matches_jax(zoo, name):
    pg, jpg = launch.gnn_graph(configs.get(name).config(), GRAPHS[name], P), \
        _jax_graph(jconfigs.get(name).config(), GRAPHS[name])
    got, want = _forward(name, (pg, jpg), 32, "config")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _jax_state_in_port(jstate, example):
    """A JAX training state carried into the port through the checkpoint
    format."""
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 0, jstate)
        tree, _, needs_sync = ckpt.restore(d, example)
    assert not needs_sync
    return CPU.place(tree)


@pytest.mark.parametrize("name", ZOO)
def test_one_sync_and_one_async_step_match_jax(zoo, name):
    pg, jpg = zoo[name]
    model, jmodel = _models(name, pg)
    cfg = dict(mode="async", bits=1, stochastic=False)
    opt, jo = topt.sgd(1.0), jopt.sgd(1.0)
    jts, jta, _ = (jax.jit(f) for f in jstep.make_gnn_steps(
        jmodel, JConfig(**cfg), jo))
    ts, ta, _ = tstep.make_gnn_steps(model, SylvieConfig(**cfg), opt)
    jblock, block = JB.build_block(jpg), B.build_block(pg, "cpu")
    x, y, mask = (torch.as_tensor(a) for a in (pg.x, pg.y, pg.train_mask))
    jargs = [jnp.asarray(a) for a in (pg.x, pg.y, pg.train_mask)]
    j0 = jstep.GNNTrainState.create(jmodel, jo, KEY, jblock.plan)
    state = tstep.GNNTrainState.create(model.param_tree(), opt, block.plan,
                                       model.comm_dims())
    for i, (f, jf) in enumerate(((ts, jts), (ta, jta))):
        state = _jax_state_in_port(j0, state)
        j1, jloss = jf(j0, jblock, *jargs, KEY)
        s1, loss = f(state, block, x, y, mask, (0, i))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for a, b, a0, b0 in zip(topt.tree_leaves(s1.params),
                                jax.tree.leaves(j1.params),
                                topt.tree_leaves(state.params),
                                jax.tree.leaves(j0.params)):
            want = np.asarray(b0 - b)
            np.testing.assert_allclose((a0 - a).numpy(), want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())
        j0 = j1


CONFIGS = {
    "vanilla": (dict(mode="vanilla"), None, 1e-5),
    "sylvie_s": (dict(mode="sync", bits=1, stochastic=False),
                 lambda m: m.Uniform(bits=1, stochastic=False), 1e-4),
    "sylvie_a": (dict(mode="async", bits=1, stochastic=False),
                 lambda m: m.BoundedStaleness(eps_s=4, bits=1,
                                              stochastic=False), 1e-4),
}


def _trainers(zoo, name, run, which="reduced"):
    pg, jpg = zoo[name]
    cfg, pol, _ = CONFIGS[run]
    model, jmodel = _models(name, pg, which)
    jtr = JTrainer(jmodel, jpg, JConfig(**cfg),
                   policy=pol(jpol) if pol else None)
    tr = GNNTrainer(model, pg, SylvieConfig(**cfg),
                    policy=pol(tpol) if pol else None, runtime=CPU,
                    params=jax.tree.map(np.asarray, jtr.state.params))
    return tr, jtr


# A free 1-bit PNA run drifts from JAX's by 4e-4 to 6e-4 after one epoch
# and 4e-3 to 4.5e-2 by epoch 9 (Sylvie-A, Sylvie-S): codes whose value sits
# at a row's midpoint flip under ulp differences, and the max / min
# aggregators pass a flipped code's whole range on. Each epoch from JAX's
# state agrees within 1.8e-6.
LOCKSTEP = (("pna", "sylvie_s"), ("pna", "sylvie_a"))


@pytest.mark.parametrize("run", sorted(CONFIGS))
@pytest.mark.parametrize("name", ZOO)
def test_ten_epochs_match_jax_trainer(zoo, name, run):
    """PNA at 1 bit runs epoch by epoch from JAX's state: a free run is
    chaotic (see ``LOCKSTEP``)."""
    tr, jtr = _trainers(zoo, name, run)
    for _ in range(10):
        if (name, run) in LOCKSTEP:
            tr.state = _jax_state_in_port(jtr.state, tr.state)
        jtr.train_epoch()
        tr.train_epoch()
    got = [m.loss for m in tr.history]
    want = [m.loss for m in jtr.history]
    np.testing.assert_allclose(got, want, rtol=CONFIGS[run][2])
    assert [(m.mode, m.comm_payload_mb, m.comm_ec_mb) for m in tr.history] \
        == [(m.mode, m.comm_payload_mb, m.comm_ec_mb) for m in jtr.history]
    assert all(np.isfinite(got))
    if run == "vanilla":
        assert got[-1] < got[0]


# the plain versions of chip_smoke.ZOO_KERNELS, in its order
REFS = ((qref, "quantize_pack_ref"), (qref, "unpack_dequantize_ref"),
        (sref, "spmm_ref"), (segref, "seg_max_min_ref"),
        (segref, "seg_max_min_vjp_ref"))


@pytest.mark.parametrize("name", ZOO)
def test_training_runs_each_kernel_as_documented(name, monkeypatch):
    """Per step of the full config, on the CPU, the kernels' plain versions
    run as often as ``chip_smoke.ZOO_LAUNCHES`` holds the card to. Nothing
    on the path adds with ``index_add_``, ``scatter_add_``,
    ``scatter_reduce`` or ``torch.sparse.mm``."""
    import chip_smoke

    counts = {}
    for i, (mod, fn) in enumerate(REFS):
        real = getattr(mod, fn)

        def counted(*a, _real=real, _i=i):
            counts[_i] = counts.get(_i, 0) + 1
            return _real(*a)
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
    pg = launch.gnn_graph(configs.get(name).config(), GRAPHS[name], P)
    zoo = {name: (pg, _jax_graph(jconfigs.get(name).config(),
                                 GRAPHS[name]))}
    seen = []
    for run in sorted(CONFIGS):
        tr, _ = _trainers(zoo, name, run, "config")
        for _ in range(1 if run != "sylvie_a" else 2):
            counts.clear()
            m = tr.train_epoch()
            seen.append(((name, run, m.mode), tuple(
                counts.get(i, 0) for i in range(len(REFS)))))
    assert seen == [(k, chip_smoke.ZOO_LAUNCHES[k]) for k, _ in seen]
    assert {k for k, _ in seen} == {k for k in chip_smoke.ZOO_LAUNCHES
                                    if k[0] == name}


# ---------------------------------------------------------------------------
# the entry point and one rank's block
# ---------------------------------------------------------------------------
def test_entry_point_trains_the_zoo_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, ref in GRAPHS.items():
        argv = ["--arch", name, "--reduced", "--graph", ref, "--epochs", "2",
                "--log-every", "1", "--mode", "async", "--eps-s", "2"]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.main(argv)
        launch.main(argv + ["--device", "cpu"])
        out = capsys.readouterr().out
        assert "[sync]" in out and "[async]" in out and "test acc" in out


class _Replay:
    """A comm that hands out recorded halos (one rank's rows of each)."""

    def __init__(self, halos, rows):
        self.halos, self.rows = iter(halos), rows

    def halo(self, h):
        return next(self.halos)[self.rows]


class _Record:
    def __init__(self, comm):
        self.comm, self.halos = comm, []

    def halo(self, h):
        out = self.comm.halo(h)
        self.halos.append(out)
        return out


@pytest.mark.parametrize("name", ["pna", "meshgraphnet", "nequip"])
def test_one_ranks_block_runs_its_rows_of_the_stack(zoo, name):
    """``GNNTrainer``'s block of one rank (``part=p``): its edge CSRs and
    edge attributes give the forward that rank's rows of the simulated
    stack, bit for bit, given the stack's halos at each site."""
    pg, _ = zoo[name]
    model, jmodel = _models(name, pg)
    params_from_numpy(model, _jparams(jmodel))
    whole = B.build_block(pg, "cpu")
    rec = _Record(SylvieComm(SylvieConfig(mode="sync", bits=1,
                                          stochastic=False), whole.plan))
    x = torch.from_numpy(pg.x)
    with torch.no_grad():
        want = model(whole, x, rec)
        for p in range(P):
            one = B.build_block(pg, "cpu", part=p)
            got = model(one, x[p:p + 1], _Replay(rec.halos,
                                                 slice(p, p + 1)))
            assert torch.equal(got, want[p:p + 1]), p
