"""DLRM (the MLPerf configuration) with row-sharded embedding tables, as
``repro/models/recsys/dlrm.py`` computes it.

Plain functions on tensors and dicts of tensors:

  * the 26 tables live concatenated in one ``(total_rows, d)`` table. One
    process holds it whole (``backend=None``); under ``Runtime.sharded``
    rank ``r`` holds rows ``[r * rpd, (r + 1) * rpd)``
    (:func:`rows_per_device`) and the lookup is the model-parallel exchange
    over ``torch.distributed`` and the backend's group: the flat ids are
    all-gathered, each rank reads its own rows (0 for the others), and a
    ``psum_scatter`` sums the one non-zero contribution per row and lands
    the result batch-sharded (:func:`sylvie_embedding_exchange`; its
    backward is the all-gather of the cotangent);
  * the table's gradient is taken in a fixed order with no atomics: the
    forward read is an ``index_select``, and its backward is the SpMM
    (``kernels/spmm``) over the batch's transposed id CSR (:func:`id_plan`:
    each touched row against the positions that read it, in position
    order), whose ``(n_unique, d)`` rows are copied into a zero gradient;
  * multi-hot bags are summed over their contiguous static segments, left
    to right (:func:`bag_reduce`);
  * the dense part (bottom MLP, dot interaction, top MLP) is data-parallel:
    each rank's dense gradients are all-reduced after ``torch.autograd.grad``.

The reference's beyond-paper Sylvie tie-in is kept as it is: with
``quantize_collective_bits`` set, the exchange's forward wire is bfloat16
whenever bits <= 16, and its backward all-gather carries the bfloat16
cotangent (16 bits) or the Low-bit Module's packed payload with its bf16
scale and zero (1, 2, 4 or 8 bits; ``core/quantization``). The stochastic
rounding takes its noise from the caller: a ``torch.Generator`` or the
uniform ``u`` itself, of the local cotangent's shape.

Adam over the table is dense, as the reference's: every row moves through
its moments, touched or not.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ...core import quantization as qlib
from ...kernels.spmm.ops import spmm
from ...kernels.spmm.ref import CSR, split_plan
from ...train.optimizer import tree_leaves, tree_map, update_in_place
from ..nn import mlp, mlp_init

# the stochastic rounding's noise: a generator to draw it from, or ``u``
Noise = Union[torch.Generator, torch.Tensor, None]

# MLPerf DLRM (Criteo Terabyte) per-field vocabulary sizes.
CRITEO_TABLE_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    embed_dim: int = 128
    table_sizes: Sequence[int] = CRITEO_TABLE_SIZES
    bot_mlp: Sequence[int] = (512, 256, 128)
    top_mlp: Sequence[int] = (1024, 1024, 512, 256, 1)
    hot: Sequence[int] | int = 1          # per-field multi-hot bag size
    quantize_collective_bits: Optional[int] = None   # beyond-paper Sylvie

    @property
    def n_sparse(self) -> int:
        return len(self.table_sizes)

    @property
    def hots(self) -> tuple[int, ...]:
        if isinstance(self.hot, int):
            return (self.hot,) * self.n_sparse
        return tuple(self.hot)

    @property
    def total_ids_per_sample(self) -> int:
        return sum(self.hots)

    @property
    def total_rows(self) -> int:
        return int(sum(self.table_sizes))

    @property
    def row_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.table_sizes)]).astype(
            np.int64)

    @property
    def interaction_dim(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2 + self.embed_dim

    def param_count(self) -> int:
        n = self.total_rows * self.embed_dim
        dims = [self.n_dense, *self.bot_mlp]
        n += sum(dims[i] * dims[i + 1] + dims[i + 1]
                 for i in range(len(dims) - 1))
        dims = [self.interaction_dim, *self.top_mlp]
        n += sum(dims[i] * dims[i + 1] + dims[i + 1]
                 for i in range(len(dims) - 1))
        return n


def capped(cfg: DLRMConfig, max_rows: Optional[int]) -> DLRMConfig:
    """``cfg`` with every table cut to at most ``max_rows`` rows (the
    upstream DLRM's ``--max-ind-range``; ``criteo_stream`` takes each id
    modulo its table's size). ``None`` keeps ``cfg``."""
    if max_rows is None:
        return cfg
    return dataclasses.replace(cfg, table_sizes=tuple(
        min(int(s), int(max_rows)) for s in cfg.table_sizes))


def rows_per_device(cfg: DLRMConfig, n_dev: int) -> int:
    return (cfg.total_rows + n_dev - 1) // n_dev


def init_dense_params(cfg: DLRMConfig,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> dict:
    """``{"bot": mlp, "top": mlp}``, glorot-uniform weights and zero biases
    (``models/nn.py::mlp_init``), drawn on the CPU from ``generator`` and
    moved to ``device``."""
    tree = {"bot": mlp_init([cfg.n_dense, *cfg.bot_mlp], generator),
            "top": mlp_init([cfg.interaction_dim, *cfg.top_mlp], generator)}
    return tree_map(lambda t: t.to(device), tree)


def init_table(cfg: DLRMConfig, n_dev: int = 1,
               generator: Optional[torch.Generator] = None,
               shard: bool = False) -> torch.Tensor:
    """The table, uniform in [-0.05, 0.05), drawn on ``generator``'s device
    (the CPU without one): ``(n_dev * rows_per_device, d)``, padded so that
    the row shard is even, or with ``shard`` one device's ``(rpd, d)``
    slice."""
    rpd = rows_per_device(cfg, n_dev)
    dev = generator.device if generator is not None else None
    t = torch.rand((rpd if shard else rpd * n_dev, cfg.embed_dim),
                   generator=generator, device=dev, dtype=torch.float32)
    return t.mul_(0.1).add_(-0.05)


def init_params(cfg: DLRMConfig, seed: int, device=None):
    """``(dense_params, table)`` for one process on ``device``: the dense
    parameters from a CPU generator seeded ``seed``, the table drawn on
    the device from one seeded ``seed + 1`` (the reference's ``key`` and
    ``fold_in(key, 1)``)."""
    dev = torch.device(device or "cpu")
    return (init_dense_params(cfg, torch.Generator().manual_seed(seed), dev),
            init_table(cfg, 1, torch.Generator(dev).manual_seed(seed + 1)))


def step_generator(seed: int, step: int, device=None) -> torch.Generator:
    """The noise generator of training step ``step`` (the reference's
    ``fold_in(key, step)``), seeded from ``seed`` and the step."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    return torch.Generator(device or "cpu").manual_seed(int(mixed))


# ---------------------------------------------------------------------------
# the table's read and its gradient
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IdPlan:
    """Where a batch's ids read the table, for the table's gradient: the
    touched rows ``rows`` ((n_unique,) int64, ascending) and ``csr``, the
    transposed id CSR over them: row ``k`` holds the positions of the flat
    id vector that read ``rows[k]``, in position order, with unit weights
    and the SpMM's work plan (hub rows split into 128-position segments)."""

    rows: torch.Tensor
    csr: CSR

    def to(self, device) -> "IdPlan":
        return IdPlan(self.rows.to(device), self.csr.to(device))


def id_plan(ids, lo: int = 0, n_rows: Optional[int] = None) -> IdPlan:
    """Host-side: the :class:`IdPlan` of the flat ids ``ids`` over table rows
    ``[lo, lo + n_rows)`` (every id when ``n_rows`` is ``None``); ``rows``
    are relative to ``lo``. Built over the batch's unique rows, not the
    table's: one sort of ``row * n + position``, which orders by row and
    then by position."""
    ids = np.asarray(ids).astype(np.int64).reshape(-1) - lo
    n = ids.size
    pos = np.arange(n) if n_rows is None else \
        np.flatnonzero((ids >= 0) & (ids < n_rows))
    row, col = np.divmod(np.sort(ids[pos] * max(n, 1) + pos), max(n, 1))
    starts = np.flatnonzero(np.diff(row, prepend=-1))
    row_ptr = np.append(starts, row.size)
    if row.size >= 2 ** 31:
        raise ValueError("the CSR kernel indexes positions with int32")
    csr = CSR(torch.from_numpy(row_ptr.astype(np.int32)),
              torch.from_numpy(col.astype(np.int32)),
              torch.ones(col.size, dtype=torch.float32), n,
              *split_plan(row_ptr))
    return IdPlan(torch.from_numpy(row[starts]), csr)


def with_plans(stream):
    """``(dense, ids, labels)`` batches -> ``(dense, ids, labels, plan)``,
    each with its :func:`id_plan`: run inside a ``Prefetcher``'s worker,
    the plan is built off the training step's critical path."""
    for dense, ids, labels in stream:
        yield dense, ids, labels, id_plan(ids)


class _Take(torch.autograd.Function):
    """``table[idx]``, rows where ``ok`` is false read as 0; backward: the
    table's gradient, its touched rows summed by the SpMM over the plan's
    transposed id CSR in position order and copied into zeros. Without a
    plan the backward builds it from ``ids`` (the global ids, ``lo`` the
    first row held here)."""

    @staticmethod
    def forward(ctx, table, idx, ok, plan, ids, lo):
        ctx.shape, ctx.plan, ctx.ids, ctx.lo = table.shape, plan, ids, lo
        ctx.bounded = ok is not None
        out = table.index_select(0, idx)
        if ok is not None:
            out.masked_fill_(~ok[:, None], 0)
        return out

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        if plan is None:
            plan = id_plan(ctx.ids.cpu().numpy(), ctx.lo,
                           ctx.shape[0] if ctx.bounded else None).to(g.device)
        rows = spmm(g.contiguous(), plan.csr)
        gt = g.new_zeros(ctx.shape)
        gt.index_copy_(0, plan.rows, rows)
        return gt, None, None, None, None, None


# ---------------------------------------------------------------------------
# the collectives of the sharded path (torch.distributed, the backend's group)
# ---------------------------------------------------------------------------


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated in rank order along dim 0."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def psum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The tiled ``psum_scatter`` over dim 0: rank ``r`` gets the sum over
    ranks of their block ``r``. One ``all_to_all_single`` (block ``q`` goes
    to rank ``q``; ``gloo`` of some versions has no reduce-scatter), then
    the received blocks summed in rank order."""
    p = dist.get_world_size(group)
    x = x.contiguous()
    got = torch.empty_like(x)
    dist.all_to_all_single(got, x, group=group)
    got = got.view(p, x.shape[0] // p, *x.shape[1:])
    out = got[0]
    for s in range(1, p):
        out = out + got[s]
    return out


def _gather_cotangent(g: torch.Tensor, group, bits: Optional[int],
                      noise: Noise) -> torch.Tensor:
    """The exchange's backward: the all-gather of the cotangent, plain
    (32 bits or none), in bf16 (16), or as the Low-bit Module's payload,
    scale and zero, dequantized on arrival (1, 2, 4, 8 and the unpacked
    widths)."""
    if bits is None or bits > 16:
        return all_gather(g, group)
    if bits == 16:
        return all_gather(g.to(torch.bfloat16), group).to(g.dtype)
    gen = noise if isinstance(noise, torch.Generator) else None
    u = noise if torch.is_tensor(noise) else None
    qt = qlib.quantize(g, bits, generator=gen, u=u)
    gathered = qlib.QuantizedTensor(
        all_gather(qt.data, group), all_gather(qt.scale, group),
        all_gather(qt.zero, group), qt.bits, qt.feat_dim)
    return qlib.dequantize(gathered, g.dtype)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, group, bits, noise):
        ctx.group, ctx.bits, ctx.noise = group, bits, noise
        if bits is not None and bits <= 16:
            # one contributor per row: the bf16 sum is that row, rounded once
            return psum_scatter(part.to(torch.bfloat16), group).to(part.dtype)
        return psum_scatter(part, group)

    @staticmethod
    def backward(ctx, g):
        return (_gather_cotangent(g, ctx.group, ctx.bits, ctx.noise), None,
                None, None)


def sylvie_embedding_exchange(part: torch.Tensor, backend,
                              bits: Optional[int], noise: Noise = None
                              ) -> torch.Tensor:
    """The embedding exchange, ``(n_glob, d)`` partial rows -> this rank's
    ``(n_local, d)``: a ``psum_scatter`` (in bf16 when ``bits <= 16``) whose
    backward all-gathers the cotangent, b-bit packed at 1, 2, 4 or 8 bits
    with stochastic rounding from ``noise`` (a generator, or ``u`` of the
    local cotangent's shape). ``bits=None`` is the plain float32
    collective both ways."""
    return _Exchange.apply(part, backend.group, bits, noise)


def embedding_bag(table: torch.Tensor, flat_ids: torch.Tensor,
                  cfg: DLRMConfig, backend=None, noise: Noise = None,
                  plan: Optional[IdPlan] = None) -> torch.Tensor:
    """``flat_ids`` (n_local,) global row ids of this process's batch slice ->
    (n_local, d) bag-input rows. One process (``backend=None``): a plain
    read. Sharded: all-gather the ids, read the rows held here (0 for the
    others), ``sylvie_embedding_exchange`` the partials. ``plan`` is the
    batch's :func:`id_plan` (one process only); without it the backward
    builds it from the (gathered) ids."""
    if backend is None:
        return _Take.apply(table, flat_ids, None, plan, flat_ids, 0)
    ids = all_gather(flat_ids, backend.group)                # (n_glob,)
    rpd = table.shape[0]
    lo = backend.rank * rpd
    loc = ids.to(torch.int64) - lo
    ok = (loc >= 0) & (loc < rpd)
    part = _Take.apply(table, torch.where(ok, loc, 0), ok, None, ids, lo)
    return sylvie_embedding_exchange(part, backend,
                                     cfg.quantize_collective_bits, noise)


def bag_reduce(rows: torch.Tensor, cfg: DLRMConfig, batch: int
               ) -> torch.Tensor:
    """(batch * total_ids, d) -> (batch, n_sparse, d) sum-bags: each field's
    ``hot`` contiguous rows summed left to right (one-hot fields are the
    rows themselves)."""
    rows = rows.view(batch, cfg.total_ids_per_sample, cfg.embed_dim)
    if all(h == 1 for h in cfg.hots):
        return rows
    bags, start = [], 0
    for h in cfg.hots:
        acc = rows[:, start]
        for j in range(1, h):
            acc = acc + rows[:, start + j]
        bags.append(acc)
        start += h
    return torch.stack(bags, 1)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pairs(f: int) -> np.ndarray:
    """Flat indices ``i * f + j`` of ``np.triu_indices(f, k=1)``, the
    reference's pair order."""
    iu, ju = np.triu_indices(f, k=1)
    return iu * f + ju


def _interact(z: torch.Tensor, bot: torch.Tensor) -> torch.Tensor:
    """z (B, F+1, d), its row 0 ``bot`` (B, d) -> (B, F+1 choose 2 + d)."""
    b, f = z.shape[0], z.shape[1]
    g = torch.bmm(z, z.transpose(1, 2)).reshape(b, f * f)
    idx = torch.as_tensor(_pairs(f), device=z.device)
    return torch.cat([bot, g[:, idx]], dim=-1)


def dot_interaction(bot_out: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """bot_out (B, d); emb (B, F, d) -> (B, F+1 choose 2 + d)."""
    return _interact(torch.cat([bot_out[:, None, :], emb], dim=1), bot_out)


def dlrm_forward(dense_params: dict, table: torch.Tensor,
                 dense_x: torch.Tensor, flat_ids: torch.Tensor,
                 cfg: DLRMConfig, backend=None, noise: Noise = None,
                 plan: Optional[IdPlan] = None) -> torch.Tensor:
    """dense_x (B_local, n_dense); flat_ids (B_local * total_ids,) -> logits
    (B_local,)."""
    b = dense_x.shape[0]
    bot = mlp(dense_params["bot"], dense_x)                       # (B, d)
    rows = embedding_bag(table, flat_ids, cfg, backend, noise, plan)
    emb = bag_reduce(rows, cfg, b)
    feats = dot_interaction(bot, emb)
    return mlp(dense_params["top"], feats)[:, 0]                  # (B,)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def loss_and_grads(dense_params: dict, table: torch.Tensor,
                   dense_x: torch.Tensor, flat_ids: torch.Tensor,
                   labels: torch.Tensor, cfg: DLRMConfig, backend=None,
                   noise: Noise = None, plan: Optional[IdPlan] = None):
    """``(loss, dense gradients, table gradient)``, the loss detached. The
    loss is the local mean over the number of ranks, so each rank's
    gradients are exact contributions to the global mean; sharded, the
    loss and the dense gradients are then all-reduced (after
    ``torch.autograd.grad``: not an autograd op) and the table's stay
    local, each rank owning its rows."""
    n_dev = 1 if backend is None else backend.n_parts
    leaves = tree_leaves(dense_params) + [table]
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        try:
            logits = dlrm_forward(dense_params, table, dense_x, flat_ids, cfg,
                                  backend, noise, plan)
            loss = bce_loss(logits, labels) / n_dev
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
    loss, gd = loss.detach(), list(grads[:-1])
    if backend is not None:
        flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in gd])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=backend.group)
        loss = flat[0]
        off = 1
        for i, g in enumerate(gd):
            gd[i] = flat[off:off + g.numel()].view_as(g)
            off += g.numel()
    it = iter(gd)
    return loss, tree_map(lambda _: next(it), dense_params), grads[-1]


def _update_table(optimizer, grad: torch.Tensor, opt_state,
                  table: torch.Tensor):
    """``update_in_place`` of the table (its chunks bound Adam's
    temporaries on a many-GB leaf); returns the new optimizer state."""
    def wrap(node):
        if torch.is_tensor(node) and node.shape == table.shape:
            return {"table": node}
        if isinstance(node, dict):
            return {k: wrap(v) for k, v in node.items()}
        return node

    def unwrap(node):
        if isinstance(node, dict):
            return node["table"] if node.keys() == {"table"} else \
                {k: unwrap(v) for k, v in node.items()}
        return node

    state = wrap(opt_state)
    update_in_place(optimizer, {"table": grad}, state, {"table": table})
    return unwrap(state)


def make_train_step(cfg: DLRMConfig, optimizer, backend=None):
    """``train_step(state, dense_x, flat_ids, labels, noise=None, plan=None)
    -> (state, loss)`` with ``state = (dense_params, table, opt_dense,
    opt_table, step)``, as the reference's: the loss and its gradients
    (:func:`loss_and_grads`), then the optimizer's update of the dense
    parameters and of the table, leaf by leaf and in place. ``noise`` feeds
    the quantized exchange's stochastic rounding; ``plan`` is the batch's
    :func:`id_plan` (one process)."""
    def train_step(state, dense_x, flat_ids, labels, noise: Noise = None,
                   plan: Optional[IdPlan] = None):
        dense_params, table, opt_d, opt_t, step = state
        loss, gd, gt = loss_and_grads(dense_params, table, dense_x, flat_ids,
                                      labels, cfg, backend, noise, plan)
        update_in_place(optimizer, gd, opt_d, dense_params)
        opt_t = _update_table(optimizer, gt, opt_t, table)
        return (dense_params, table, opt_d, opt_t, step + 1), loss
    return train_step


def make_serve_step(cfg: DLRMConfig, backend=None):
    """``serve(dense_params, table, dense_x, flat_ids)`` -> CTR (B_local,)."""
    @torch.no_grad()
    def serve(dense_params, table, dense_x, flat_ids):
        return torch.sigmoid(dlrm_forward(dense_params, table, dense_x,
                                          flat_ids, cfg, backend))
    return serve


def retrieval_scores(dense_params: dict, table: torch.Tensor,
                     dense_x: torch.Tensor, flat_ids: torch.Tensor,
                     cand_ids: torch.Tensor, cfg: DLRMConfig, backend=None,
                     cand_field: int = 0) -> torch.Tensor:
    """The logit of each of this rank's candidates (n_local,): the query's
    bag inputs with field ``cand_field`` replaced by the candidate's row.
    The (n, F + 1, d) interaction input is built once, in place."""
    bot = mlp(dense_params["bot"], dense_x)                       # (1, d)
    rows = embedding_bag(table, flat_ids, cfg, backend)
    emb = bag_reduce(rows, cfg, 1)                                # (1, F, d)
    cand = embedding_bag(table, cand_ids, cfg, backend)           # (n, d)
    n = cand.shape[0]
    z = torch.cat([bot[:, None, :], emb], 1).expand(n, -1, -1).clone()
    z[:, 1 + cand_field] = cand
    feats = _interact(z, bot.expand(n, -1))
    return mlp(dense_params["top"], feats)[:, 0]


def make_retrieval_step(cfg: DLRMConfig, backend=None, top_k: int = 64,
                        cand_field: int = 0):
    """Score one query against candidates for field ``cand_field`` (the
    other fields and the dense features come from the query): ``(values,
    ids)`` of the ``top_k`` highest scores, descending. Candidates stay
    sharded: a top-k per rank, then an all-gather and the merged top-k."""
    @torch.no_grad()
    def retrieval(dense_params, table, dense_x, flat_ids, cand_ids):
        scores = retrieval_scores(dense_params, table, dense_x, flat_ids,
                                  cand_ids, cfg, backend, cand_field)
        n = scores.shape[0]
        v, i = torch.topk(scores, min(top_k, n))
        ids = cand_ids[i]
        if backend is not None:
            v = all_gather(v, backend.group)
            ids = all_gather(ids, backend.group)
            v, sel = torch.topk(v, top_k)
            ids = ids[sel]
        return v, ids
    return retrieval
