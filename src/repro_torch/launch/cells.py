"""The cell inventory of the port: every (architecture x input shape) pair of
the registry, sized and counted without allocating anything, as
``repro.launch.cells``.

``build_cell(arch_id, shape_name, n_devices, **kw)`` returns a :class:`Cell`
with the shape's step (LM ``train_4k`` the train step, ``prefill_32k`` the
prefill, ``decode_32k`` / ``long_500k`` the one-token decode step; GNN
shapes the partition-parallel Sylvie train step; DLRM shapes train / serve /
retrieval), its analytic "useful" model FLOPs and its meta:

* GNN cells: the static buffers of an analytic partition
  (``graph.partition.analytic_partition_spec``) and the bytes of its
  exchanges (``n_local``, ``e_pad``, ``h_pad``, ``halo_rows``,
  ``exchange_payload_bytes_per_part``, ``exchange_ec_bytes_per_part``,
  ``sylvie_mode``, ``bits``); ``minibatch_lg`` is sized by the fan-out
  sampler's static bounds (``graph.sampling.SamplerShapes``);
* LM cells: ``params`` and ``active_params``;
* DLRM cells: ``table_rows``, ``rows_per_device`` and ``params``.

Nothing is allocated: LM and DLRM cells are arithmetic on their configs, and
a GNN cell's model is built on the ``meta`` device for its widths, its plan
from the spec (``PlanArrays.from_spec``, ``meta`` tensors). The reference's
``Cell.lower`` (``jax.jit(step).lower`` on ``ShapeDtypeStruct``s), its
``fn`` / ``args`` / ``mesh`` / ``shard_ctx`` and the dry-run modules it
serves (``launch/dryrun.py``, ``hlo.py``, ``mesh.py``) are the TPU
compiler's and have no counterpart here; the mesh is its device count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import configs as configlib
from ..configs.base import ArchSpec, ShapeCell
from ..core.exchange import PlanArrays, exchange_bytes
from ..graph.partition import analytic_partition_spec
from ..graph.sampling import SamplerShapes
from ..models.recsys import dlrm as D


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    step: str
    n_devices: int
    model_flops: Optional[float]
    meta: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_model_flops(cfg, cell: ShapeCell) -> float:
    s, b = cell.params["seq_len"], cell.params["global_batch"]
    n_act = cfg.param_count(active_only=True)
    # causal attention math: 2 matmuls x 2 flops x (S^2/2) x H x dh per layer
    attn = 0.0
    for _, _, lc, cnt in cfg.sub_layers():
        a = lc.attn
        dh = a.d_nope + a.d_rope if a.kind == "mla" else a.d_head
        span = min(s, a.window) if a.window else s
        attn += cnt * 2 * b * a.n_heads * dh * s * span
    if cell.step == "train":
        return 6.0 * n_act * b * s + 3.0 * attn
    if cell.step == "prefill":
        return 2.0 * n_act * b * s + attn
    # decode: one token against an S-token cache
    attn_dec = 0.0
    for _, _, lc, cnt in cfg.sub_layers():
        a = lc.attn
        dh = a.d_nope + a.d_rope if a.kind == "mla" else a.d_head
        span = min(s, a.window) if a.window else s
        attn_dec += cnt * 4 * b * a.n_heads * dh * span
    return 2.0 * n_act * b + attn_dec


def _reduce_depth(cfg, depth: int):
    """Shrink every count>1 segment to ``depth`` (the depth cut of the
    cost-extrapolation probes, and of ``chip_smoke.py``'s LMs)."""
    segs = tuple(dataclasses.replace(s, count=min(s.count, depth))
                 for s in cfg.segments)
    return dataclasses.replace(cfg, segments=segs)


def lm_scaled_count(cfg) -> int:
    """The count of the (single) scaled segment."""
    return max(s.count for s in cfg.segments)


def _lm_cell(spec: ArchSpec, cell: ShapeCell, n_devices: int, *,
             depth: Optional[int] = None) -> Cell:
    cfg = spec.config()
    if depth is not None:
        cfg = _reduce_depth(cfg, depth)
    return Cell(spec.arch_id, cell.name, cell.step, n_devices,
                _lm_model_flops(cfg, cell),
                meta=dict(params=cfg.param_count(),
                          active_params=cfg.param_count(active_only=True)))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def gnn_cell_sizes(cell: ShapeCell) -> tuple[int, int, int]:
    """(n_nodes, n_edges, d_feat) of the array the runtime actually trains."""
    p = cell.params
    if cell.name == "minibatch_lg":
        ss = SamplerShapes(p["batch_nodes"], tuple(p["fanout"]))
        return ss.max_nodes, ss.max_edges, p["d_feat"]
    if cell.name == "molecule":
        return p["n_nodes"] * p["batch"], p["n_edges"] * p["batch"] * 2, \
            p["d_feat"]
    return p["n_nodes"], p["n_edges"], p["d_feat"]


def _gnn_model_flops(arch_name: str, model, n: int, e: int, d_in: int,
                     train: bool) -> float:
    """Analytic 'useful' FLOPs of one forward pass (x3 for fwd+bwd)."""
    f = 0.0
    name = arch_name.split("-")[0]
    if name in ("gcn", "graphsage"):
        dims = [d_in] + [model.d_hidden] * (model.n_layers - 1) + [model.d_out]
        for i in range(model.n_layers):
            f += 2 * e * dims[i] + 2 * n * dims[i] * dims[i + 1]
            if name == "graphsage":
                f += 2 * n * dims[i] * dims[i + 1]
    elif name == "gat":
        d = model.heads * model.d_hidden
        din = d_in
        for _ in range(model.n_layers):
            f += 2 * n * din * d + 4 * e * d + 2 * e * model.heads
            din = d
        f += 2 * n * din * model.d_out
    elif name == "pna":
        d = model.d_hidden
        f += 2 * n * d_in * d
        for _ in range(model.n_layers):
            f += 2 * e * 2 * d * d + 8 * e * d + 2 * n * 12 * d * d
    elif name == "meshgraphnet":
        d = model.d_hidden
        f += 2 * n * d_in * d + 2 * e * model.d_edge_in * d
        for _ in range(model.n_layers):
            f += 2 * e * (3 * d * d + d * d) + 2 * n * (2 * d * d + d * d)
    elif name == "schnet":
        d = model.d_hidden
        f += 2 * n * d_in * d
        for _ in range(model.n_interactions):
            f += 2 * e * (model.n_rbf * d + d * d) + 2 * e * d \
                + 2 * n * 3 * d * d
    elif name == "nequip":
        mul = model.mul
        n_paths = len(model.paths)
        f += 2 * n * d_in * mul
        tp = sum((2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1) * 2 * mul
                 for (l1, l2, l3) in model.paths)
        for _ in range(model.n_layers):
            f += e * tp + 2 * e * (model.n_rbf * mul + mul * n_paths * mul)
            f += 2 * n * 2 * mul * mul * (model.l_max + 1) ** 2
    else:
        f = 2 * e * 64 + 2 * n * d_in * 64
    return 3.0 * f if train else f


def _gnn_cell(spec: ArchSpec, cell: ShapeCell, n_devices: int, *,
              sylvie_mode: str = "sync", bits: int = 1,
              n_classes: int = 16) -> Cell:
    arch = spec.config()
    n, e, d_feat = gnn_cell_sizes(cell)
    pspec = analytic_partition_spec(n, e, n_devices)
    plan = PlanArrays.from_spec(pspec)
    with torch.device("meta"):          # the widths, no parameter
        model = arch.make(d_feat, n_classes)
    dims = model.comm_dims()
    # exchange_bytes totals across partitions; the meta reports per device
    payload = sum(exchange_bytes(plan, d, bits)[0] for d in dims) // n_devices
    ec = sum(exchange_bytes(plan, d, bits)[1] for d in dims) // n_devices
    return Cell(spec.arch_id, cell.name, cell.step, n_devices,
                _gnn_model_flops(arch.name, model, n, e, d_feat, True),
                meta=dict(n_local=pspec.n_local, e_pad=pspec.e_pad,
                          h_pad=pspec.h_pad, halo_rows=pspec.halo_rows,
                          exchange_payload_bytes_per_part=payload,
                          exchange_ec_bytes_per_part=ec,
                          sylvie_mode=sylvie_mode, bits=bits))


# ---------------------------------------------------------------------------
# DLRM cells
# ---------------------------------------------------------------------------


def _dlrm_model_flops(cfg, cell) -> float:
    """Analytic FLOPs of a DLRM cell (``cfg`` a ``DLRMConfig``, ``cell`` a
    ``ShapeCell``): the MLPs and the dot interaction per sample, times the
    batch (or the candidates), x3 for a training step."""
    b = cell.params.get("n_candidates", cell.params["batch"])
    dims = [cfg.n_dense, *cfg.bot_mlp]
    f = sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    fpf = cfg.n_sparse + 1
    f += 2 * fpf * fpf * cfg.embed_dim       # dot interaction
    dims = [cfg.interaction_dim, *cfg.top_mlp]
    f += sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    per_sample = f
    mult = 3.0 if cell.step == "train" else 1.0
    return mult * per_sample * b


def _dlrm_cell(spec: ArchSpec, cell: ShapeCell, n_devices: int, *,
               qbits: Optional[int] = None) -> Cell:
    cfg = spec.config()
    if qbits is not None:
        cfg = dataclasses.replace(cfg, quantize_collective_bits=qbits)
    return Cell(spec.arch_id, cell.name, cell.step, n_devices,
                _dlrm_model_flops(cfg, cell),
                meta=dict(table_rows=cfg.total_rows,
                          rows_per_device=D.rows_per_device(cfg, n_devices),
                          params=cfg.param_count()))


# ---------------------------------------------------------------------------


def build_cell(arch_id: str, shape_name: str, n_devices: int, **kw) -> Cell:
    """The cell of ``arch_id`` at ``shape_name`` over ``n_devices`` devices;
    ``kw`` as the reference's: ``sylvie_mode`` and ``bits`` (GNN), ``qbits``
    (DLRM), ``depth`` (LM)."""
    spec = configlib.get(arch_id)
    cell = spec.shape(shape_name)
    if spec.kind == "lm":
        return _lm_cell(spec, cell, n_devices, **kw)
    if spec.kind == "gnn":
        return _gnn_cell(spec, cell, n_devices, **kw)
    if spec.kind == "recsys":
        return _dlrm_cell(spec, cell, n_devices, **kw)
    raise ValueError(spec.kind)


def all_cells() -> list[tuple[str, str]]:
    out = []
    for arch_id in configlib.ASSIGNED:
        for cell in configlib.get(arch_id).shapes:
            out.append((arch_id, cell.name))
    return out
