"""The analytic FLOPs of the port's models, as ``repro.launch.cells``:
``_gnn_model_flops`` (GCN, GraphSAGE, GAT, PNA, MeshGraphNet, SchNet,
NequIP, and the reference's generic estimate for any other name) and
``_dlrm_model_flops``. The fan-out sampler's cells wait for the sampler
(ROADMAP queue A, item 15.3); the dry-run cells (meshes, lowering) have no
counterpart here."""
from __future__ import annotations


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
