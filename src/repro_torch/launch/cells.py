"""The analytic FLOPs of the port's GNN models, as
``repro.launch.cells._gnn_model_flops``: GCN, GraphSAGE, GAT, PNA,
MeshGraphNet, SchNet and NequIP. The fan-out sampler's cells and the rest
of the reference's module wait for their models (ROADMAP item 15); its
dry-run cells (meshes, lowering) have no counterpart here."""
from __future__ import annotations

NOT_PORTED = "not ported yet (ROADMAP queue A, item 15: DLRM)"


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
        raise NotImplementedError(f"FLOPs of arch {arch_name!r}: {NOT_PORTED}")
    return 3.0 * f if train else f
