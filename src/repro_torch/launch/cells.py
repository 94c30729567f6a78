"""The analytic FLOPs of the paper's GNN models, as
``repro.launch.cells._gnn_model_flops`` (GCN, GraphSAGE and GAT; the
reference's other archs are not ported, ROADMAP item 15). The reference's
dry-run cells (meshes, lowering) have no counterpart here."""
from __future__ import annotations

NOT_PORTED = "not ported yet (ROADMAP queue A, item 15)"


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
    else:
        raise NotImplementedError(f"FLOPs of arch {arch_name!r}: {NOT_PORTED}")
    return 3.0 * f if train else f
