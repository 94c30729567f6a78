"""Plain GraphSAGE-mean (Hamilton et al., arXiv:1706.02216): per layer
``h' = h W_self + b + mean_{u -> v} h_u W_nb``, ReLU between layers, the mean
over each node's in-edges (its self-loop among them). Parameters are named
as the program's tree: ``layer{i}.self.w``, ``layer{i}.self.b``,
``layer{i}.nb.w``, each ``w`` shaped (d_in, d_out)."""
from __future__ import annotations

import torch

from .common import sparse_rows, spmm


class Model:
    def __init__(self, cfg: dict, d_in: int, n_classes: int):
        self.n_layers = int(cfg["n_layers"])
        self.dims = [d_in] + [int(cfg["d_hidden"])] * (self.n_layers - 1) \
            + [n_classes]
        self._a = None

    def param_shapes(self) -> dict:
        out = {}
        for i in range(self.n_layers):
            a, b = self.dims[i], self.dims[i + 1]
            out[f"layer{i}.self.w"] = (a, b)
            out[f"layer{i}.self.b"] = (b,)
            out[f"layer{i}.nb.w"] = (a, b)
        return out

    def comm_dims(self) -> list:
        return self.dims[:-1]

    def _mean_matrix(self, graph, plan):
        if self._a is None:
            n_cols = graph.n + plan.node.numel()
            dt = graph.x.dtype
            self._a = (sparse_rows(graph.dst, plan.col, graph.n, n_cols, dt),
                       sparse_rows(plan.col, graph.dst, n_cols, graph.n, dt))
        return self._a

    def forward(self, params: dict, graph, plan, comm) -> torch.Tensor:
        a, at = self._mean_matrix(graph, plan)
        inv_deg = 1.0 / torch.clamp(graph.deg, min=1.0)[:, None]
        h = graph.x
        for i in range(self.n_layers):
            table = comm.table(i, h)
            agg = spmm(a, at, table) * inv_deg
            h = h @ params[f"layer{i}.self.w"] + params[f"layer{i}.self.b"] \
                + agg @ params[f"layer{i}.nb.w"]
            if i < self.n_layers - 1:
                h = torch.relu(h)
        return h
