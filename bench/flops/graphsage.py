"""GraphSAGE-mean's useful FLOPs of a training epoch: the frozen copy of the
port's ``launch/cells.py::_gnn_model_flops`` for ``graphsage`` (per layer the
neighbour sum and the two linears), times 3 for forward and backward."""


def train_flops(n: int, e: int, d_in: int, d_hidden: int, d_out: int,
                n_layers: int) -> float:
    dims = [d_in] + [d_hidden] * (n_layers - 1) + [d_out]
    f = 0.0
    for i in range(n_layers):
        f += 2 * e * dims[i] + 2 * n * dims[i] * dims[i + 1]
        f += 2 * n * dims[i] * dims[i + 1]
    return 3.0 * f
