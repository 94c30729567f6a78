"""The SpMM's share of its bandwidth bound: for every call the window made,
its CSR (row pointers, columns, values) read once, each table row that a
column names read once and the output written once, at the card's peak HBM
bandwidth, over the SpMM kernels' device time."""


def read(run):
    secs = run.device_seconds("spmm")
    if not secs or run.peaks is None or not run.calls.spmm:
        return None
    import torch
    distinct = {}
    total = 0
    for csr, d in run.calls.spmm:
        key = csr.col.data_ptr()
        if key not in distinct:
            distinct[key] = int(torch.unique(csr.col).numel())
        rows, nnz = csr.n_rows, csr.nnz
        total += 4 * (rows + 1) + 8 * nnz
        total += 4 * d * (distinct[key] + rows)
    return 100.0 * total / run.peaks["hbm_bytes_per_s"] / secs
