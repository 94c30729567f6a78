"""CSR SpMM kernel: the GNN aggregation."""
