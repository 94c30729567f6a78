"""GNN models over partitioned graph blocks."""
