"""GAT edge softmax, its backward and the per-head SDDMM (``csrc/gat.cu``)."""
