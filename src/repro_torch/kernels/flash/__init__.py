"""Flash-attention forward: online softmax over KV tiles."""
