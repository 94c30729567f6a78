"""repro_torch — the Sylvie reproduction on PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``repro``: same sub-package and
module names, PyTorch inside. It imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of ``repro`` (the graph, dataset and config modules that
need no JAX are kept as copies here). Only the parity tests import both packages.

The device is fixed in one place, :func:`repro_torch.dist.runtime.resolve_device`
(used by ``Runtime.simulated`` and the LM entry point): CUDA unless the caller
asks for the CPU. Ported so far:

* full-graph training of GCN, GraphSAGE and GAT (``train.GNNTrainer``,
  ``python -m repro_torch.launch.train``) with Sylvie's quantized halo
  exchange: the Low-bit Module (quantize + pack, unpack + dequantize), the
  aggregation (CSR SpMM) and GAT's kernels;
* GNN serving: ``serve.InferenceEngine`` (full sweep, k-hop delta refresh,
  degraded mode), the request path and load generators around it
  (``serve.server``, ``serve.loadgen``), the sharded embedding store
  (``store``) and ``python -m repro_torch.launch.serve``;
* the spans and metrics they report through (``obs``,
  ``python -m repro_torch.obs``);
* batched LM serving (prefill + greedy decode,
  ``python -m repro_torch.launch.train --arch granite-3-2b --serve``): every
  prefill layer's attention is the flash-attention kernel;
* LM training (``models.lm.model.make_train_step``, ``python -m
  repro_torch.launch.train --arch granite-3-2b``) on the token stream and
  its prefetcher (``data``), the attention's gradient on the flash backward
  kernels;
* fault-tolerant training (``faults``, ``python -m
  repro_torch.launch.chaos``), the overlap schedule on a side CUDA stream
  (``dist.overlap``), the scenario matrix (``launch.scenarios``, ``--scenario``)
  and the partition-plan cache (``datasets.plans``).

Each kernel runs as hand-written CUDA on a CUDA tensor and as its plain
PyTorch version on a CPU tensor (``repro_torch/kernels``).
"""
