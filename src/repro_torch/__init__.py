"""repro_torch — the Sylvie reproduction on PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``repro``: same sub-package and
module names, PyTorch inside. It imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of ``repro`` (the numpy-only graph and dataset modules are
kept as copies here). Only the parity tests import both packages.

The device is fixed in one place, :meth:`repro_torch.dist.runtime.Runtime.simulated`:
CUDA unless the caller asks for the CPU. The Low-bit Module (quantize + pack,
unpack + dequantize) and the GCN aggregation (CSR SpMM) run as hand-written
CUDA kernels on a CUDA tensor and as their plain PyTorch versions on a CPU
tensor (``repro_torch/kernels``).
"""
