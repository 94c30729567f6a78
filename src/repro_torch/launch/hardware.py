"""The card's figures that the comm-time model needs (DESIGN §8/§14).

The reference's ``repro/launch/mesh.py`` holds TPU mesh builders and TPU
constants; none of them carries over. These are NVIDIA's published values
for the H100 SXM5 (the H100 data sheet; dense rates, no sparsity, at the
card's full power limit), for the card the port runs on, which ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints as
:data:`CARD`. They are published peaks, not measurements: the scenario
reports' ``modeled_comm_*`` keys are a model, and every measured figure of
the port lives in ``PERF.md`` with the script that took it.
"""
from __future__ import annotations

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"

# dense BF16 tensor-core peak, FLOP/s (NVIDIA H100 SXM5 data sheet)
PEAK_FLOPS_BF16 = 989e12
# HBM3 bandwidth, bytes/s (NVIDIA H100 SXM5 data sheet)
HBM_BW = 3.35e12
# NVLink 4 bandwidth per direction, bytes/s: 900 GB/s total per card, half
# each way (NVIDIA H100 SXM5 data sheet)
NVLINK_BW = 450e9
