"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version (``ref.py``) and its wrapper (``ops.py``).

| kernel | wrapper | replaces (JAX package) |
| --- | --- | --- |
| ``quantize_pack`` | ``quant.ops.quantize_pack_rows`` | ``repro/kernels/quant/quant.py::_quantize_kernel`` |
| ``unpack_dequantize`` | ``quant.ops.dequantize_rows`` | ``repro/kernels/quant/quant.py::_dequantize_kernel`` |
| ``spmm_csr`` | ``spmm.ops.spmm`` | ``repro/kernels/spmm/spmm.py::_spmm_kernel`` |
| ``flash_fwd`` | ``flash.ops.flash_fwd``, ``flash.ops.attention_bshd`` | ``repro/kernels/flash/flash.py::_flash_kernel`` |
| ``spmm_csr_heads`` | ``spmm.ops.spmm_heads`` | none: ``repro/models/gnn/models.py::GAT`` (``agg_sum`` of alpha-weighted messages) |
| ``gat_softmax`` | ``gat.ops.softmax`` | none: ``repro/models/gnn/blocks.py::edge_softmax`` |
| ``sddmm_heads`` | ``gat.ops.sddmm_heads`` | none: the gradient of alpha (JAX autodiff) |
| ``gat_softmax_bwd`` | ``gat.ops.softmax_bwd``, ``gat.ops.row_sums_t`` | none: ``edge_softmax``'s VJP (JAX autodiff) |
| ``seg_max_min_csr`` | ``seg.ops.seg_max_min`` | none: ``repro/models/gnn/blocks.py::agg_max`` and ``agg_min`` (``jax.ops.segment_max``), in one pass |
| ``seg_max_min_bwd_csr`` | ``seg.ops.seg_max_min_bwd`` | none: the VJP of both (JAX autodiff) |

The wrappers dispatch on the tensor's device: the plain version on the CPU,
the kernel on CUDA, nothing else, no fallback.
"""
