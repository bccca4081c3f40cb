"""Grouped matmul of the MoE expert FFN: CUDA kernel, plain version, CoroSpec."""
