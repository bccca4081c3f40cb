"""Chunked Mamba-2 SSD scan: CUDA kernel, plain version, CoroSpec."""
