"""Paged flash-decode attention: CUDA kernel, plain version, CoroSpec."""
