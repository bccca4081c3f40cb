"""STREAM triad: CUDA kernel, plain version, CoroSpec."""
