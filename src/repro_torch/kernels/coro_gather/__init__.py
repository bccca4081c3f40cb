"""Coroutine row and span gather: CUDA kernel, plain versions, CoroSpecs."""
