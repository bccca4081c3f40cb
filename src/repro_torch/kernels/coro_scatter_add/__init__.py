"""Coroutine scatter-add (RMW): CUDA kernel, plain version, CoroSpec."""
