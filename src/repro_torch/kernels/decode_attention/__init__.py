"""Flash-decode attention, dense and paged: CUDA kernels, plain versions, CoroSpecs."""
