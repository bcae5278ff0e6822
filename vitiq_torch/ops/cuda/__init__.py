"""Hand-written CUDA kernels (built at first use by `_build`) with their
wrappers and plain PyTorch versions."""
