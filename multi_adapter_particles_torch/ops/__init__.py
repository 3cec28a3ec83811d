"""Hand-written CUDA kernels, each beside its plain torch twin."""
