"""Hand-written CUDA kernels, their plain PyTorch versions, build and dispatch."""
