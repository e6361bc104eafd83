"""L1 matrix factorization: complete-pivot rrLU (a hand-written CUDA kernel
with a plain PyTorch twin) and its CI interface."""
