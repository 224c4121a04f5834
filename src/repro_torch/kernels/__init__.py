"""Lower-star gradient kernels (CUDA, with a plain PyTorch version) and the
batched sandwich back-end."""
