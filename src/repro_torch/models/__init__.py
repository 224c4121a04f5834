# LM-family model substrate in PyTorch: configs, layers, decoder-only /
# enc-dec stacks, and the carry-across of the JAX package's parameters.
