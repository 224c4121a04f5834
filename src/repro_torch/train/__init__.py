# Training substrate (the counterpart of ``repro.train``): optimizer, train
# step, checkpointing in the JAX package's format, gradient compression.
