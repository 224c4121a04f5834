# Deterministic-seekable data pipeline (LM token batches), the counterpart
# of ``repro.data``: batch(step) is a pure function of (seed, step), equal
# to the JAX package's batch, so checkpoint/restart replays the exact
# stream in either package.
