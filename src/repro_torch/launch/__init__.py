# Launchers (the counterpart of ``repro.launch``): the training loop.
