"""repro_torch: the Distributed Discrete Morse Sandwich in PyTorch + CUDA.

The PyTorch / CUDA port of ``repro`` (the JAX package, kept beside it as
the reference).  It imports ``torch`` and ``numpy`` only.  The entry point
is :class:`repro_torch.pipeline.PersistencePipeline`, which runs on the
``cuda`` device unless given ``device="cpu"``.
"""
