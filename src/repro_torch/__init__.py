"""PyTorch/CUDA port of the FP8-Flow-MoE reproduction (``repro``).

Module paths mirror the JAX package: ``repro_torch.core.quant`` is the
counterpart of ``repro.core.quant``, and so on.  The seven Pallas kernels
on the serving and training paths are hand-written CUDA kernels for Hopper
under ``csrc/``; each has a plain PyTorch twin in ``repro_torch.kernels``
that runs whenever its input tensor lies on the CPU.  The package imports
``torch`` and never ``jax`` or ``repro``.
"""
