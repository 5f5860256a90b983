"""One intra-op thread for the port's CPU tests.

The tier-1 run puts a pytest-xdist worker on each of several cores, and
each worker's PyTorch would start an OpenMP pool of one thread a core:
the pools then wait on each other at every parallel region.  Measured on
an 8-core machine beside seven busy processes, one reduced() masked
train-step case took 61 s on the default pool and 12.7 s on one thread
(tests/test_torch_masked.py::test_masked_train_steps_equal_padded_bitwise).
The port's CPU tests run reduced() shapes, where more threads buy little.
Every tests/test_torch_*.py file imports this module first but the card's
(tests/test_torch_gpu.py), whose CPU twins run full-width shapes."""
import torch

torch.set_num_threads(1)
