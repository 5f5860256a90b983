"""Row-wise quantize inputs shared by the CPU parity tests
(test_torch_quant.py) and the card's kernel tests (test_torch_gpu.py):
random values over many magnitudes and the boundary cases of the po2
scale.  Imports no jax."""
import numpy as np

KINDS = ["random", "po2_amax", "big_exp", "zero_tiles"]


def quant_inputs(kind, rng, shape):
    x = (rng.normal(size=shape) * np.exp(rng.normal(size=shape) * 1.5))
    x = x.astype(np.float32)
    rows = shape[0]
    if kind == "po2_amax":
        # every tile's amax is exactly 448 * 2**e
        lim = 448.0 * np.exp2(rng.integers(-20, 20, size=rows))[:, None]
        x = x / np.abs(x).max(axis=1, keepdims=True) * lim * 0.99
        x[:, 0::128] = lim
    elif kind == "big_exp":
        x = x * np.exp2(rng.choice([-40, -24, -13, 13, 24, 40], size=(rows, 1)))
    elif kind == "zero_tiles":
        x[::2, :128] = 0.0
        x[1::3] = 0.0
    return x.astype(np.float32)
