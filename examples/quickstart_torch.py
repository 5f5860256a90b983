"""Quickstart on the PyTorch port: the paper's core objects in 30 lines.

  1. quantize a tensor with po2 scales (Eq. 2),
  2. re-layout it with the scaling-aware DIRECT transpose (Algorithm 1) and
     verify zero double-quantization error,
  3. run one FP8-Flow expert FFN fwd+bwd and print the cast ledger (Fig. 2).

The port of ``examples/quickstart.py``: the hand-written kernels on the
card, their plain twins with ``--device cpu``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import casts
from repro_torch.core.linear import expert_ffn, quantize_entry
from repro_torch.core.quant import _dequantize_nocount, quantize_rowwise
from repro_torch.core.recipes import get_recipe
from repro_torch.core.transpose import transpose_direct
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain twins)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    r = np.random.default_rng(0)
    x = t(r.normal(size=(256, 512)))

    # 1. po2 quantization
    q = quantize_rowwise(x)
    print(f"quantized {tuple(x.shape)} -> e4m3 payload + "
          f"{tuple(q.scale.shape)} po2 scales")

    # 2. casting-free re-layout
    qt = transpose_direct(q)
    err = (_dequantize_nocount(qt) - _dequantize_nocount(q).T).abs().max()
    print(f"direct transpose max |error| vs exact relayout: {float(err):.2e}")

    # 3. FP8-Flow expert FFN: 2 explicit casts per fwd+bwd
    recipe = get_recipe("fp8_flow")
    E, C, K, F = 2, 128, 512, 256
    xe = t(r.normal(size=(E, C, K)), torch.bfloat16).requires_grad_()
    w13 = t(r.normal(size=(E, K, 2 * F)) * 0.05,
            torch.bfloat16).requires_grad_()
    w2 = t(r.normal(size=(E, F, K)) * 0.05, torch.bfloat16).requires_grad_()
    with casts.ledger() as led:
        y = expert_ffn(recipe, "swiglu", quantize_entry(recipe, xe), w13, w2)
        (y.to(torch.float32) ** 2).sum().backward()
    print(f"explicit casts in fwd+bwd: {led.activation_casts()} "
          f"(fused: {led.fused_casts()})")
    print(led.summary())
    return led


if __name__ == "__main__":
    main()
