"""The port's hand-written CUDA kernels against their plain PyTorch twins
on the card, at the serving path's shapes (full-width qwen3_moe_235b:
bucket-64 prefill, 8-slot decode) and ragged ones.  Quantize and
permute+pad are bitwise; the grouped GEMM rtol=atol=2e-2 (f32 summation
order); SwiGLU+quantize equal scales and < 1% differing payload bytes.

Every test here is marked ``gpu`` and skips where no NVIDIA GPU is
visible (a CUDA kernel has no CPU mode).  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The file imports no jax, so it runs where only the port is installed."""
import numpy as np
import pytest
import torch

from repro_torch.core.fp8 import TILE
from repro_torch.core.quant import QTensor, quantize_blockwise
from repro_torch.kernels import ops
from repro_torch.kernels.fused_permute_pad import fused_permute_pad_plain
from repro_torch.kernels.fused_swiglu_quant import (fused_swiglu_quant_plain,
                                                    swiglu_f32)
from repro_torch.kernels.grouped_gemm_fp8 import grouped_gemm_fp8_plain
from repro_torch.kernels.quantize import quantize_rowwise_plain


def _x(seed, *shape, spread=1.5):
    r = np.random.default_rng(seed)
    return (r.normal(size=shape) * np.exp(r.normal(size=shape) * spread)
            ).astype(np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k", [(64, 4096), (8, 4096), (40, 384)])
def test_quantize_kernel_on_card(card, m, k):
    x = torch.from_numpy(_x(2, m, k)).to(card).to(torch.bfloat16)
    q = ops.quantize_rowwise(x)
    dp, sp = quantize_rowwise_plain(x)
    assert torch.equal(q.data.view(torch.uint8), dp.view(torch.uint8))
    assert torch.equal(q.scale, sp)


@pytest.mark.gpu
def test_permute_pad_kernel_on_card(card):
    r = np.random.default_rng(4)
    q = ops.quantize_rowwise(torch.from_numpy(_x(3, 64, 4096)).to(card))
    row_map = torch.from_numpy(r.integers(-1, 64, 640).astype(np.int32)
                               ).to(card)
    qk = ops.fused_permute_pad(q, row_map)
    dp, sp = fused_permute_pad_plain(q.data, q.scale, row_map)
    assert torch.equal(qk.data.view(torch.uint8), dp.view(torch.uint8))
    assert torch.equal(qk.scale, sp)


@pytest.mark.gpu
@pytest.mark.parametrize("e,c,k,n", [(8, 8, 4096, 3072), (4, 128, 1536, 4096),
                                     (3, 40, 384, 256)])
def test_grouped_gemm_kernel_on_card(card, e, c, k, n):
    qx = ops.quantize_rowwise(torch.from_numpy(_x(5, e * c, k, spread=0.5)
                                               ).to(card))
    qx = QTensor(qx.data.reshape(e, c, k), qx.scale.reshape(e, c, k // TILE),
                 (1, 1, TILE))
    w = torch.from_numpy(_x(6, e, k, n, spread=0.3) * 0.05).to(card)
    qw = quantize_blockwise(w)
    out = ops.grouped_gemm_fp8(qx, qw).to(torch.float32)
    ref = grouped_gemm_fp8_plain(qx.data, qx.scale, qw.data, qw.scale)
    torch.testing.assert_close(out, ref.to(torch.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("m,f", [(16384, 1536), (8, 1536), (40, 256)])
def test_swiglu_quant_kernel_on_card(card, m, f):
    h = torch.from_numpy(_x(11, m, 2 * f, spread=0.5)).to(card).to(
        torch.bfloat16)
    qk = ops.fused_swiglu_quant(h)
    dp, sp = fused_swiglu_quant_plain(h)
    assert torch.equal(qk.scale, sp)
    diff = (qk.data.view(torch.uint8) != dp.view(torch.uint8))
    assert diff.to(torch.float32).mean().item() < 0.01
    assert swiglu_f32(h).isfinite().all()


@pytest.mark.gpu
def test_engine_on_card_launches_every_kernel(card):
    """A short reduced() trace through the engine on the card goes through
    all four kernels; every request finishes and every page comes back."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core.recipes import get_recipe
    from repro_torch.models.lm import init_params
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import Request

    cfg = get_arch("qwen3_moe_235b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    ecfg = ServeConfig(max_batch=4, page_size=8, n_pages=32,
                       max_pages_per_req=4, token_budget=128,
                       prefill_buckets=(16,), w8_weights=True)
    r = np.random.default_rng(5)
    prompts = [[int(t) for t in r.integers(1, cfg.vocab, int(r.integers(4, 12)))]
               for _ in range(5)]
    eng = ServeEngine(cfg, get_recipe("fp8_flow"), params, ecfg,
                      device=card)
    reqs = [Request(prompt=p, max_new_tokens=3) for p in prompts]
    kernels.reset_launches()
    res = eng.run(reqs, realtime=False)
    assert all(len(res[q.rid]["tokens"]) == 3 for q in reqs)
    assert eng.alloc.free_pages == ecfg.n_pages - 1
    assert all(n > 0 for n in kernels.LAUNCHES.values())
