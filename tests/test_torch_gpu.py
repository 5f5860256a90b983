"""The port's hand-written CUDA kernels against their plain PyTorch twins
on the card, at the serving path's shapes (full-width qwen3_moe_235b:
bucket-64 prefill, 8-slot decode), the training path's and ragged ones.
Quantize, permute+pad and the scaling-aware transpose are bitwise; the
grouped GEMMs (NN, transposed-weight and NT) rtol=atol=2e-2 (f32
summation order); the quant-out GEMM equal scales and payload codes within
one on <= 0.1% of lanes; SwiGLU+quantize equal scales and < 1% differing
payload bytes.  A reduced() train step on the card records the two
activation casts of a MoE layer although its backward runs on autograd's
device thread.

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
from repro_torch.kernels.fp8_transpose import fp8_transpose_plain
from repro_torch.kernels.fused_permute_pad import fused_permute_pad_plain
from repro_torch.kernels.fused_swiglu_quant import (fused_swiglu_quant_plain,
                                                    swiglu_f32)
from repro_torch.kernels.grouped_gemm_fp8 import grouped_gemm_fp8_plain
from repro_torch.kernels.grouped_gemm_nt_fp8 import grouped_gemm_nt_fp8_plain
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
    the serving path's four kernels; every request finishes and every page
    comes back."""
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
    serving = ("quantize_rowwise", "fused_permute_pad", "grouped_gemm_fp8",
               "fused_swiglu_quant")
    assert all(kernels.LAUNCHES[name] > 0 for name in serving)


def _rowq(card, seed, e, m, k, spread=0.5, scale=1.0):
    q = ops.quantize_rowwise(torch.from_numpy(
        _x(seed, e * m, k, spread=spread) * scale).to(card))
    return QTensor(q.data.reshape(e, m, k), q.scale.reshape(e, m, k // TILE),
                   (1, 1, TILE))


def _t_view(qw):
    """The transposed view of a stored (E, N, K) block weight (what
    core.linear._block_t makes); ops reads it with the kernel's w_trans."""
    return QTensor(qw.data.transpose(1, 2), qw.scale.transpose(1, 2), qw.tile)


def _ordinal(b):
    b = b.to(torch.int32)
    return torch.where(b >= 128, -(b & 0x7F), b & 0x7F)


@pytest.mark.gpu
@pytest.mark.parametrize("e,m,k", [(4, 256, 4096), (3, 128, 384),
                                   (2, 384, 256)])
def test_fp8_transpose_kernel_on_card(card, e, m, k):
    q = _rowq(card, 7, e, m, k, spread=2.5)
    qt = ops.fp8_transpose(q)
    dp, sp = fp8_transpose_plain(q.data, q.scale)
    assert torch.equal(qt.data.view(torch.uint8), dp.view(torch.uint8))
    assert torch.equal(qt.scale, sp)


@pytest.mark.gpu
def test_fp8_transpose_subnormal_edge_on_card(card):
    """Rows 2**22 apart in one tile: rebasing shifts deep into and past the
    subnormal range (tests/test_kernels.py's edge case, on the kernel)."""
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 128, 256)).astype(np.float32)
    x[:, ::2] *= 2.0 ** 12
    x[:, 1::2] *= 2.0 ** -10
    q = ops.quantize_rowwise(torch.from_numpy(x.reshape(256, 256)).to(card))
    q = QTensor(q.data.reshape(2, 128, 256), q.scale.reshape(2, 128, 2),
                (1, 1, TILE))
    qt = ops.fp8_transpose(q)
    dp, sp = fp8_transpose_plain(q.data, q.scale)
    assert torch.equal(qt.data.view(torch.uint8), dp.view(torch.uint8))
    assert torch.equal(qt.scale, sp)


@pytest.mark.gpu
@pytest.mark.parametrize("e,m,n,c", [(2, 4096, 384, 256), (3, 256, 128, 384)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_nt_kernel_on_card(card, e, m, n, c, out_dtype):
    qa = _rowq(card, 8, e, m, c)
    qb = _rowq(card, 9, e, n, c, scale=0.05)
    out = ops.grouped_gemm_nt_fp8(qa, qb, out_dtype)
    ref = grouped_gemm_nt_fp8_plain(qa.data, qa.scale, qb.data, qb.scale,
                                    out_dtype)
    assert out.dtype == out_dtype
    torch.testing.assert_close(out.to(torch.float32), ref.to(torch.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("e,c,k,n", [(2, 256, 3072, 4096), (3, 40, 384, 256),
                                     (4, 8, 256, 128)])
def test_grouped_gemm_transposed_weight_on_card(card, e, c, k, n):
    qx = _rowq(card, 10, e, c, k)
    qw = quantize_blockwise(torch.from_numpy(
        _x(11, e, n, k, spread=0.3) * 0.05).to(card))       # stored (E, N, K)
    out = ops.grouped_gemm_fp8(qx, _t_view(qw)).to(torch.float32)
    ref = grouped_gemm_fp8_plain(qx.data, qx.scale, qw.data, qw.scale,
                                 w_trans=True).to(torch.float32)
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("w_trans", [True, False])
@pytest.mark.parametrize("e,c,k,n", [(2, 256, 3072, 4096), (3, 40, 384, 256)])
def test_grouped_gemm_quant_out_on_card(card, w_trans, e, c, k, n):
    qx = _rowq(card, 12, e, c, k)
    shape = (e, n, k) if w_trans else (e, k, n)
    qw = quantize_blockwise(torch.from_numpy(
        _x(13, *shape, spread=0.3) * 0.05).to(card))
    q = ops.grouped_gemm_fp8_quant_out(qx, _t_view(qw) if w_trans else qw)
    dp, sp = grouped_gemm_fp8_plain(qx.data, qx.scale, qw.data, qw.scale,
                                    w_trans=w_trans, quant_out=True)
    assert torch.equal(q.scale, sp)
    dk, dpl = q.data.view(torch.uint8), dp.view(torch.uint8)
    differ = dk != dpl
    assert differ.to(torch.float32).mean().item() <= 1e-3
    assert (_ordinal(dk) - _ordinal(dpl)).abs().max().item() <= 1


@pytest.mark.gpu
def test_train_step_on_card_counts_two_casts_per_layer(card):
    """One reduced() train step on the card: its backward runs on
    autograd's device thread, and the ledger still reads 2 activation casts
    per MoE layer; every kernel of the training path launches."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core import casts
    from repro_torch.core.recipes import get_recipe
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    cfg = get_arch("qwen3_moe_235b").reduced()
    opt = AdamWConfig(lr=1e-3)
    state = init_train_state(cfg, opt, seed=0, device=card)
    step = make_train_step(cfg, get_recipe("fp8_flow"), opt)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=2), 0, device=card)
    kernels.reset_launches()
    with casts.ledger() as led:
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert led.activation_casts() == 2 * cfg.n_layers, led.summary()
    assert np.isfinite(float(metrics["loss"]))
    assert all(n > 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES


def _named_grads(params, prefix=""):
    out = {}
    for k, v in params.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_named_grads(v, name))
        else:
            out[name] = v.grad.double().cpu()
    return out


@pytest.mark.gpu
def test_train_grads_on_card_match_cpu(card):
    """The gradients of one reduced() forward+backward on the card (the
    hand-written FP8 backward) against the CPU path's (the twins), from the
    same params and batch: cosine >= 0.999 for every leaf, and the expert
    and router leaves nonzero.  8 x 64 tokens: with fewer, every expert
    block holds padding rows and the scaling-aware transpose flushes all of
    Wgrad-1 on both paths (ROADMAP.md, Queue 3)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.recipes import get_recipe
    from repro_torch.data.pipeline import DataConfig, make_batch_np
    from repro_torch.models.lm import forward, init_params
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.weights import params_to

    cfg = get_arch("qwen3_moe_235b").reduced()
    batch_np = make_batch_np(DataConfig(vocab=cfg.vocab, seq_len=64,
                                        global_batch=8), 0)
    grads = {}
    for name, d in (("cuda", card), ("cpu", torch.device("cpu"))):
        params = params_to(init_params(cfg, seed=0, device="cpu"), d)
        for p in tree_leaves(params):
            p.requires_grad_()
        batch = {k: torch.from_numpy(v).to(d) for k, v in batch_np.items()}
        loss, _ = forward(cfg, get_recipe("fp8_flow"), params, batch)
        loss.backward()
        grads[name] = _named_grads(params)
    for leaf in ("layers/we13", "layers/we2", "layers/w_router"):
        assert grads["cpu"][leaf].abs().max() > 0, leaf
    for leaf, g in grads["cpu"].items():
        a = grads["cuda"][leaf].reshape(-1)
        b = g.reshape(-1)
        cos = float(a @ b) / max(float(a.norm() * b.norm()), 1e-300)
        assert cos >= 0.999, (leaf, cos)
