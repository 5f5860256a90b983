"""The port's hand-written CUDA kernels against their plain PyTorch twins
on the card, at the serving path's shapes (full-width qwen3_moe_235b:
bucket-64 prefill, 8-slot decode), the training path's and ragged ones.
Quantize, permute+pad and the scaling-aware transpose are bitwise; the
grouped GEMMs (NN, transposed-weight and NT) rtol=atol=2e-2 (f32
summation order); the quant-out GEMM equal scales and payload codes within
one on <= 0.1% of lanes; SwiGLU+quantize equal scales and < 1% differing
payload bytes.  A reduced() train step on the card records the two
activation casts of a MoE layer although its backward runs on autograd's
device thread.  The masked kernels (#5, #6, #11) equal their padded
kernels bit for bit on the dispatch layout and the fused SwiGLU GEMM-1
(#7) equals the GEMM then the SwiGLU kernel; the masked recipe's train
steps and served tokens equal the padded recipe's.

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
from repro_torch.kernels.quantize import (quantize_rowwise_linear_plain,
                                          quantize_rowwise_plain)
from torch_quant_inputs import KINDS, quant_inputs


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


# the kernels of the padded recipe's train step (the masked recipe's four
# replace #3, #4, #8 and #10 there)
PADDED_TRAIN_KERNELS = ("quantize_rowwise", "fused_permute_pad",
                        "grouped_gemm_fp8", "fused_swiglu_quant",
                        "fp8_transpose", "grouped_gemm_nt_fp8",
                        "grouped_gemm_fp8_quant_out")


def _rowq(card, seed, e, m, k, spread=0.5, scale=1.0, scale_mode="po2"):
    q = ops.quantize_rowwise(torch.from_numpy(
        _x(seed, e * m, k, spread=spread) * scale).to(card), scale_mode)
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
    assert all(kernels.LAUNCHES[n] > 0 for n in PADDED_TRAIN_KERNELS), \
        kernels.LAUNCHES


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


# ---------------------------------------------------------------------------
# The masked layout (#5, #6, #7, #11).
# ---------------------------------------------------------------------------
def _masked_m(card, e, c, seed):
    """Live-row counts with an empty expert, a full one and random ones."""
    mm = np.random.default_rng(seed).integers(0, c + 1, e)
    mm[0], mm[-1] = 0, c
    return torch.from_numpy(mm.astype(np.int32)).to(card)


def _dispatch_rowq(card, seed, e, c, k, mm, scale=1.0):
    """Row-quantized (E, C, K) with rows beyond masked_m zero (payload 0,
    scale 1.0): the dispatch layout."""
    x = torch.from_numpy(_x(seed, e, c, k, spread=0.5) * scale).to(card)
    live = torch.arange(c, device=card)[None, :] < mm[:, None]
    q = ops.quantize_rowwise(torch.where(live[..., None], x, 0.0)
                             .reshape(e * c, k))
    return QTensor(q.data.reshape(e, c, k), q.scale.reshape(e, c, k // TILE),
                   (1, 1, TILE))


def _u8(t):
    return t.view(torch.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("w_trans", [False, True])
@pytest.mark.parametrize("e,c,k,n", [(4, 256, 4096, 3072), (8, 8, 4096, 1536),
                                     (3, 40, 384, 256)])
def test_masked_gemm_kernels_on_card(card, w_trans, e, c, k, n):
    """#5 and #6 against their twins (rtol=atol=2e-2; equal scales and
    codes within one on <= 0.1% of lanes) and bitwise against the padded
    kernels #3 and #4 on the dispatch layout."""
    from repro_torch.kernels.grouped_gemm_fp8 import (
        masked_grouped_gemm_fp8_plain)
    mm = _masked_m(card, e, c, 14)
    qx = _dispatch_rowq(card, 15, e, c, k, mm)
    shape = (e, n, k) if w_trans else (e, k, n)
    qw = quantize_blockwise(torch.from_numpy(
        _x(16, *shape, spread=0.3) * 0.05).to(card))
    qwv = _t_view(qw) if w_trans else qw
    args = (qx.data, qx.scale, qw.data, qw.scale, mm)
    out = ops.grouped_gemm_fp8_masked(qx, qwv, mm)
    ref = masked_grouped_gemm_fp8_plain(*args, w_trans=w_trans)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(out.view(torch.int16),
                       ops.grouped_gemm_fp8(qx, qwv).view(torch.int16))
    q = ops.grouped_gemm_fp8_masked_quant_out(qx, qwv, mm)
    dp, sp = masked_grouped_gemm_fp8_plain(*args, w_trans=w_trans,
                                           quant_out=True)
    assert torch.equal(q.scale, sp)
    differ = _u8(q.data) != _u8(dp)
    assert differ.to(torch.float32).mean().item() <= 1e-3
    assert (_ordinal(_u8(q.data)) - _ordinal(_u8(dp))).abs().max().item() <= 1
    qp = ops.grouped_gemm_fp8_quant_out(qx, qwv)
    assert torch.equal(_u8(q.data), _u8(qp.data))
    assert torch.equal(q.scale, qp.scale)


@pytest.mark.gpu
def test_masked_gemm_kernel_tile_granular_on_card(card):
    """Nonzero payload beyond masked_m: dead 128-row groups are zero, the
    partly live group is computed whole, as the twin."""
    from repro_torch.kernels.grouped_gemm_fp8 import (
        masked_grouped_gemm_fp8_plain)
    qx = _rowq(card, 17, 2, 256, 512)
    qw = quantize_blockwise(torch.from_numpy(
        _x(18, 2, 512, 256, spread=0.3) * 0.05).to(card))
    mm = torch.tensor([37, 200], dtype=torch.int32, device=card)
    out = ops.grouped_gemm_fp8_masked(qx, qw, mm).float()
    ref = masked_grouped_gemm_fp8_plain(qx.data, qx.scale, qw.data, qw.scale,
                                        mm).float()
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
    assert not out[0, 128:].any() and out[0, 37:128].abs().sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("e,c,k,f", [(4, 256, 4096, 1536), (8, 8, 4096, 1536),
                                     (3, 40, 384, 256)])
def test_swiglu_epilogue_kernel_on_card(card, e, c, k, f):
    """#7 against its twin (equal scales, < 1% of payload bytes off, by
    the sigmoid's last bits) and bitwise against #3 (bf16 h) then #8."""
    from repro_torch.kernels.grouped_gemm_swiglu_quant import (
        masked_grouped_gemm_swiglu_quant_plain)
    mm = _masked_m(card, e, c, 19)
    qx = _dispatch_rowq(card, 20, e, c, k, mm)
    qw = quantize_blockwise(torch.from_numpy(
        _x(21, e, k, 2 * f, spread=0.3) * 0.05).to(card))
    q = ops.grouped_gemm_swiglu_quant_masked(qx, qw, mm)
    dp, sp = masked_grouped_gemm_swiglu_quant_plain(qx.data, qx.scale,
                                                    qw.data, qw.scale, mm)
    assert torch.equal(q.scale, sp)
    assert (_u8(q.data) != _u8(dp)).to(torch.float32).mean().item() < 0.01
    h = ops.grouped_gemm_fp8(qx, qw)
    pair = ops.fused_swiglu_quant(h.reshape(e * c, 2 * f))
    assert torch.equal(_u8(q.data), _u8(pair.data).reshape(e, c, f))
    assert torch.equal(q.scale, pair.scale.reshape(e, c, f // TILE))


@pytest.mark.gpu
@pytest.mark.parametrize("e,m,n,c", [(4, 4096, 3072, 256), (3, 256, 128, 384)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_masked_nt_kernel_on_card(card, e, m, n, c, out_dtype):
    """#11 against its twin (rtol=atol=2e-2) and bitwise against #10 when
    the dead token columns are zero."""
    from repro_torch.kernels.grouped_gemm_nt_fp8 import (
        masked_grouped_gemm_nt_fp8_plain)
    mm = _masked_m(card, e, c, 22)
    live = (torch.arange(c, device=card)[None, None, :] < mm[:, None, None])

    def q(seed, rows, scale):
        x = torch.from_numpy(_x(seed, e, rows, c, spread=0.5) * scale).to(card)
        qq = ops.quantize_rowwise(torch.where(live, x, 0.0).reshape(-1, c))
        return QTensor(qq.data.reshape(e, rows, c),
                       qq.scale.reshape(e, rows, c // TILE), (1, 1, TILE))

    qa, qb = q(23, m, 1.0), q(24, n, 0.05)
    out = ops.grouped_gemm_nt_fp8_masked(qa, qb, mm, out_dtype)
    ref = masked_grouped_gemm_nt_fp8_plain(qa.data, qa.scale, qb.data,
                                           qb.scale, mm, out_dtype)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    pad = ops.grouped_gemm_nt_fp8(qa, qb, out_dtype)
    assert torch.equal(out.view(torch.uint8), pad.view(torch.uint8))


MASKED_KERNELS = ("masked_grouped_gemm_fp8", "masked_grouped_gemm_fp8_quant_out",
                  "masked_grouped_gemm_swiglu_quant",
                  "masked_grouped_gemm_nt_fp8")


@pytest.mark.gpu
def test_masked_train_steps_on_card_equal_padded(card):
    """Two reduced() train steps on the card with the masked recipe give
    the padded recipe's losses and grad norms bit for bit, through the
    four masked kernels and none of the padded #3, #4, #8, #10."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core.recipes import get_recipe
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    cfg = get_arch("qwen3_moe_235b").reduced()
    opt = AdamWConfig(lr=1e-3)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8), 0, device=card)
    out, launches = {}, {}
    for name, recipe in (("padded", get_recipe("fp8_flow")),
                         ("masked", get_recipe("fp8_flow", masked_experts=True,
                                               swiglu_epilogue=True))):
        state = init_train_state(cfg, opt, seed=0, device=card)
        step = make_train_step(cfg, recipe, opt, total_steps=10,
                               warmup_steps=1)
        kernels.reset_launches()
        out[name] = []
        for _ in range(2):
            state, m = step(state, batch)
            out[name].append((m["loss"].item(), m["grad_norm"].item()))
        launches[name] = dict(kernels.LAUNCHES)
        del state
    assert out["masked"] == out["padded"], out
    assert all(launches["masked"][k] > 0 for k in MASKED_KERNELS)
    assert all(launches["masked"][k] == 0 for k in (
        "grouped_gemm_fp8", "grouped_gemm_fp8_quant_out",
        "fused_swiglu_quant", "grouped_gemm_nt_fp8"))


@pytest.mark.gpu
def test_masked_engine_on_card_generates_padded_tokens(card):
    """A short reduced() trace through the engine on the card with the
    masked recipe: exactly the padded engine's tokens, through #5 and #7
    and none of #3 and #8."""
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
    tokens = {}
    for name, recipe in (("padded", get_recipe("fp8_flow")),
                         ("masked", get_recipe("fp8_flow", masked_experts=True,
                                               swiglu_epilogue=True))):
        eng = ServeEngine(cfg, recipe, params, ecfg, device=card)
        reqs = [Request(prompt=p, max_new_tokens=4) for p in prompts]
        kernels.reset_launches()
        res = eng.run(reqs, realtime=False)
        tokens[name] = [res[q.rid]["tokens"] for q in reqs]
    assert tokens["masked"] == tokens["padded"]
    assert kernels.LAUNCHES["masked_grouped_gemm_fp8"] > 0
    assert kernels.LAUNCHES["masked_grouped_gemm_swiglu_quant"] > 0
    assert kernels.LAUNCHES["grouped_gemm_fp8"] == 0
    assert kernels.LAUNCHES["fused_swiglu_quant"] == 0


# ---------------------------------------------------------------------------
# The NN tile loop's edges (#3-#7): ragged C, one and many K steps, N = 128,
# both weight layouts, every kind of 128-row group under masking, the
# quantizing epilogue's saturation and tiny rows, a NaN byte in x.
# ---------------------------------------------------------------------------
EDGE_MASKED_M = (0, 1, 127, 128, 129)   # one expert each, then masked_m = C


def _edge_masked_m(card, c):
    return torch.tensor(EDGE_MASKED_M + (c,), dtype=torch.int32, device=card)


def _dead_rows(mm, c):
    """(E, C) bool: the rows of 128-row groups at or beyond masked_m."""
    starts = torch.arange(c, device=mm.device) // TILE * TILE
    return starts[None, :] >= mm[:, None]


def _codes_within_one(a, b, max_frac):
    ua, ub = _u8(a), _u8(b)
    assert (ua != ub).to(torch.float32).mean().item() <= max_frac
    assert (_ordinal(ua) - _ordinal(ub)).abs().max().item() <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("w_trans", [False, True])
@pytest.mark.parametrize("k", [128, 4096])
@pytest.mark.parametrize("c", [1, 8, 17, 65, 129, 257])
def test_nn_tile_loop_edges_on_card(card, c, k, w_trans):
    """#3 and #4 against their twins (rtol=atol=2e-2; equal scales, codes
    within one on <= 0.1% of lanes) at N = 128; #5 and #6 bit for bit the
    padded kernels on the dispatch layout, dead groups written as bf16 +0
    or payload 0 with scale 1.0."""
    from repro_torch.kernels.grouped_gemm_fp8 import (
        masked_grouped_gemm_fp8_plain)
    n = 128
    mm = _edge_masked_m(card, c)
    e = mm.numel()
    qx = _dispatch_rowq(card, 30 + c, e, c, k, mm)
    shape = (e, n, k) if w_trans else (e, k, n)
    qw = quantize_blockwise(torch.from_numpy(
        _x(31, *shape, spread=0.3) * 0.05).to(card))
    qwv = _t_view(qw) if w_trans else qw
    args = (qx.data, qx.scale, qw.data, qw.scale)
    out = ops.grouped_gemm_fp8(qx, qwv)
    ref = grouped_gemm_fp8_plain(*args, w_trans=w_trans)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    qp = ops.grouped_gemm_fp8_quant_out(qx, qwv)
    dp, sp = grouped_gemm_fp8_plain(*args, w_trans=w_trans, quant_out=True)
    assert torch.equal(qp.scale, sp)
    _codes_within_one(qp.data, dp, 1e-3)
    dead = _dead_rows(mm, c)
    om = ops.grouped_gemm_fp8_masked(qx, qwv, mm)
    torch.testing.assert_close(
        om.float(), masked_grouped_gemm_fp8_plain(
            *args, mm, w_trans=w_trans).float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(om.view(torch.int16), out.view(torch.int16))
    assert not om.view(torch.int16)[dead].any()
    qm = ops.grouped_gemm_fp8_masked_quant_out(qx, qwv, mm)
    assert torch.equal(_u8(qm.data), _u8(qp.data))
    assert torch.equal(qm.scale, qp.scale)
    assert not _u8(qm.data)[dead].any()
    assert bool((qm.scale[dead] == 1.0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [128, 4096])
@pytest.mark.parametrize("c", [1, 8, 17, 65, 129, 257])
def test_swiglu_epilogue_edges_on_card(card, c, k):
    """#7 at F = 128 against its twin (equal scales, < 1% of payload bytes
    off) and bit for bit #3 then #8, dead groups payload 0 with scale
    1.0."""
    from repro_torch.kernels.grouped_gemm_swiglu_quant import (
        masked_grouped_gemm_swiglu_quant_plain)
    f = 128
    mm = _edge_masked_m(card, c)
    e = mm.numel()
    qx = _dispatch_rowq(card, 32 + c, e, c, k, mm)
    qw = quantize_blockwise(torch.from_numpy(
        _x(33, e, k, 2 * f, spread=0.3) * 0.05).to(card))
    q = ops.grouped_gemm_swiglu_quant_masked(qx, qw, mm)
    dp, sp = masked_grouped_gemm_swiglu_quant_plain(qx.data, qx.scale,
                                                    qw.data, qw.scale, mm)
    assert torch.equal(q.scale, sp)
    assert (_u8(q.data) != _u8(dp)).to(torch.float32).mean().item() < 0.01
    pair = ops.fused_swiglu_quant(ops.grouped_gemm_fp8(qx, qw)
                                  .reshape(e * c, 2 * f))
    assert torch.equal(_u8(q.data), _u8(pair.data).reshape(e, c, f))
    assert torch.equal(q.scale, pair.scale.reshape(e, c, f // TILE))
    dead = _dead_rows(mm, c)
    assert not _u8(q.data)[dead].any()
    assert bool((q.scale[dead] == 1.0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("w_trans", [False, True])
def test_quant_out_saturation_and_tiny_rows_on_card(card, w_trans):
    """Rows whose accumulator is +-448 * 4 (codes 0x7E / 0xFE under scale
    4), a zero row and a row whose amax is an f32 subnormal (scale 1.0,
    payload 0): the quantizing epilogue equals its twin bit for bit."""
    from repro_torch.core.fp8 import E4M3
    c, k, n = 4, 128, 128
    x = torch.zeros((1, c, k), device=card)
    x[0, 0, 0], x[0, 1, 0], x[0, 3, 1] = 1.0, -1.0, 2.0 ** -9
    sx = torch.ones((1, c, 1), device=card)
    sx[0, 3, 0] = 2.0 ** -126
    wt = torch.zeros((1, k, n), device=card)             # (K, N) values
    wt[0, 0] = torch.where(torch.arange(n, device=card) % 2 == 0, 448.0, 1.0)
    wt[0, 1] = 2.0 ** -9
    w = wt.transpose(1, 2).contiguous() if w_trans else wt
    sw = torch.full((1, 1, 1), 4.0, device=card)
    qx = QTensor(x.to(E4M3), sx, (1, 1, TILE))
    qw = QTensor(w.to(E4M3), sw, (1, TILE, TILE))
    q = ops.grouped_gemm_fp8_quant_out(qx, _t_view(qw) if w_trans else qw)
    dp, sp = grouped_gemm_fp8_plain(qx.data, sx, qw.data, sw,
                                    w_trans=w_trans, quant_out=True)
    assert torch.equal(_u8(q.data), _u8(dp)) and torch.equal(q.scale, sp)
    assert q.scale.flatten().tolist() == [4.0, 4.0, 1.0, 1.0]
    assert bool((_u8(q.data)[0, 0, ::2] == 0x7E).all())
    assert bool((_u8(q.data)[0, 1, ::2] == 0xFE).all())
    assert not _u8(q.data)[0, 2:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("w_trans", [False, True])
def test_nan_byte_in_x_propagates_on_card(card, w_trans):
    """An e4m3 NaN byte in x makes that row's outputs NaN, and no other
    row's, as in the twin: bf16 out NaN, quant-out scale 1.0 and NaN
    payload."""
    from repro_torch.core.fp8 import E4M3
    e, c, k, n = 2, 17, 256, 128
    qx = _rowq(card, 40, e, c, k)
    data = _u8(qx.data).clone()
    data[1, 5, 200] = 0x7F
    qx = QTensor(data.view(E4M3), qx.scale, qx.tile)
    shape = (e, n, k) if w_trans else (e, k, n)
    qw = quantize_blockwise(torch.from_numpy(
        _x(41, *shape, spread=0.3) * 0.05).to(card))
    qwv = _t_view(qw) if w_trans else qw
    args = (qx.data, qx.scale, qw.data, qw.scale)
    out = ops.grouped_gemm_fp8(qx, qwv).float()
    ref = grouped_gemm_fp8_plain(*args, w_trans=w_trans).float()
    nan = ref.isnan()
    assert nan[1, 5].all() and int(nan.sum()) == n
    assert torch.equal(out.isnan(), nan)
    torch.testing.assert_close(out[~nan], ref[~nan], rtol=2e-2, atol=2e-2)
    q = ops.grouped_gemm_fp8_quant_out(qx, qwv)
    dp, sp = grouped_gemm_fp8_plain(*args, w_trans=w_trans, quant_out=True)
    assert torch.equal(q.scale, sp) and float(q.scale[1, 5, 0]) == 1.0
    qnan = q.data.float().isnan()
    assert torch.equal(qnan, dp.float().isnan()) and qnan[1, 5].all()
    _codes_within_one(q.data[~qnan], dp[~qnan], 1e-3)


# ---------------------------------------------------------------------------
# Edges of the NT Wgrad loop (#10, #11): one C step to many, M or N = 128,
# one expert, both output dtypes, every masked_m kind, saturated codes,
# row scales spread over 2**-24 .. 2**4 in both operands, a NaN byte.
# ---------------------------------------------------------------------------
def _nt_operand(card, seed, e, rows, c, mm):
    """(E, rows, C) e4m3 + (E, rows, C/128) scales on the dispatch layout of
    masked_m (token columns at or beyond masked_m[e] zero, an all-zero
    step's scale 1.0): integer codes in -4..4, rows 0 and 5 saturated at
    +-448, and a scale 2**-24 .. 2**4 drawn for every (row, step), so a
    kernel that mixes up row and column scales, or steps, fails.  Every
    product is exact and every step's sum fits 13 bits of its operands'
    grid, so the tensor cores sum it exactly (FP8 or f16 alike) and the
    comparison holds at any magnitude."""
    from repro_torch.core.fp8 import E4M3
    r = np.random.default_rng(seed)
    mmn = mm.cpu().numpy()
    v = r.integers(-4, 5, (e, rows, c)).astype(np.float32)
    v[:, [0, 5]] = 448.0 * r.choice([-1.0, 1.0], (e, 2, c))
    v = np.where(np.arange(c)[None, None, :] < mmn[:, None, None], v, 0.0)
    s = np.exp2(r.integers(-24, 5, (e, rows, c // TILE)))
    dead = np.arange(0, c, TILE)[None, None, :] >= mmn[:, None, None]
    s = np.where(dead, 1.0, s)
    return QTensor(torch.from_numpy(v.astype(np.float32)).to(card).to(E4M3),
                   torch.from_numpy(s.astype(np.float32)).to(card),
                   (1, 1, TILE))


def _check_nt(qa, qb, mm, out_dtype):
    """#10 and #11 equal to their twins (rtol=atol=0, NaN where the twin
    has NaN: _nt_operand's sums are exact, so any difference is a fault,
    a dropped or misapplied small scale included), #11 bit for bit #10;
    returns #10's output."""
    from repro_torch.kernels.grouped_gemm_nt_fp8 import (
        masked_grouped_gemm_nt_fp8_plain)
    args = (qa.data, qa.scale, qb.data, qb.scale)
    out = ops.grouped_gemm_nt_fp8(qa, qb, out_dtype)
    ref = grouped_gemm_nt_fp8_plain(*args, out_dtype)
    assert out.dtype == out_dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=0,
                               equal_nan=True)
    om = ops.grouped_gemm_nt_fp8_masked(qa, qb, mm, out_dtype)
    torch.testing.assert_close(
        om.float(), masked_grouped_gemm_nt_fp8_plain(*args, mm, out_dtype)
        .float(), rtol=0, atol=0, equal_nan=True)
    assert torch.equal(_u8(om), _u8(out))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(128, 384), (256, 128), (640, 128)])
@pytest.mark.parametrize("c", [128, 256, 384, 1024])
def test_nt_loop_edges_on_card(card, c, m, n, out_dtype):
    """Six experts with masked_m 0, 1, 127, 128, 129 and C: the expert with
    none is +0 everywhere.  M = 640 at C <= 256 runs the loads four steps
    ahead (the kernel's deep ring), the others one step."""
    mm = _edge_masked_m(card, c)
    e = mm.numel()
    out = _check_nt(_nt_operand(card, 50 + c, e, m, c, mm),
                    _nt_operand(card, 51 + c, e, n, c, mm), mm, out_dtype)
    assert not _u8(out[0]).any()


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,live", [(128, 128), (1024, 385)])
def test_nt_loop_one_expert_on_card(card, c, live, out_dtype):
    """E = 1, M = N = 128: a single tile, so a single block walks it."""
    mm = torch.tensor([live], dtype=torch.int32, device=card)
    _check_nt(_nt_operand(card, 52, 1, 128, c, mm),
              _nt_operand(card, 53, 1, 128, c, mm), mm, out_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_nt_nan_byte_in_a_propagates_on_card(card, out_dtype):
    """An e4m3 NaN byte in a (a live token of expert 1) makes that row of
    the output NaN, and no other, as in the twin; masked == padded."""
    from repro_torch.core.fp8 import E4M3
    e, m, n, c = 2, 128, 256, 256
    mm = torch.tensor([0, 200], dtype=torch.int32, device=card)
    qa = _nt_operand(card, 54, e, m, c, mm)
    qb = _nt_operand(card, 55, e, n, c, mm)
    data = _u8(qa.data).clone()
    data[1, 9, 150] = 0x7F
    qa = QTensor(data.view(E4M3), qa.scale, qa.tile)
    nan = _check_nt(qa, qb, mm, out_dtype).isnan()
    assert nan[1, 9].all() and int(nan.sum()) == n


# ---------------------------------------------------------------------------
# The scaling-aware transpose (#9) and the row-wise quantize (#1), bitwise
# against their twins: every rebase path of the transpose's word-wise
# rebase (k = 0, the subtraction, the table, the sign bits from k = 19),
# its persistent tile walk, and the quantize's flat passes of 8 tiles a
# warp.
# ---------------------------------------------------------------------------
def _transpose_bitwise(d, s):
    qt = ops.fp8_transpose(QTensor(d, s, (1, 1, TILE)))
    dp, sp = fp8_transpose_plain(d, s)
    assert torch.equal(qt.data.view(torch.uint8), dp.view(torch.uint8))
    assert torch.equal(qt.scale, sp)


def _e4m3(card, a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint8)).view(
        torch.float8_e4m3fn).to(card)


@pytest.mark.gpu
def test_fp8_transpose_every_encoding_and_k_on_card(card):
    """Every e4m3 encoding (NaN 0x7f / 0xff included) rebased by every k in
    0..40 and by 252, from explicit po2 row scales (s_max = 2**126): each
    tile holds two rows a k (encodings 0..127 and 128..255, columns
    shuffled) and random rows at k = 0, in a new row order each tile."""
    r = np.random.default_rng(21)
    e, m, k = 2, 256, 384
    ks = list(range(41)) + [252]
    roles = [(kk, np.arange(h * 128, h * 128 + 128)) for kk in ks
             for h in (0, 1)]
    d = np.empty((e, m, k), np.uint8)
    s = np.empty((e, m, k // TILE), np.float32)
    for ei in range(e):
        for mb in range(m // TILE):
            for kb in range(k // TILE):
                rows = roles + [(0, r.integers(0, 256, TILE))
                                for _ in range(TILE - len(roles))]
                for i, j in enumerate(r.permutation(TILE)):
                    kk, enc = rows[j]
                    d[ei, mb * TILE + i, kb * TILE:(kb + 1) * TILE] = \
                        r.permutation(enc)
                    s[ei, mb * TILE + i, kb] = 2.0 ** (126 - kk)
    _transpose_bitwise(_e4m3(card, d), torch.from_numpy(s).to(card))


@pytest.mark.gpu
@pytest.mark.parametrize("e,m,k", [(1, 128, 128), (1009, 128, 128),
                                   (3, 640, 1152), (5, 2048, 1280)])
def test_fp8_transpose_tile_walk_on_card(card, e, m, k):
    """One tile; 1009 tiles (a prime: no multiple of the persistent grid);
    odd tile grids; more tiles than the grid has blocks.  Random bytes and
    row scales over 2**+-24, so every rebase path runs in every tile."""
    r = np.random.default_rng(e * 7 + m + k)
    d = _e4m3(card, r.integers(0, 256, (e, m, k)))
    s = torch.from_numpy(np.exp2(r.integers(-24, 25, (e, m, k // TILE))
                                 ).astype(np.float32)).to(card)
    _transpose_bitwise(d, s)


def _quantize_bitwise(x, scale_mode="po2"):
    plain = quantize_rowwise_plain if scale_mode == "po2" else \
        quantize_rowwise_linear_plain
    q = ops.quantize_rowwise(x, scale_mode)
    dp, sp = plain(x)
    assert torch.equal(q.data.view(torch.uint8), dp.view(torch.uint8))
    assert torch.equal(q.scale, sp)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", [(1, 128), (1, 4096), (3, 128), (9, 384),
                                 (77, 1152), (20001, 384), (8191, 4096),
                                 (65537, 640)])
def test_quantize_kernel_edges_on_card(card, dtype, m, k):
    """K = 128; M = 1; tile counts that end inside a warp's pass (2 tiles
    below 2**14 tiles, 8 from there on: 60,003 at 20001 x 384) and inside
    a block's; more tiles than one persistent pass covers (262,112 at
    8191 x 4096; 327,685 at 65537 x 640, ending mid-pass)."""
    _quantize_bitwise(torch.from_numpy(_x(m + k, m, k)).to(card).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_kernel_special_values_on_card(card, dtype):
    """NaN, +-inf, subnormal, zero and -0 values, alone in a tile and beside
    numbers; huge and tiny normal tiles."""
    x = _x(31, 64, 512)
    x[0, 5] = np.nan
    x[1, :128] = np.nan
    x[2, 130] = np.inf
    x[3, 300] = -np.inf
    x[4, 128:256] = np.inf
    x[5, :128] = 3e-40 * np.sign(x[5, :128])        # f32 / bf16 subnormal
    x[6, :128] = 3e-40
    x[6, 64] = 1.0
    x[7] = 0.0
    x[8, :128] = -0.0
    x[9] *= 1e-37
    x[10] = np.clip(x[10], -1, 1) * 3e38
    _quantize_bitwise(torch.from_numpy(x).to(card).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_kernel_boundary_inputs_on_card(card, kind, dtype):
    """test_torch_quant.py's inputs (amax exactly 448 * 2**e, |exp| >= 13,
    zero tiles) on the kernel."""
    rng = np.random.default_rng([KINDS.index(kind), 7])
    x = quant_inputs(kind, rng, (48, 384))
    _quantize_bitwise(torch.from_numpy(x).to(card).to(dtype))


# ---------------------------------------------------------------------------
# The fused SwiGLU + quantize (#8) and the permute + pad (#2) redesigns:
# #8 against its twin at the decode shape, at tile counts that end inside
# a warp (two tiles) and inside a block (16), and on special values; #2
# bitwise its twin on every kind of row map, one output row, the smallest
# and a ragged row width, on both sides of its 2 / 4 rows-a-block
# threshold (4,096 output rows), and many rows.
# ---------------------------------------------------------------------------
def _swiglu_against_twin(h):
    """Equal scales, NaN where the twin has NaN, and payload codes within
    one on < 1% of the other lanes (the sigmoid's last bits)."""
    qk = ops.fused_swiglu_quant(h)
    dp, sp = fused_swiglu_quant_plain(h)
    assert torch.equal(qk.scale, sp)
    nan = dp.float().isnan()
    assert torch.equal(qk.data.float().isnan(), nan)
    _codes_within_one(qk.data[~nan], dp[~nan], 0.01)
    return qk


@pytest.mark.gpu
@pytest.mark.parametrize("m,f", [(1024, 1536), (1, 128), (3, 128),
                                 (1000, 128), (20001, 128), (1, 1536),
                                 (3, 1536), (1000, 1536), (1367, 1536)])
def test_swiglu_quant_kernel_edges_on_card(card, m, f):
    """(1024, 3072) is the serve decode shape (12,288 tiles); 1, 3, 1000
    and 20,001 tiles end inside a warp's tile pair or a block's 16 tiles
    (F = 128: every tile is a row of its own), 12 to 16,404 tiles at
    F = 1536 cross rows inside a warp and a block."""
    h = torch.from_numpy(_x(m + f, m, 2 * f, spread=0.5)).to(card).to(
        torch.bfloat16)
    _swiglu_against_twin(h)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [40, 20000])
def test_swiglu_quant_kernel_special_values_on_card(card, m):
    """NaN and +-inf in gate and in up, all-zero tiles, bf16 subnormals
    (alone and beside numbers), and huge and tiny normal tiles (F = 256:
    80 and 40,000 tiles)."""
    f = 256
    g = _x(41, m, f, spread=0.5)
    u = _x(42, m, f, spread=0.5)
    g[0, 5] = np.nan
    u[1, 130] = np.nan
    g[2, :128] = np.inf
    g[3, 200] = -np.inf
    u[4, 7] = np.inf
    u[5, 128:] = -np.inf
    g[6], u[6] = 0.0, 0.0
    g[7, :128] = -0.0
    g[8, :128] = 3e-40 * np.sign(g[8, :128])            # bf16 subnormal
    u[9, 128:] = 3e-40
    g[10, 128:] = 3e-40
    g[10, 200] = 1.0
    g[11] *= 1e-30
    u[12] = np.clip(u[12], -1, 1) * 3e38
    g[13] = np.clip(g[13], -1, 1) * 1e30
    h = torch.from_numpy(np.concatenate([g, u], axis=1)).to(card).to(
        torch.bfloat16)
    qk = _swiglu_against_twin(h)
    assert qk.data[0].float().isnan().any() and float(qk.scale[0, 0]) == 1.0
    assert float(qk.scale[6, 0]) == float(qk.scale[6, 1]) == 1.0


PERMUTE_CASES = [
    # T, D, n_out, row-map kind
    (64, 4096, 640, "random"),           # the serve prefill send layout
    (8, 4096, 1024, "all_padding"),      # a decode gather with no live row
    (64, 4096, 640, "out_of_range"),     # -7, -1, T, T + 5, int32 extremes
    (8, 4096, 1024, "repeated"),         # two sources for every row
    (64, 4096, 1, "random"),             # one output row
    (5, 16, 77, "random"),               # one 16-byte chunk a row
    (33, 4112, 300, "random"),           # 257 chunks and 33 scales a row
    (8, 4096, 16384, "all_padding"),     # the serve prefill grouping's size
    (64, 4096, 8191, "out_of_range"),
    (33, 4112, 5001, "random"),
    (640, 512, 50001, "random"),         # more rows than a wave holds
]


def _row_map(r, kind, t, n_out):
    if kind == "random":
        m = r.integers(-1, t, n_out)
    elif kind == "all_padding":
        m = np.full(n_out, -1)
    elif kind == "out_of_range":
        m = r.choice([-7, -1, t, t + 5, 2**31 - 1, -2**31] + list(range(t)),
                     n_out)
    else:
        m = r.integers(0, 2, n_out)
    return m.astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("t,d,n_out,kind", PERMUTE_CASES)
def test_permute_pad_kernel_edges_on_card(card, t, d, n_out, kind):
    """Bitwise the twin: random payload bytes (NaN encodings 0x7f / 0xff
    included) and random scales, gathered by each kind of row map."""
    from repro_torch.kernels.fused_permute_pad import fused_permute_pad_cuda
    r = np.random.default_rng(t + d + n_out)
    ds = -(-d // TILE)
    x = _e4m3(card, r.integers(0, 256, (t, d)))
    s = torch.from_numpy(_x(t + 1, t, ds)).to(card)
    row_map = torch.from_numpy(_row_map(r, kind, t, n_out)).to(card)
    xo, so = fused_permute_pad_cuda(x, s, row_map)
    xp, sp = fused_permute_pad_plain(x, s, row_map)
    assert torch.equal(xo.view(torch.uint8), xp.view(torch.uint8))
    assert torch.equal(so, sp)


# ---------------------------------------------------------------------------
# The linear mode of the quantize (#1; the blockwise and naive_fp8
# recipes), bitwise against its twin on the same inputs as the po2 mode:
# ragged tile counts on both sides of the one- / four-loads threshold,
# special values (a subnormal linear scale at the 1e-37 tile), the
# boundary inputs; and the NN (#3) and NT (#10) GEMMs on linear scales.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", [(1, 128), (3, 128), (9, 384), (77, 1152),
                                 (2048, 4096), (20001, 384), (8191, 4096),
                                 (65537, 640)])
def test_quantize_linear_kernel_edges_on_card(card, dtype, m, k):
    _quantize_bitwise(torch.from_numpy(_x(m + k, m, k)).to(card).to(dtype),
                      "linear")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_linear_kernel_special_values_on_card(card, dtype):
    """NaN, +-inf, subnormal, zero and -0 values, alone in a tile and beside
    numbers; huge tiles, and tiny normal ones whose linear scale is
    subnormal."""
    x = _x(31, 64, 512)
    x[0, 5] = np.nan
    x[1, :128] = np.nan
    x[2, 130] = np.inf
    x[3, 300] = -np.inf
    x[4, 128:256] = np.inf
    x[5, :128] = 3e-40 * np.sign(x[5, :128])
    x[6, :128] = 3e-40
    x[6, 64] = 1.0
    x[7] = 0.0
    x[8, :128] = -0.0
    x[9] *= 1e-37
    x[10] = np.clip(x[10], -1, 1) * 3e38
    x[11, :128] = 448.0 * 2.0 ** -126 * np.sign(x[11, :128])
    _quantize_bitwise(torch.from_numpy(x).to(card).to(dtype), "linear")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_linear_kernel_boundary_inputs_on_card(card, kind, dtype):
    rng = np.random.default_rng([KINDS.index(kind), 8])
    x = quant_inputs(kind, rng, (48, 384))
    _quantize_bitwise(torch.from_numpy(x).to(card).to(dtype), "linear")


@pytest.mark.gpu
def test_quantize_modes_count_apart_on_card(card):
    from repro_torch import kernels
    x = torch.from_numpy(_x(5, 64, 256)).to(card)
    kernels.reset_launches()
    ops.quantize_rowwise(x, "linear")
    ops.quantize_rowwise(x, "linear")
    ops.quantize_rowwise(x)
    assert kernels.LAUNCHES["quantize_rowwise_linear"] == 2
    assert kernels.LAUNCHES["quantize_rowwise"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("w_trans", [False, True])
@pytest.mark.parametrize("e,c,k,n", [(2, 256, 3072, 4096), (3, 40, 384, 256)])
def test_grouped_gemm_on_linear_scales_on_card(card, w_trans, e, c, k, n):
    qx = _rowq(card, 14, e, c, k, scale_mode="linear")
    shape = (e, n, k) if w_trans else (e, k, n)
    qw = quantize_blockwise(torch.from_numpy(
        _x(15, *shape, spread=0.3) * 0.05).to(card), "linear")
    out = ops.grouped_gemm_fp8(qx, _t_view(qw) if w_trans else qw)
    ref = grouped_gemm_fp8_plain(qx.data, qx.scale, qw.data, qw.scale,
                                 w_trans=w_trans)
    torch.testing.assert_close(out.to(torch.float32), ref.to(torch.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("e,m,n,c", [(2, 4096, 384, 256), (3, 256, 128, 384)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_nt_on_linear_scales_on_card(card, e, m, n, c,
                                                  out_dtype):
    qa = _rowq(card, 16, e, m, c, scale_mode="linear")
    qb = _rowq(card, 17, e, n, c, scale=0.05, scale_mode="linear")
    out = ops.grouped_gemm_nt_fp8(qa, qb, out_dtype)
    ref = grouped_gemm_nt_fp8_plain(qa.data, qa.scale, qb.data, qb.scale,
                                    out_dtype)
    torch.testing.assert_close(out.to(torch.float32), ref.to(torch.float32),
                               rtol=2e-2, atol=2e-2)


# every recipe's train step ends in the AdamW update kernel
BASELINE_TRAIN_KERNELS = {
    "bf16": ("adamw_update",),
    "blockwise": ("quantize_rowwise_linear", "grouped_gemm_fp8",
                  "grouped_gemm_nt_fp8", "adamw_update"),
    "naive_fp8": ("quantize_rowwise_linear", "fused_permute_pad",
                  "grouped_gemm_fp8", "grouped_gemm_nt_fp8", "adamw_update")}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(BASELINE_TRAIN_KERNELS))
def test_baseline_train_step_on_card(card, name):
    """One reduced() train step of each baseline on the card: the paper's
    activation casts per MoE layer (0 / 8 / 12), its kernels launched and
    no other, and gradients within cosine 0.999 of the CPU path's."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core import casts
    from repro_torch.core.recipes import get_recipe
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.lm import forward, init_params
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    from repro_torch.weights import params_to

    cfg = get_arch("qwen3_moe_235b").reduced()
    recipe = get_recipe(name)
    kernels.reset_launches()
    state = init_train_state(cfg, AdamWConfig(lr=1e-3), device=card,
                             params=params_to(init_params(
                                 cfg, seed=0, device="cpu"), card))
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8), 0, device=card)
    with casts.ledger() as led:
        state, metrics = make_train_step(cfg, recipe, AdamWConfig(lr=1e-3))(
            state, batch)
    torch.cuda.synchronize()
    casts_per_layer = {"bf16": 0, "blockwise": 8, "naive_fp8": 12}[name]
    assert led.activation_casts() == casts_per_layer * cfg.n_layers
    assert np.isfinite(float(metrics["loss"]))
    run = BASELINE_TRAIN_KERNELS[name]
    assert all(kernels.LAUNCHES[k] > 0 for k in run), kernels.LAUNCHES
    assert all(n == 0 for k, n in kernels.LAUNCHES.items() if k not in run)
    grads = {}
    for d in (card, torch.device("cpu")):
        params = params_to(init_params(cfg, seed=0, device="cpu"), d)
        for p in tree_leaves(params):
            p.requires_grad_()
        b = make_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8), 0, device=d)
        loss, _ = forward(cfg, recipe, params, b)
        loss.backward()
        grads[d.type] = _named_grads(params)
    for k, g in grads["cpu"].items():
        gc = grads["cuda"][k]
        cos = (g.flatten() @ gc.flatten()) / (g.norm() * gc.norm() + 1e-300)
        assert cos.item() >= 0.999, (name, k, cos.item())


# ---------------------------------------------------------------------------
# Dense layers and shared experts: dense_mlp (the expert FFN as one group).
# ---------------------------------------------------------------------------
# the kernels of a dense MLP's forward and backward, by recipe (bf16: its
# products are bf16 matmuls); as chip_smoke.py's PATH_KERNELS, less #2
DENSE_TRAIN_KERNELS = {
    "fp8_flow": ("quantize_rowwise", "grouped_gemm_fp8",
                 "fused_swiglu_quant", "fp8_transpose",
                 "grouped_gemm_nt_fp8", "grouped_gemm_fp8_quant_out"),
    "bf16": (),
    "blockwise": ("quantize_rowwise_linear", "grouped_gemm_fp8",
                  "grouped_gemm_nt_fp8"),
    "naive_fp8": ("quantize_rowwise_linear", "grouped_gemm_fp8",
                  "grouped_gemm_nt_fp8")}


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return ((a @ b) / (a.norm() * b.norm() + 1e-300)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("recipe", list(DENSE_TRAIN_KERNELS))
@pytest.mark.parametrize("t,d,f", [(72, 256, 384), (256, 2048, 1408),
                                   (200, 200, 256)])
def test_dense_mlp_on_card_matches_cpu(card, t, d, f, recipe):
    """dense_mlp's forward and backward on the card (E = 1 groups; T = 72
    and 200 padded to 128 rows, D = 200 padded to 256) against its plain
    twins on the CPU, for every recipe: output and every gradient within
    cosine 0.999 (the GPU-vs-CPU bar of chip_smoke.py), through the
    kernels of the recipe's dense MLP train step and no other."""
    from repro_torch import kernels
    from repro_torch.core.linear import dense_mlp
    from repro_torch.core.recipes import get_recipe

    r = np.random.default_rng(21)
    inputs = (torch.from_numpy(r.normal(size=(t, d)).astype(np.float32)
                               ).to(torch.bfloat16),
              torch.from_numpy(r.normal(size=(d, 2 * f)).astype(np.float32)
                               * 0.05).to(torch.bfloat16),
              torch.from_numpy(r.normal(size=(f, d)).astype(np.float32)
                               * 0.05).to(torch.bfloat16))
    out = {}
    for dev in (card, torch.device("cpu")):
        x, w13, w2 = (a.to(dev).requires_grad_() for a in inputs)
        kernels.reset_launches()
        y = dense_mlp(get_recipe(recipe), "swiglu", x, w13, w2)
        y.backward((2 * y.detach().to(torch.float32)).to(y.dtype))
        out[dev.type] = [a.detach().float().cpu()
                         for a in (y, x.grad, w13.grad, w2.grad)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
    run = DENSE_TRAIN_KERNELS[recipe]
    assert all(launches[k] > 0 for k in run), launches
    assert all(n == 0 for k, n in launches.items() if k not in run), launches
    assert out["cuda"][0].shape == (t, d)
    for name, a, b in zip(("y", "gx", "wg13", "wg2"), out["cuda"],
                          out["cpu"]):
        assert a.isfinite().all() and a.abs().max() > 0, name
        assert _cosine(a, b) >= 0.999, (name, _cosine(a, b))


@pytest.mark.gpu
def test_deepseek_v2_lite_engine_on_card(card):
    """A short reduced() deepseek_v2_lite trace through the engine on the
    card (a dense layer, then an MoE layer with a shared expert): every
    request finishes, every page comes back, the serving kernels run, and
    the masked recipe generates the padded recipe's tokens (its dense and
    shared MLPs on the padded #3 and #8)."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core.recipes import get_recipe
    from repro_torch.models.lm import init_params
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import Request

    cfg = get_arch("deepseek_v2_lite").reduced()
    ecfg = ServeConfig(max_batch=4, page_size=8, n_pages=32,
                       max_pages_per_req=4, token_budget=128,
                       prefill_buckets=(16,), w8_weights=True)
    r = np.random.default_rng(6)
    prompts = [[int(v) for v in r.integers(1, cfg.vocab,
                                           int(r.integers(4, 12)))]
               for _ in range(5)]
    tokens, launches = {}, {}
    for name, kw in (("padded", {}), ("masked", dict(
            masked_experts=True, swiglu_epilogue=True))):
        eng = ServeEngine(cfg, get_recipe("fp8_flow", **kw),
                          init_params(cfg, seed=0, device="cpu"), ecfg,
                          device=card)
        assert set(eng.pools) == {"main_attn", "dense_attn"}
        reqs = [Request(prompt=p, max_new_tokens=3) for p in prompts]
        kernels.reset_launches()
        res = eng.run(reqs, realtime=False)
        launches[name] = dict(kernels.LAUNCHES)
        assert all(len(res[q.rid]["tokens"]) == 3 for q in reqs)
        assert eng.alloc.free_pages == ecfg.n_pages - 1
        tokens[name] = [res[q.rid]["tokens"] for q in reqs]
    assert tokens["masked"] == tokens["padded"]
    padded = ("quantize_rowwise", "fused_permute_pad", "grouped_gemm_fp8",
              "fused_swiglu_quant")
    masked = padded + ("masked_grouped_gemm_fp8",
                       "masked_grouped_gemm_swiglu_quant")
    for name, run in (("padded", padded), ("masked", masked)):
        assert all(launches[name][k] > 0 for k in run), launches[name]
        assert all(n == 0 for k, n in launches[name].items()
                   if k not in run), launches[name]


# ---------------------------------------------------------------------------
# GeGLU, GELU and ReLU FFNs: the activation in plain PyTorch, then #1.
# ---------------------------------------------------------------------------
# the kernels of a non-SwiGLU FFN's forward and backward: no #8 and no #7
# (the activation is computed in f32 and quantized by #1, ``act_quant``)
ACT_TRAIN_KERNELS = dict(DENSE_TRAIN_KERNELS, fp8_flow=(
    "quantize_rowwise", "grouped_gemm_fp8", "fp8_transpose",
    "grouped_gemm_nt_fp8", "grouped_gemm_fp8_quant_out"))
ACT_MASKED_KERNELS = ("quantize_rowwise", "fp8_transpose",
                      "masked_grouped_gemm_fp8",
                      "masked_grouped_gemm_fp8_quant_out",
                      "masked_grouped_gemm_nt_fp8")


@pytest.mark.gpu
@pytest.mark.parametrize("recipe", list(ACT_TRAIN_KERNELS) + ["masked"])
@pytest.mark.parametrize("act", ["geglu", "gelu", "relu"])
def test_act_expert_ffn_on_card_matches_cpu(card, act, recipe):
    """The expert FFN (E = 4, C = 256, K = 2048, F = 1408; the masked
    recipe with per-expert counts 256 / 100 / 0 / 17 and dead rows zero)
    on the card against its plain twins on the CPU, forward and backward:
    cosine >= 0.999 everywhere, through exactly the recipe's kernels."""
    from repro_torch import kernels
    from repro_torch.core.linear import expert_ffn, quantize_entry
    from repro_torch.core.recipes import get_recipe

    masked = recipe == "masked"
    r = get_recipe("fp8_flow", masked_experts=True, swiglu_epilogue=True) \
        if masked else get_recipe(recipe)
    g = 2 if act == "geglu" else 1
    E, C, K, F = 4, 256, 2048, 1408
    rng = np.random.default_rng(23)
    mm = np.asarray([256, 100, 0, 17], np.int32)
    live = (np.arange(C)[None, :] < mm[:, None]).astype(np.float32)[..., None]
    inputs = (torch.from_numpy(rng.normal(size=(E, C, K)).astype(np.float32)
                               * live).to(torch.bfloat16),
              torch.from_numpy(rng.normal(size=(E, K, g * F)).astype(
                  np.float32) * 0.03).to(torch.bfloat16),
              torch.from_numpy(rng.normal(size=(E, F, K)).astype(np.float32)
                               * 0.03).to(torch.bfloat16))
    out = {}
    for dev in (card, torch.device("cpu")):
        x, w13, w2 = (a.to(dev).clone().requires_grad_() for a in inputs)
        kernels.reset_launches()
        xi = quantize_entry(r, x) if r.name == "fp8_flow" else x
        y = expert_ffn(r, act, xi, w13, w2,
                       torch.from_numpy(mm).to(dev) if masked else None)
        wl = torch.from_numpy(live).to(dev)
        ((y.to(torch.float32) * wl) ** 2).sum().backward()
        out[dev.type] = [a.detach().float().cpu()
                         for a in (y, x.grad, w13.grad, w2.grad)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
    run = ACT_MASKED_KERNELS if masked else ACT_TRAIN_KERNELS[recipe]
    assert all(launches[k] > 0 for k in run), launches
    assert all(n == 0 for k, n in launches.items() if k not in run), launches
    for name, a, b in zip(("y", "gx", "wg13", "wg2"), out["cuda"],
                          out["cpu"]):
        assert a.isfinite().all() and a.abs().max() > 0, name
        assert _cosine(a, b) >= 0.999, (name, _cosine(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["geglu", "gelu", "relu"])
def test_act_dense_mlp_on_card_matches_cpu(card, act):
    """dense_mlp in fp8_flow (T = 200 padded to 256, D 2048, F 2816) on the
    card against the CPU: cosine >= 0.999, exactly the non-SwiGLU kernels,
    and the masked recipe (no expert plan: the padded kernels) the padded
    one bit for bit on the card."""
    from repro_torch import kernels
    from repro_torch.core.linear import dense_mlp
    from repro_torch.core.recipes import get_recipe

    g = 2 if act == "geglu" else 1
    rng = np.random.default_rng(24)
    inputs = (torch.from_numpy(rng.normal(size=(200, 2048)).astype(
                  np.float32)).to(torch.bfloat16),
              torch.from_numpy(rng.normal(size=(2048, g * 2816)).astype(
                  np.float32) * 0.03).to(torch.bfloat16),
              torch.from_numpy(rng.normal(size=(2816, 2048)).astype(
                  np.float32) * 0.03).to(torch.bfloat16))
    out = {}
    for key, dev, kw in (("cuda", card, {}), ("cpu", torch.device("cpu"), {}),
                         ("masked", card, dict(masked_experts=True,
                                               swiglu_epilogue=True))):
        x, w13, w2 = (a.to(dev).clone().requires_grad_() for a in inputs)
        kernels.reset_launches()
        y = dense_mlp(get_recipe("fp8_flow", **kw), act, x, w13, w2)
        y.backward((2 * y.detach().to(torch.float32)).to(y.dtype))
        out[key] = [a.detach().float().cpu()
                    for a in (y, x.grad, w13.grad, w2.grad)]
        if key == "cuda":
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
    run = ACT_TRAIN_KERNELS["fp8_flow"]
    assert all(launches[k] > 0 for k in run), launches
    assert all(n == 0 for k, n in launches.items() if k not in run), launches
    for name, a, b, m in zip(("y", "gx", "wg13", "wg2"), out["cuda"],
                             out["cpu"], out["masked"]):
        assert a.isfinite().all() and a.abs().max() > 0, name
        assert _cosine(a, b) >= 0.999, (name, _cosine(a, b))
        assert torch.equal(a, m), name


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["grok1_314b", "gemma2_9b"])
def test_geglu_engine_on_card(card, arch):
    """A short reduced() trace of grok1_314b (GeGLU experts) or gemma2_9b
    (GeGLU, local:global with window 8, softcaps) through the engine on
    the card: every request finishes, every page comes back, no #7 or #8
    runs, and the masked recipe generates the padded recipe's tokens."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core.recipes import get_recipe
    from repro_torch.models.lm import init_params
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import Request

    cfg = dataclasses.replace(get_arch(arch).reduced(), window=8)
    ecfg = ServeConfig(max_batch=4, page_size=8, n_pages=32,
                       max_pages_per_req=4, token_budget=128,
                       prefill_buckets=(16,), w8_weights=True)
    r = np.random.default_rng(7)
    prompts = [[int(v) for v in r.integers(1, cfg.vocab,
                                           int(r.integers(4, 14)))]
               for _ in range(5)]
    tokens, launches = {}, {}
    for name, kw in (("padded", {}), ("masked", dict(
            masked_experts=True, swiglu_epilogue=True))):
        eng = ServeEngine(cfg, get_recipe("fp8_flow", **kw),
                          init_params(cfg, seed=0, device="cpu"), ecfg,
                          device=card)
        reqs = [Request(prompt=p, max_new_tokens=4) for p in prompts]
        kernels.reset_launches()
        res = eng.run(reqs, realtime=False)
        launches[name] = dict(kernels.LAUNCHES)
        assert all(len(res[q.rid]["tokens"]) == 4 for q in reqs)
        assert eng.alloc.free_pages == ecfg.n_pages - 1
        tokens[name] = [res[q.rid]["tokens"] for q in reqs]
    assert tokens["masked"] == tokens["padded"]
    assert all(launches[n]["fused_swiglu_quant"] == 0 and launches[n][
        "masked_grouped_gemm_swiglu_quant"] == 0 for n in launches), launches
    assert launches["padded"]["grouped_gemm_fp8"] > 0
    assert launches["padded"]["quantize_rowwise"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["ssd", "train", "decode"])
def test_ssd_and_mamba2_block_on_card_match_cpu(card, form):
    """ssd_chunked (mamba2's full-width head shape: 80 heads of 64, state
    128, chunk 256 over 1024 tokens) and hymba's reduced() mixer in its
    training and decode forms, in f32, on the card against the CPU: plain
    PyTorch on both (no kernel of the port), within 1e-4 of the largest
    value."""
    from repro_torch.configs import get_arch
    from repro_torch.models import ssm
    r = np.random.default_rng(6)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((r.normal(size=shape) * scale
                                 ).astype(np.float32))

    if form == "ssd":
        b, S, H, P, N = 1, 1024, 80, 64, 128
        args = (f32(b, S, H, P), f32(b, S, H, scale=0.1).abs(),
                -f32(H).abs(), f32(b, S, N, scale=0.1),
                f32(b, S, N, scale=0.1))
        fn = lambda *a: ssm.ssd_chunked(*a, chunk=256)   # noqa: E731
    else:
        cfg = get_arch("hymba_15b").reduced()
        di, N, H, D = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.d_model
        p = {"in_proj": f32(D, 2 * di + 2 * N + H, scale=0.05),
             "conv_w": f32(cfg.ssm_conv, di + 2 * N, scale=0.2),
             "A_log": torch.log(torch.linspace(1.0, 16.0, H)),
             "D": torch.ones(H), "dt_bias": f32(H, scale=0.1),
             "norm_s": f32(di, scale=0.1),
             "out_proj": f32(di, D, scale=0.05)}
        S = 64 if form == "train" else 1
        kw = {} if form == "train" else dict(
            state=f32(2, H, cfg.ssm_headdim, N),
            conv_state=f32(2, cfg.ssm_conv - 1, di + 2 * N), decode=True)
        args = (p, f32(2, S, D))

        def fn(p, x, **k):
            return ssm.mamba2_block(cfg, p, x, **kw, **k)

    def to(a, d):
        if isinstance(a, dict):
            return {k: to(v, d) for k, v in a.items()}
        if isinstance(a, tuple):
            return tuple(to(v, d) for v in a)
        return a.to(d) if torch.is_tensor(a) else a

    if form != "ssd":
        kw = to(kw, card)
        got = fn(*to(args, card))
        kw = to(kw, "cpu")
        want = fn(*args)
    else:
        got, want = fn(*to(args, card)), fn(*args)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.is_cuda
        a = a.cpu()
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2_27b", "hymba_15b",
                                  "seamless_m4t_v2", "llava_next_34b"])
def test_decode_step_on_card_matches_cpu(card, arch):
    """A reduced() config's decode_step from init_cache over 4 tokens at
    scalar positions (fp8_flow; seamless's cross cache left at zero),
    from the same params on the card and on the CPU: logits cosine >=
    0.999 a step, every cache leaf cosine >= 0.999 with the same dtypes."""
    from repro_torch.configs import get_arch
    from repro_torch.core.recipes import get_recipe
    from repro_torch.models import lm
    from repro_torch.weights import params_to
    cfg, recipe = get_arch(arch).reduced(), get_recipe("fp8_flow")
    params = lm.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 2, 1)))
    out = {}
    for d in (card, torch.device("cpu")):
        p, cache, logits = params_to(params, d), lm.init_cache(
            cfg, 2, 16, device=d), []
        for pos in range(4):
            lg, cache = lm.decode_step(cfg, recipe, p, cache, toks[pos].to(d),
                                       pos)
            logits.append(lg.float().cpu())
        out[d.type] = logits, {(k, n): v.cpu() for k, dd in cache.items()
                               for n, v in dd.items()}

    def cos(a, b):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        if a.norm() == 0 and b.norm() == 0:
            return 1.0
        return (a @ b / (a.norm() * b.norm())).item()

    (lg_c, c_c), (lg_h, c_h) = out["cuda"], out["cpu"]
    assert all(cos(a, b) >= 0.999 for a, b in zip(lg_c, lg_h))
    assert c_c.keys() == c_h.keys()
    for k in c_h:
        assert c_c[k].dtype == c_h[k].dtype, k
        assert cos(c_c[k].float(), c_h[k].float()) >= 0.999, k


# ---------------------------------------------------------------------------
# The fused AdamW update (csrc/adamw_update.cu) against its twin, bit for
# bit: the f32 state, the FP8-split state, bf16 moments, no master
# weights; bf16 and f32 gradients; a tail row; and skip-step.
# ---------------------------------------------------------------------------
OPT_MODES = ("f32", "split", "bf16_moments", "no_master")


def _opt_state(card, n, mode, g_dtype, seed, p_dtype=torch.bfloat16):
    from repro_torch.dist import opt_state as ost
    gen = torch.Generator(device=card).manual_seed(seed)

    def r(scale=1.0):
        return torch.randn(n, generator=gen, device=card) * scale

    p = r().to(p_dtype)
    g = r(1e-2).to(g_dtype)
    m32, v32 = r(1e-3), r(1e-2).square()
    if mode == "split":
        m, v, w = (ost.encode("e4m3", m32), ost.encode("bf16", v32),
                   ost.encode("f16", p))
    elif mode == "bf16_moments":
        m, v, w = m32.to(torch.bfloat16), v32.to(torch.bfloat16), p.float()
    else:
        m, v = m32, v32
        w = None if mode == "no_master" else p.float()
    return p, g, m, v, w


def _opt_bytes(*leaves):
    out = []
    for x in leaves:
        if x is None:
            continue
        for t in ((x.data, x.scale) if isinstance(x, QTensor) else (x,)):
            out.append(t.reshape(-1).view(torch.uint8).clone())
    return out


def _opt_clone(x):
    if x is None:
        return None
    if isinstance(x, QTensor):
        return QTensor(x.data.clone(), x.scale.clone(), x.tile)
    return x.clone()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [128 * 1000, 128 * 1000 + 37, 1])
@pytest.mark.parametrize("mode", OPT_MODES)
@pytest.mark.parametrize("g_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("p_dtype", ["bfloat16", "float32"])
def test_adamw_update_kernel_on_card(card, n, mode, g_dtype, p_dtype):
    from repro_torch import kernels
    from repro_torch.kernels.adamw_update import (adamw_update_cuda,
                                                  adamw_update_plain)
    from repro_torch.optim.adamw import AdamWConfig, bias_corrections
    cfg = AdamWConfig(lr=1e-3)
    p, g, m, v, w = _opt_state(card, n, mode, getattr(torch, g_dtype), n,
                               getattr(torch, p_dtype))
    b1c, b2c = bias_corrections(cfg, 3)
    clip = torch.tensor(0.75, device=card)
    twin = [_opt_clone(x) for x in (p, m, v, w)]
    kernels.reset_launches()
    adamw_update_cuda(cfg, 1e-3, b1c, b2c, g, clip, m, v, w, p)
    assert kernels.LAUNCHES["adamw_update"] == 1
    adamw_update_plain(cfg, 1e-3, b1c, b2c, g, clip, twin[1], twin[2],
                       twin[3], twin[0])
    for a, b in zip(_opt_bytes(p, m, v, w), _opt_bytes(*twin)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["f32", "split"])
def test_adamw_update_kernel_skips_on_flags(card, mode):
    """flags & skip_mask != 0: every byte stays; a soft bit outside the
    mask updates as without flags."""
    from repro_torch.kernels.adamw_update import adamw_update_cuda
    from repro_torch.optim.adamw import AdamWConfig
    cfg = AdamWConfig()
    n = 128 * 50 + 5
    p, g, m, v, w = _opt_state(card, n, mode, torch.bfloat16, 3)
    before = _opt_bytes(p, m, v, w)
    clip = torch.tensor(1.0, device=card)
    flags = torch.tensor(2, dtype=torch.int32, device=card)
    adamw_update_cuda(cfg, 3e-4, 0.1, 0.05, g, clip, m, v, w, p, flags, 7)
    for a, b in zip(before, _opt_bytes(p, m, v, w)):
        assert torch.equal(a, b)
    ref = [_opt_clone(x) for x in (p, m, v, w)]
    adamw_update_cuda(cfg, 3e-4, 0.1, 0.05, g, clip, *ref[1:], ref[0])
    flags.fill_(8)
    adamw_update_cuda(cfg, 3e-4, 0.1, 0.05, g, clip, m, v, w, p, flags, 7)
    for a, b in zip(_opt_bytes(p, m, v, w), _opt_bytes(*ref)):
        assert torch.equal(a, b)
    assert not torch.equal(_opt_bytes(p)[0], before[0])


def _card_pools(card, fp8, seed, n_pages=8, L=2, ps=8, KV=4, hd=128):
    """Two-stack paged pools on the card: fp8 payloads are raw random
    bytes (NaN encodings 0x7F / 0xFF among them) with po2 scales, bf16
    pools have no scale plane."""
    gen = torch.Generator(device=card).manual_seed(seed)
    shape = (L, n_pages, ps, KV, hd)

    def one():
        if fp8:
            raw = torch.randint(0, 256, shape, generator=gen, device=card,
                                dtype=torch.uint8)
            exp = torch.randint(-30, 31, shape[:-1] + (1,), generator=gen,
                                device=card, dtype=torch.int32)
            return {"data": raw.view(torch.float8_e4m3fn),
                    "scale": ((exp + 127) << 23).view(torch.float32)}
        return {"data": torch.randn(shape, generator=gen, device=card)
                .to(torch.bfloat16)}
    return {"main_attn": {"k": one(), "v": one()},
            "dense_attn": {"k": one(), "v": one()}}


def _page_bytes(codec, pools, page):
    return codec._gather(pools, codec._pad_ids([page]))


@pytest.mark.gpu
@pytest.mark.parametrize("fp8", [True, False], ids=["fp8", "bf16"])
def test_kv_codec_round_trip_on_card(card, fp8):
    """pack on the card -> host message -> scatter into other pages of a
    zeroed pool on the card: every page's bytes equal, NaN encodings
    kept; the gather and the scatter run no float op on CUDA pools."""
    from repro_torch.serve.transfer import KVTransferCodec, TransferMeta
    pools = _card_pools(card, fp8, 1)
    codec = KVTransferCodec(pools)
    assert codec.device.type == "cuda"
    if fp8:
        raw = pools["main_attn"]["k"]["data"].view(torch.uint8)
        assert bool(((raw == 0x7F) | (raw == 0xFF)).any())
    meta = TransferMeta(rid=3, n_pages=3, page_size=8,
                        bytes_per_page=codec.bytes_per_page, pos=24,
                        max_new_tokens=4, temperature=0.0,
                        prompt=tuple(range(24)), generated=(5,))
    src, dst = [2, 5, 1], [6, 3, 7]
    msg = codec.pack(pools, src, meta)
    got, payload = codec.unpack(msg)
    assert got == meta and len(payload) == codec.bytes_for(3)
    blank = {s: {kv: {k: torch.zeros_like(t) for k, t in p.items()}
                 for kv, p in st.items()} for s, st in pools.items()}
    assert codec.scatter(blank, payload, dst) is blank
    for s, d in zip(src, dst):
        assert torch.equal(_page_bytes(codec, pools, s),
                           _page_bytes(codec, blank, d))
    codec.assert_casting_free(pools, n=3)


@pytest.mark.gpu
def test_copy_page_is_the_cow_copy_on_card(card):
    """copy_page(src, dst) on the card: dst equals src byte for byte in
    every layer of every stack, src keeps its bytes, other pages stay."""
    from repro_torch.serve.paged_kv import copy_page
    from repro_torch.serve.transfer import KVTransferCodec
    pools = _card_pools(card, True, 2)
    codec = KVTransferCodec(pools)
    before = [_page_bytes(codec, pools, p) for p in range(8)]
    copy_page(pools, 3, 6)
    after = [_page_bytes(codec, pools, p) for p in range(8)]
    assert torch.equal(after[6], before[3])
    assert all(torch.equal(a, b) for i, (a, b) in enumerate(
        zip(after, before)) if i != 6)


# ---------------------------------------------------------------------------
# The chunked (overlapped) MoE block, the expected_m hint and the roofline
# tally on the card.
# ---------------------------------------------------------------------------
def _ovl_inputs(dev, T=512, D=256, F=256, E=8, k=2):
    from repro_torch.core.moe import MoEConfig
    r = np.random.default_rng(11)
    cfg = MoEConfig(n_experts=E, top_k=k, d_model=D, d_ff=F,
                    capacity_factor=2.0)
    x = torch.tensor(r.normal(size=(T, D)).astype(np.float32)).to(
        torch.bfloat16)
    wr = torch.tensor((r.normal(size=(D, E)) * 0.02).astype(np.float32))
    w13 = torch.tensor((r.normal(size=(E, D, 2 * F)) * 0.05).astype(
        np.float32)).to(torch.bfloat16)
    w2 = torch.tensor((r.normal(size=(E, F, D)) * 0.05).astype(
        np.float32)).to(torch.bfloat16)
    return cfg, [t.to(dev) for t in (x, wr, w13, w2)]


def _ovl_run(recipe, cfg, inputs, n):
    from repro_torch.core import casts
    from repro_torch.core.moe import moe_block, moe_block_overlapped
    leaves = [t.clone().requires_grad_() for t in inputs]
    with casts.ledger() as led:
        if n:
            y, m = moe_block_overlapped(recipe, cfg, *leaves, n_chunks=n)
        else:
            y, m = moe_block(recipe, cfg, *leaves)
        (y.to(torch.float32) ** 2).sum().backward()
    return [y.detach()] + [t.grad for t in leaves], led, float(m["drop_frac"])


def _cos(a, b):
    a, b = a.double().cpu().ravel(), b.double().cpu().ravel()
    return float(a @ b / max(float(a.norm() * b.norm()), 1e-300))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4])
def test_overlapped_block_on_card(card, n):
    from repro_torch import kernels
    """fp8_flow's chunked block on the card: 2 casts, every output and
    gradient at cosine >= 0.999 against the card's monolithic block and
    against the CPU twins' chunked block; the masked recipe bit for bit
    the padded one, through the masked kernels only."""
    from repro_torch.core.recipes import get_recipe
    cfg, ins = _ovl_inputs(card)
    padded = get_recipe("fp8_flow")
    masked = get_recipe("fp8_flow", masked_experts=True, swiglu_epilogue=True)
    mono, _, _ = _ovl_run(padded, cfg, ins, 0)
    kernels.reset_launches()
    got, led, drop = _ovl_run(padded, cfg, ins, n)
    assert kernels.LAUNCHES["grouped_gemm_fp8"] > 0
    assert kernels.LAUNCHES["grouped_gemm_nt_fp8"] > 0
    assert led.activation_casts() == 2 and drop == 0.0
    cpu, _, _ = _ovl_run(padded, cfg, [t.cpu() for t in ins], n)
    for a, b, c in zip(got, mono, cpu):
        assert _cos(a, b) >= 0.999 and _cos(a, c) >= 0.999
    kernels.reset_launches()
    got_m, led_m, _ = _ovl_run(masked, cfg, ins, n)
    assert kernels.LAUNCHES["grouped_gemm_fp8"] == 0
    assert kernels.LAUNCHES["masked_grouped_gemm_swiglu_quant"] > 0
    assert led_m.activation_casts() == 2
    assert all(torch.equal(a, b) for a, b in zip(got, got_m))


@pytest.mark.gpu
def test_expected_m_takes_the_padded_kernel_on_card(card):
    """At expected_m >= C the masked wrappers launch the padded kernels
    (LAUNCHES) and give the masked launch's bits; the fused SwiGLU GEMM-1
    never falls back."""
    from repro_torch import kernels
    E, C, K, N = 4, 256, 256, 512
    mm = torch.tensor([256, 40, 0, 130], dtype=torch.int32, device=card)
    live = torch.arange(C, device=card)[None, :, None] < mm[:, None, None]
    x = torch.where(live, torch.from_numpy(_x(61, E, C, K)).to(card), 0)
    qx = ops.quantize_rowwise(x.reshape(E * C, K).to(torch.bfloat16))
    qx = QTensor(qx.data.reshape(E, C, K), qx.scale.reshape(E, C, K // TILE),
                 (1, 1, TILE))
    qw = quantize_blockwise(torch.from_numpy(_x(62, E, K, N) * 0.05).to(card))
    kernels.reset_launches()
    m_nn = ops.grouped_gemm_fp8_masked(qx, qw, mm)
    m_q = ops.grouped_gemm_fp8_masked_quant_out(qx, qw, mm)
    assert kernels.LAUNCHES["masked_grouped_gemm_fp8"] == 1
    assert kernels.LAUNCHES["masked_grouped_gemm_fp8_quant_out"] == 1
    kernels.reset_launches()
    p_nn = ops.grouped_gemm_fp8_masked(qx, qw, mm, expected_m=C)
    p_q = ops.grouped_gemm_fp8_masked_quant_out(qx, qw, mm, expected_m=C)
    ops.grouped_gemm_swiglu_quant_masked(qx, qw, mm, expected_m=C)
    assert kernels.LAUNCHES["grouped_gemm_fp8"] == 1
    assert kernels.LAUNCHES["grouped_gemm_fp8_quant_out"] == 1
    assert kernels.LAUNCHES["masked_grouped_gemm_fp8"] == 0
    assert kernels.LAUNCHES["masked_grouped_gemm_swiglu_quant"] == 1
    assert torch.equal(m_nn.view(torch.int16), p_nn.view(torch.int16))
    assert torch.equal(m_q.data.view(torch.uint8), p_q.data.view(torch.uint8))
    assert torch.equal(m_q.scale, p_q.scale)


@pytest.mark.gpu
def test_tally_on_card_reports_the_cpu_kernels(card):
    """The roofline tally of the chunked block's forward and backward: the
    same kernels, launches and FLOPs on the card as the twins on the CPU,
    and the same aten FLOPs."""
    from repro_torch.core.recipes import get_recipe
    from repro_torch.roofline import analysis
    cfg, ins = _ovl_inputs(card)
    out = {}
    for where, xs in (("gpu", ins), ("cpu", [t.cpu() for t in ins])):
        with analysis.tally() as t:
            _ovl_run(get_recipe("fp8_flow"), cfg, xs, 2)
        out[where] = t
    kg, kc = out["gpu"].kernels(), out["cpu"].kernels()
    assert kg.keys() == kc.keys()
    for k in kg:
        assert kg[k]["launches"] == kc[k]["launches"], k
        assert kg[k]["flops"] == kc[k]["flops"], k
    assert out["gpu"].gemm_flops == out["cpu"].gemm_flops
    # the dispatch mode follows autograd onto its device thread: the
    # router's backward matmuls are counted on the card as on the CPU
    assert out["gpu"].aten_flops == out["cpu"].aten_flops > 0


# ---------------------------------------------------------------------------
# The multi-GPU path's collectives on an NCCL group of one rank (one card:
# NCCL refuses two ranks on one device), and the DP wire's pieces on it.
# ---------------------------------------------------------------------------
@pytest.fixture
def nccl(card, tmp_path):
    from repro_torch.launch.mesh import close_mesh, init_mesh
    mesh = init_mesh(1, 1, device="cuda", store=str(tmp_path / "store"),
                     timeout_s=120)
    yield mesh
    close_mesh()


@pytest.mark.gpu
def test_all_to_all_is_the_identity_on_card(nccl):
    """At one rank the all-to-all (dist/comm.py, the MoE blocks') is
    a copy: e4m3 payloads, their f32 scales, bf16 rows and a packed uint8
    message come back byte for byte, synchronously and in flight."""
    from repro_torch.dist import comm
    g = torch.Generator(device="cuda").manual_seed(0)
    pay = torch.randint(0, 256, (256, 4096), generator=g, device="cuda",
                        dtype=torch.uint8)
    for t in (pay.view(torch.float8_e4m3fn),
              torch.rand((256, 32), generator=g, device="cuda"),
              torch.randn((256, 4096), generator=g, device="cuda").to(
                  torch.bfloat16), pay):
        for async_op in (False, True):
            got = comm.all_to_all(t, nccl.model_group, async_op=async_op)
            got = got.wait() if async_op else got
            assert got.dtype == t.dtype and got.data_ptr() != t.data_ptr()
            iv = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
            assert torch.equal(got.view(iv[t.element_size()]),
                               t.view(iv[t.element_size()]))


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["fp8", "bf16", "f32"])
def test_wire_reduce_scatter_equals_the_cpu_twin_on_card(nccl, wire):
    """reduce_scatter_bucket on the card (NCCL, one replica) and on the
    CPU (no group) from the same bucket: the same owned rows bit for bit
    (the agreed scale is the row's own, the dequantize exact)."""
    from repro_torch.dist import grad_comm
    g = torch.from_numpy(_x(5, 4096, TILE, spread=2.0))
    got = grad_comm.reduce_scatter_bucket(g.cuda(), nccl.data_group, 1, wire)
    want = grad_comm.reduce_scatter_bucket(g, None, 1, wire)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("pol", ["split", "f32"])
def test_flat_bucket_update_kernel_equals_its_twin_on_card(card, pol,
                                                           monkeypatch):
    """flat_bucket_update on an owned (rows, TILE) shard runs the
    adamw_update kernel (one launch a chunk) and leaves every byte of the
    shard's params, m, v and master equal to its twin's on the card."""
    from repro_torch import kernels
    from repro_torch.dist import opt_state as ost
    from repro_torch.optim.adamw import AdamWConfig
    rows = 3 * 4096 + 64
    policy = ost.StatePolicy() if pol == "split" else \
        ost.StatePolicy(m="f32", v="f32", master="f32")
    r = np.random.default_rng(6)
    p = torch.from_numpy(r.normal(size=(rows, TILE)).astype(np.float32)
                         * 0.02).to(torch.bfloat16)
    g = torch.from_numpy(r.normal(size=(rows, TILE)).astype(np.float32)
                         * 1e-3)
    m0 = torch.from_numpy(r.normal(size=(rows, TILE)).astype(np.float32)
                          * 1e-4)
    v0 = torch.from_numpy(r.random((rows, TILE)).astype(np.float32) * 1e-6)

    def state(dev):
        return {"m": ost.encode(policy.m, m0.to(dev)),
                "v": ost.encode(policy.v, v0.to(dev)),
                "master": ost.encode(policy.master, p.to(dev))}
    from repro_torch.kernels.adamw_update import adamw_update_plain
    opt = AdamWConfig(lr=1e-3)
    out = {}
    for route in ("kernel", "twin"):
        if route == "twin":
            monkeypatch.setattr(ops, "adamw_update_cuda", adamw_update_plain)
        st, ps = state("cuda"), p.cuda().reshape(-1).clone()
        kernels.reset_launches()
        ost.flat_bucket_update(opt, st, g.cuda(), torch.tensor(
            0.5, device="cuda"), 1e-3, 0.1, 0.05, ps)
        out[route] = (ps, st, kernels.LAUNCHES["adamw_update"])
    assert out["kernel"][2] >= 1 and out["twin"][2] == 0
    assert torch.equal(out["kernel"][0].view(torch.int16),
                       out["twin"][0].view(torch.int16))
    for k in ("m", "v", "master"):
        a, b = out["kernel"][1][k], out["twin"][1][k]
        for x, y in ((a.data, b.data), (a.scale, b.scale)) \
                if isinstance(a, QTensor) else ((a, b),):
            iv = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
            assert torch.equal(x.view(iv[x.element_size()]),
                               y.view(iv[y.element_size()])), k


# ---------------------------------------------------------------------------
# Multi-GPU part 2 on an NCCL group of one rank: the FSDP gather and its
# reduce-scatter, the TP expert block, the streaming wire.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_fsdp_gather_and_its_reduce_scatter_are_copies_on_card(nccl):
    """dist/tp.fsdp_gather on the data group of one rank: forward the
    shard back on its cut axis, backward the gradient, both bit for bit
    (an all-gather and a reduce-scatter of one rank are copies), for each
    FSDP axis a stage gathers on."""
    from repro_torch.dist import comm, tp
    g = torch.Generator(device="cuda").manual_seed(3)
    for shape, axis in (((4, 256, 2, 384), 1), ((4, 384, 256), 2),
                        ((256, 2, 384), 0), ((384, 256), 1)):
        w = torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16).requires_grad_()
        comm.reset_counts()
        full = tp.fsdp_gather(w, nccl.data_group, axis)
        assert torch.equal(full.view(torch.int16), w.detach().view(
            torch.int16))
        ct = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        full.backward(ct)
        assert torch.equal(w.grad.view(torch.int16), ct.view(torch.int16))
        c = comm.counts()
        assert c["all-gather"]["calls"] == c["reduce-scatter"]["calls"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("combine", ["psum_first", "local_first",
                                     "reduce_scatter"])
@pytest.mark.parametrize("masked", [False, True])
def test_tp_block_with_a_group_equals_it_without_on_card(nccl, combine,
                                                         masked):
    """moe_block_tp on the card with the model group of one rank and with
    no group: the output and the x / router / w13 / w2 gradients bit for
    bit (each collective a copy), 2 activation casts, and Dgrad-1 on #3
    (or #5) then #1: no #4 / #6 launch."""
    from repro_torch import kernels
    from repro_torch.core import casts, moe
    from repro_torch.core.recipes import get_recipe
    recipe = get_recipe("fp8_flow", masked_experts=masked,
                        swiglu_epilogue=masked)
    T, D, F, E = 512, 512, 256, 4
    cfg = moe.MoEConfig(n_experts=E, top_k=2, d_model=D, d_ff=F,
                        capacity_factor=2.0)
    gen = torch.Generator(device="cuda").manual_seed(4)
    inputs = (torch.randn((T, D), generator=gen, device="cuda").to(
                  torch.bfloat16),
              torch.randn((D, E), generator=gen, device="cuda") * 0.02,
              (torch.randn((E, D, 2 * F), generator=gen, device="cuda")
               * 0.05).to(torch.bfloat16),
              (torch.randn((E, F, D), generator=gen, device="cuda")
               * 0.05).to(torch.bfloat16))
    out = []
    for group in (None, nccl.model_group):
        ts = [t.clone().requires_grad_() for t in inputs]
        kernels.reset_launches()
        with casts.ledger() as led:
            y, _ = moe.moe_block_tp(recipe, cfg, *ts, tp_group=group,
                                    combine_mode=combine)
            (y.to(torch.float32) ** 2).sum().backward()
        assert led.activation_casts() == 2
        quant_out = "masked_grouped_gemm_fp8_quant_out" if masked \
            else "grouped_gemm_fp8_quant_out"
        assert kernels.LAUNCHES[quant_out] == 0
        assert kernels.LAUNCHES["quantize_rowwise"] > 0
        out.append([y] + [t.grad for t in ts])
    for a, b in zip(*out):
        assert torch.equal(a.view(torch.int16) if a.element_size() == 2
                           else a.view(torch.int32),
                           b.view(torch.int16) if b.element_size() == 2
                           else b.view(torch.int32))


@pytest.mark.gpu
def test_streamed_step_equals_the_posthoc_layered_step_on_card(nccl):
    """A reduced deepseek_v2_lite (dense prologue, shared experts, 2
    layers) trained 3 steps through the DistPlan step on the card:
    schedule='stream' against posthoc over the same layered layout, the
    losses and every parameter byte bit for bit."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.core.recipes import get_recipe
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.dist.plan import DistPlan
    from repro_torch.models.lm import ParallelPlan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = dataclasses.replace(get_arch("deepseek_v2_lite").reduced(),
                              d_ff_expert=256)
    opt = AdamWConfig(lr=3e-3)
    runs = []
    for kw in (dict(schedule="stream"), dict(layered=True)):
        dist = DistPlan(wire="fp8", **kw)
        state = init_train_state(cfg, opt, seed=0, device="cuda", dist=dist,
                                 mesh=nccl)
        step = make_train_step(cfg, get_recipe("fp8_flow"), opt, dist=dist,
                               plan=ParallelPlan(mesh=nccl), warmup_steps=5)
        losses = []
        for i in range(3):
            batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=128,
                                          global_batch=4), i, device="cuda")
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        runs.append((losses, state["params"]))
    (la, pa), (lb, pb) = runs
    assert la == lb
    for k in pa["layers"]:
        a, b = pa["layers"][k].detach(), pb["layers"][k].detach()
        iv = {2: torch.int16, 4: torch.int32}[a.element_size()]
        assert torch.equal(a.view(iv), b.view(iv)), k


# ---------------------------------------------------------------------------
# Serving across ranks: the serving cut and TP decode on the card.
# ---------------------------------------------------------------------------
def _grok_layer(dev, d_ff=256):
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import init_params
    cfg = dataclasses.replace(get_arch("grok1_314b").reduced(),
                              d_ff_expert=d_ff, n_layers=1)
    return cfg, init_params(cfg, seed=3, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ep", "tp"])
def test_serving_cut_on_card(card, mode):
    """On the card, each of two model ranks' serving cut, quantized to W8,
    is bit for bit its block of the quantized world-1 tree, and the two
    blocks tile the whole (EP on E, TP on F)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import serving_axis, serving_cut
    from repro_torch.models.lm import ParallelPlan
    from repro_torch.serve.w8 import quantize_params_for_serving
    cfg, params = _grok_layer(card)
    whole = quantize_params_for_serving(params)["layers"]
    blocks = {"we13": [], "we2": []}
    for r in (0, 1):
        plan = ParallelPlan(mesh=Mesh(dp=1, ep=2, rank=r, device=card),
                            moe_mode=mode)
        cut = quantize_params_for_serving(serving_cut(params, cfg,
                                                      plan))["layers"]
        for k in blocks:
            assert cut[k].data.is_cuda
            blocks[k].append(cut[k])
    for k, (a, b) in blocks.items():
        ax = serving_axis(cfg, plan, k)[0]
        data = torch.cat([a.data.view(torch.uint8), b.data.view(torch.uint8)],
                         ax)
        assert torch.equal(data, whole[k].data.view(torch.uint8))
        assert torch.equal(torch.cat([a.scale, b.scale], ax),
                           whole[k].scale)


@pytest.mark.gpu
@pytest.mark.parametrize("combine", ["local_first", "reduce_scatter"])
def test_tp_decode_with_a_group_equals_it_without_on_card(nccl, combine):
    """The decode MoE stage in TP mode (moe_block_tp on W8 experts, the
    serving layout) with the model group of one rank and with none: the
    same bits (each collective a copy), through #1, #2 and #3."""
    from repro_torch import kernels
    from repro_torch.core.recipes import get_recipe
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.serve.w8 import quantize_params_for_serving
    cfg, params = _grok_layer("cuda")
    p = lm.layer_slice(quantize_params_for_serving(params)["layers"], 0)
    x = torch.randn((8, 1, cfg.d_model), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda").to(torch.bfloat16)
    out = []
    for mesh in (make_test_mesh("cuda"), nccl):
        plan = lm.ParallelPlan(mesh=mesh, moe_mode="tp",
                               moe_tp_combine=combine).for_serving()
        kernels.reset_launches()
        with torch.inference_mode():
            y, _ = lm._moe_stage(cfg, get_recipe("fp8_flow"), p, x,
                                 decode=True, plan=plan)
        assert all(kernels.LAUNCHES[k] > 0 for k in (
            "quantize_rowwise", "fused_permute_pad", "grouped_gemm_fp8"))
        out.append(y)
    assert torch.equal(out[0].view(torch.int16), out[1].view(torch.int16))
