"""Training starcoder2_15b (an ungated GELU MLP, LayerNorm with biases,
QKV bias) in all four recipes and grok1_314b (8 GeGLU experts, top-2) in
fp8_flow against the JAX reference on the CPU, at reduced() size from the
reference's init_params(key(0)) carried across bit for bit, on one
make_batch batch of 8 x 64 tokens.

The reference and the bars are tests/test_torch_arch_train.py's: its
whole-model forward on a 1x1 mesh, differentiated with jax.value_and_grad
under jit (the XLA route, remat off); the loss within 1e-3 relative; the
cast ledger by (kind, tag) the reference's (a forward-only trace
subtracted, and the reference's trace-time ledger counted once a scanned
group of layers); tokens routed to other experts only at router near-ties
(``ROUTE_TIE``); and, routed as the reference routed, every leaf's
gradient cosine >= 0.999, with the MLP, expert, router and norm leaves'
gradients nonzero.  GeGLU and GELU carry the tanh bits of
tests/test_torch_acts.py; they stay inside these bars.  The local:global
configs get window 8, which the 64-token rows cross (reduced()'s 64
never bites).

The 0.999 gradient bar is a two-layer bar (reduced() depth).  FP8
gradients drift from the reference's with depth, in every config and not
in bf16: at six layers the lowest leaf cosine of fp8_flow reads 0.99944
(qwen15_05b), 0.99883 (starcoder2_15b), 0.99945 (gemma2_9b), 0.99897
(gemma3_4b), and 0.99993 in bf16 (gemma3_4b).  The port's gradients are
the same on one thread and on eight, and swapping XLA's tanh into the
port's GELU leaves them where they are: the drift is e4m3 codes that
flip on last-bit differences upstream (attention, norms) and add up over
the layers.  A six-layer case is held to ``DEEP_GRAD_COSINE``.

The drift is not the reference's route split.  With the port patched to
the XLA route's roundings (``xla_route_roundings``: silu(g) * u and the
Dgrad-1 accumulator rounded to bf16 before they are quantized) the
six-layer lowest leaf cosine reads 0.99949 for qwen15_05b (0.99944
unpatched), 0.99883 for starcoder2_15b (0.99883) and 0.99897 for
gemma3_4b (0.99897).  The first leaf below 0.999 is layer 0's (the last
one backprop reaches): starcoder2_15b's key bias at 0.99792, a gradient
450 times smaller in norm than the value bias's, whose terms cancel.
The port against itself, with its attention summed over blocks of 16
rows instead of 64 (a change of last bits only), reads 0.99859 on that
leaf in fp8_flow and 0.99992 in bf16: the FP8 backward's own noise floor
at that depth (``test_fp8_gradient_floor_at_six_layers``)."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import contextlib
import dataclasses
import functools

import numpy as np
import pytest

from repro_torch.configs import get_arch
from repro_torch.core.recipes import get_recipe
from test_torch_arch_train import ROUTE_TIE, _cos, _port, _reference
from test_torch_gemma import groups

# both packages' configs: reduced(), then these fields
CUTS = {"starcoder2_15b": {}, "grok1_314b": {},
        "gemma2_9b": dict(window=8), "gemma3_4b": dict(window=8)}
# the lowest leaf gradient cosine held at six layers (measured above:
# 0.99883 to 0.99945)
DEEP_GRAD_COSINE = 0.998


def nonzero_leaves(cfg):
    """The leaves whose reference gradient must be nonzero: the MLP's or
    the experts' and router's, and the norms' (LayerNorm's biases too)."""
    leaves = (["layers/we13", "layers/we2", "layers/w_router"] if cfg.moe
              else ["layers/w13", "layers/w2"])
    leaves += ["layers/ln1_s", "layers/ln2_s", "final_norm_s", "embed"]
    if cfg.norm == "layernorm":
        leaves += ["layers/ln1_b", "layers/ln2_b", "final_norm_b"]
    if cfg.qkv_bias:
        leaves += ["layers/bq", "layers/bv"]
    if cfg.qk_norm:
        leaves += ["layers/q_norm", "layers/k_norm"]
    return leaves


@functools.cache
def _reference_once(arch, name, cut_items):
    """_reference, computed once a module for each (arch, recipe, cut)."""
    return _reference(arch, name, dict(cut_items))


@contextlib.contextmanager
def xla_route_roundings():
    """The port's fp8_flow FFN with the reference XLA route's two bf16
    roundings (ROADMAP.md, Queue 3): silu(g) * u rounded to bf16 before
    its quantize (``repro/core/linear.py:151``), and the Dgrad-1 output
    rounded to bf16 before its quantize (``:93-95``), in place of the
    kernels' quantize of the f32 values.  The ledger events stay."""
    from repro_torch.core import casts, linear
    orig = linear._fused_swiglu_quant, linear._ggemm_quant_out

    def swiglu_quant(recipe, h):
        casts.record("fused_quantize", "swiglu_quant", h.numel())
        return linear._q_row(recipe, linear._swiglu(h), "swiglu_quant",
                             kind="fused_quantize_inner")

    def quant_out(recipe, qx, qw, masked_m=None):
        casts.record("fused_quantize", "dgrad_epilogue", qx.data.shape[0])
        return linear._q_row(recipe, linear._ggemm(recipe, qx, qw,
                                                   masked_m=masked_m),
                             "dgrad_out", kind="fused_quantize_inner")

    linear._fused_swiglu_quant, linear._ggemm_quant_out = (swiglu_quant,
                                                           quant_out)
    try:
        yield
    finally:
        linear._fused_swiglu_quant, linear._ggemm_quant_out = orig


def check_training(arch, name, cut=None, min_cos=0.999,
                   port_route=contextlib.nullcontext):
    """The port's loss, ledger and gradients against the reference's, on
    reduced() with CUTS[arch] (or `cut`) replaced; the port runs inside
    `port_route` (a context manager)."""
    cut = CUTS[arch] if cut is None else cut
    ref_loss, ref_grads, params_np, batch_np, jled, ref_ids = \
        _reference_once(arch, name, tuple(sorted(cut.items())))
    with port_route():
        loss, grads, led, calls = _port(arch, get_recipe(name), params_np,
                                        batch_np, cut=cut)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **cut)
    assert np.isfinite(loss)
    assert abs(loss - ref_loss) / abs(ref_loss) <= 1e-3, (loss, ref_loss)
    assert len(calls) == len(ref_ids) == (cfg.n_layers if cfg.moe else 0)
    for (ids, gaps), rid in zip(calls, ref_ids):
        moved = (np.sort(ids, -1) != np.sort(rid, -1)).any(-1)
        assert (gaps[moved] < ROUTE_TIE).all(), gaps[moved]

    def outer(ledger, n=1):
        return {k: v * n for k, v in ledger.items()
                if not k[0].endswith("_inner")}

    assert outer(led) == outer(jled, groups(cfg))
    if name == "fp8_flow" and cfg.act != "swiglu":
        for tag in ("act_quant", "dact_quant"):
            assert led[("fused_quantize", tag)] == cfg.n_layers, tag
    if cfg.moe:                     # the gradients, routed as the reference
        with port_route():
            loss, grads, _, _ = _port(arch, get_recipe(name), params_np,
                                      batch_np, ref_ids, cut=cut)
        assert abs(loss - ref_loss) / abs(ref_loss) <= 1e-3, (loss, ref_loss)
    assert grads.keys() == ref_grads.keys()
    low = {p: _cos(grads[p], ref_grads[p]) for p in grads}
    low = {p: c for p, c in low.items() if not c >= min_cos}
    assert not low, low
    need = nonzero_leaves(cfg)
    assert all(np.abs(ref_grads[p]).max() > 0 for p in need), need


@pytest.mark.parametrize("name", ["fp8_flow", "bf16", "blockwise",
                                  "naive_fp8"])
def test_starcoder2_loss_grads_and_ledger_match_reference(name):
    check_training("starcoder2_15b", name)


def test_grok1_loss_grads_and_ledger_match_reference():
    check_training("grok1_314b", "fp8_flow")


def test_fp8_gradient_floor_at_six_layers():
    """The port against itself at six layers of starcoder2_15b (its own
    params from seed 0, make_batch's 8 x 64 tokens): attention summed
    over blocks of 16 rows instead of 64 changes last bits only, and moves
    the lowest leaf's gradient to cosine 0.999 or lower in fp8_flow (the
    six-layer bar holds), but to no lower than 0.9999 in bf16."""
    import torch
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import layers, lm
    from repro_torch.optim.adamw import tree_leaves
    from test_torch_archs import _named
    cfg = dataclasses.replace(get_arch("starcoder2_15b").reduced(),
                              n_layers=6)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8), 0, device="cpu")

    def grads(name, block_k):
        params = lm.init_params(cfg, seed=0, device="cpu")
        for p in tree_leaves(params):
            p.requires_grad_()
        flash = layers.flash_attention
        layers.flash_attention = functools.partial(flash, block_k=block_k)
        try:
            lm.forward(cfg, get_recipe(name), params, batch)[0].backward()
        finally:
            layers.flash_attention = flash
        return {k: p.grad.to(torch.float32).numpy()
                for k, p in _named(params).items()}

    low = {}
    for name in ("fp8_flow", "bf16"):
        a, b = grads(name, 64), grads(name, 16)
        low[name] = min(_cos(a[k], b[k]) for k in a)
    assert DEEP_GRAD_COSINE <= low["fp8_flow"] <= 0.9995, low
    assert low["bf16"] >= 0.9999, low
