"""The port's GeGLU, GELU and ReLU expert FFNs and dense MLPs against the
JAX reference on the CPU, in every recipe, on the same numpy inputs.

The activations are the reference's table (``repro/core/linear.py``
``_ACT_FWD`` / ``_ACT_BWD``).  SwiGLU and ReLU are its bits.  GELU (the
tanh approximation) is written in the reference's f32 ops and order, but
torch's tanh and XLA's differ in the last bits, as their sigmoid does
(ROADMAP.md, Queue 3): about 4% of the bf16 activations and activation
gradients sit one bf16 step apart (more where XLA's tanh saturates to
exactly -1 and torch's does not, a difference below 2e-6 in value).  The
bar there, as for the sigmoid: after the row-wise quantize that follows
the activation (fp8_flow's ``act_quant`` / ``dact_quant``, the baselines'
GEMM-input quantizes) the scales are equal and the e4m3 codes within one,
on at most ``GELU_CODES_OFF`` of the lanes.

The expert FFN (E = 2 groups of 128 rows) and ``dense_mlp`` (72 tokens,
padded to 128) are held as their SwiGLU forms are (tests/
test_torch_recipes.py, tests/test_torch_dense.py): output and every
gradient cosine >= 0.999 against the reference's XLA route, the largest
relative error per recipe and activation (``MAX_REL``, measured), and the
cast ledger event for event; fp8_flow also against the reference's
Pallas route in interpret mode, and its masked recipe against the
reference's masked Pallas route and bit for bit against the port's
padded route (a non-SwiGLU FFN runs no fused epilogue: #5 GEMM-1, the
activation, #1)."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import casts as jcasts
from repro.core import linear as jlinear
from repro.core import recipes as jrecipes
from repro.core.linear import dense_mlp as jdense_mlp
from repro.core.linear import expert_ffn as jexpert_ffn
from repro.core.linear import quantize_entry as jquantize_entry
from repro_torch.core import casts, linear, recipes
from repro_torch.core.linear import dense_mlp, expert_ffn, quantize_entry
from repro_torch.kernels import ops
from test_cast_count import EXPECTED_FFN
from test_torch_recipes import NAMES, _cos, _events, _max_rel, _np32, _t

ACTS = ["geglu", "gelu", "relu"]
GATE = {"swiglu": 2, "geglu": 2, "gelu": 1, "relu": 1}
MASKED = dict(masked_experts=True, swiglu_epilogue=True)

# The share of e4m3 codes one step apart between the port's and the
# reference's activation (or its gradient) after #1's row-wise quantize,
# where the two tanh differ.  Measured on _act_inputs: 0 (GELU forward),
# 4.6e-5 (GeGLU forward), 6.1e-4 (GeGLU backward), 1.5e-3 (GELU
# backward); the SwiGLU bar of tests/test_torch_masked.py is 1%.
GELU_CODES_OFF = 0.01

# max |port - reference| / max |reference| over (y, gx, wg13, wg2) on
# _ffn_inputs and _dense_inputs against the XLA route, by recipe and
# activation: ~1.35x the larger of the two measured (the SwiGLU bars'
# margin), the measured values beside each.  bf16 GELU and ReLU are the
# reference's bits; bf16 GeGLU differs by its tanh bits (cosines 1.0).
# The FP8 recipes' differences are e4m3 code steps where the XLA route
# rounds a linear scale to bf16 (blockwise, naive_fp8; with the XLA
# route's operands they vanish, test_baselines_with_xla_route_operands)
# or computes Dgrad-1 unfused (fp8_flow's gx; its y and weight gradients
# are the reference's to 1e-7 or bit for bit).  ReLU's many exact zeros
# put more of its gradient on such steps: its baselines' wg13 reach
# 0.117, above the SwiGLU dense bar (0.085).
MAX_REL = {
    ("bf16", "geglu"): 0.002,           # 0.0015 (FFN gx)
    ("bf16", "gelu"): 1e-5,             # 0
    ("bf16", "relu"): 1e-5,             # 0
    ("blockwise", "geglu"): 0.0625,     # 0.0463 (dense wg2)
    ("blockwise", "gelu"): 0.056,       # 0.0415 (dense wg13)
    ("blockwise", "relu"): 0.16,        # 0.117 (dense wg13)
    ("naive_fp8", "geglu"): 0.067,      # 0.0495 (dense wg2)
    ("naive_fp8", "gelu"): 0.057,       # 0.0425 (dense wg13)
    ("naive_fp8", "relu"): 0.16,        # 0.116 (dense wg13)
    ("fp8_flow", "geglu"): 0.135,       # 0.100 (FFN gx)
    ("fp8_flow", "gelu"): 0.11,         # 0.0833 (dense gx)
    ("fp8_flow", "relu"): 0.1,          # 0.0714 (dense gx)
}

XLA_OPERANDS_MAX_REL = {"relu": 2e-3, "geglu": 5e-3, "gelu": 0.02}


def _act_inputs(act, seed=0):
    """bf16 h (256, g*256) with |h| up to ~12 (the tanh's saturated tails
    included) and a bf16 cotangent (256, 256)."""
    r = np.random.default_rng(seed)
    g = GATE[act]
    h = jnp.asarray(r.normal(size=(256, g * 256)).astype(np.float32) * 3
                    ).astype(jnp.bfloat16)
    ga = jnp.asarray(r.normal(size=(256, 256)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    return h, ga


def _codes(q):
    """e4m3 codes as signed magnitudes (+0 and -0 both 0)."""
    d = q.data.view(torch.uint8).numpy().astype(np.int32)
    return np.where(d >= 128, -(d - 128), d)


@pytest.mark.parametrize("act", ["swiglu"] + ACTS)
def test_activation_table_matches_reference(act):
    """The forward and backward of each activation on the same bf16
    inputs: SwiGLU and ReLU bit for bit; GeGLU and GELU, quantized
    row-wise by #1's twin, equal scales and codes within one on at most
    GELU_CODES_OFF of the lanes, the bf16 values at cosine >= 0.99999."""
    h, ga = _act_inputs(act)
    th, tga = _t(h), _t(ga)
    got = (linear._act_fwd(act, th), linear._act_bwd(act, th, tga))
    ref = (jlinear._act_fwd(act, h), jlinear._act_bwd(act, h, ga))
    for what, a, b in zip(("fwd", "bwd"), got, ref):
        b = _t(b)
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
        if act in ("swiglu", "relu"):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16)), what
            continue
        assert _cos(_np32(a), _np32(b)) >= 0.99999, (what, _cos(_np32(a),
                                                                _np32(b)))
        qa, qb = ops.quantize_rowwise(a), ops.quantize_rowwise(b)
        assert torch.equal(qa.scale, qb.scale), what
        off = np.abs(_codes(qa) - _codes(qb))
        assert off.max() <= 1 and off.mean() <= GELU_CODES_OFF, (
            what, off.max(), off.mean())


def test_gelu_backward_is_the_derivative():
    """The hand-written GELU derivative against autograd through the
    port's own forward, in f64 (no rounding of either order)."""
    t = torch.linspace(-12, 12, 4001, dtype=torch.float64,
                       requires_grad=True)
    ct = torch.cos(3 * t.detach())
    linear._gelu_f32(t).backward(ct)
    assert torch.allclose(linear._dgelu_f32(t.detach(), ct), t.grad,
                          rtol=1e-12, atol=1e-12)


def _ffn_inputs(act, seed=0, E=2, C=128, K=256, F=128):
    """tests/test_torch_recipes.py's _ffn_inputs with w13 (E, K, g*F)."""
    r = np.random.default_rng(seed)
    x = jnp.asarray(r.normal(size=(E, C, K)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    w13 = jnp.asarray(r.normal(size=(E, K, GATE[act] * F)).astype(np.float32)
                      * 0.05)
    w2 = jnp.asarray(r.normal(size=(E, F, K)).astype(np.float32) * 0.05)
    return x, w13, w2


def _ref_ffn(recipe, act, inputs, masked_m=None, live=None):
    """y and the gradients of x, w13, w2 under the loss sum((2 y)^2 / 4)
    (cotangent 2y; dead rows zeroed by `live`), and the ledger."""
    fp8 = recipe.name == "fp8_flow"
    mm = None if masked_m is None else jnp.asarray(masked_m)

    def fwd(x, w13, w2):
        xi = jquantize_entry(recipe, x) if fp8 else x
        y = jexpert_ffn(recipe, act, (), (), xi, w13, w2, mm)
        yl = y.astype(jnp.float32) * (1.0 if live is None else live)
        return jnp.sum(yl ** 2), y

    with jcasts.ledger() as led:
        (_, y), grads = jax.value_and_grad(fwd, argnums=(0, 1, 2),
                                           has_aux=True)(*inputs)
    return ([np.asarray(y, np.float32)]
            + [np.asarray(g, np.float32) for g in grads]), led


def _port_ffn(recipe, act, inputs, masked_m=None, live=None):
    x, w13, w2 = (_t(a).requires_grad_() for a in inputs)
    mm = None if masked_m is None else torch.from_numpy(masked_m)
    with casts.ledger() as led:
        xi = quantize_entry(recipe, x) if recipe.name == "fp8_flow" else x
        y = expert_ffn(recipe, act, xi, w13, w2, mm)
        yl = y.to(torch.float32) * (1.0 if live is None
                                    else torch.from_numpy(live))
        (yl ** 2).sum().backward()
    return [_np32(t) for t in (y, x.grad, w13.grad, w2.grad)], led


def _hold(got, ref, max_rel, what):
    for name, a, b in zip(("y", "gx", "wg13", "wg2"), got, ref):
        assert a.shape == b.shape and np.isfinite(a).all(), (what, name)
        assert np.abs(a).max() > 0, (what, name)
        assert _cos(a, b) >= 0.999, (what, name, _cos(a, b))
        assert _max_rel(a, b) <= max_rel, (what, name, _max_rel(a, b))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("act", ACTS)
def test_expert_ffn_matches_reference(act, name):
    """Output and gradients against the XLA route; the cast ledger event
    for event (fp8_flow: the entry quantize, ``act_quant``, the island
    quantize, ``dact_quant``, the Dgrad-1 epilogue; EXPECTED_FFN casts)."""
    inputs = _ffn_inputs(act)
    ref, jled = _ref_default("ffn", name, act)
    got, led = _port_ffn(recipes.get_recipe(name), act, inputs)
    _hold(got, ref, MAX_REL[name, act], (name, act))
    assert _events(led) == _events(jled)
    extra = 1 if name == "fp8_flow" else 0          # the entry quantize
    assert led.activation_casts() == EXPECTED_FFN[name] + extra
    if name == "fp8_flow":
        tags = {e.tag for e in led.events}
        assert {"act_quant", "dact_quant"} <= tags
        assert "swiglu_quant" not in tags


@pytest.mark.parametrize("act", ACTS)
def test_fp8_flow_matches_reference_pallas_route(act):
    """fp8_flow against the reference's Pallas route (interpret mode): the
    GEMMs and quantizes are its bits, so ReLU's output and gradients are
    the reference's bit for bit; GeGLU and GELU differ only where a tanh
    bit moves a code (cosine >= 0.9999)."""
    inputs = _ffn_inputs(act)
    jr = jrecipes.get_recipe("fp8_flow", use_pallas=True)
    ref, jled = _ref_ffn(jr, act, inputs)
    got, led = _port_ffn(recipes.get_recipe("fp8_flow"), act, inputs)
    for what, a, b in zip(("y", "gx", "wg13", "wg2"), got, ref):
        assert np.abs(a).max() > 0, what
        if act == "relu":
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), what
        else:
            assert _cos(a, b) >= 0.9999, (what, _cos(a, b))
    assert _events(led) == _events(jled)


# tests/test_torch_masked.py's partial plan (its dead-expert plan runs
# the same kernels whatever the activation)
MASKS = {"partial": [48, 128]}


def _masked_inputs(act, mm):
    """The FFN inputs with the rows beyond each expert's count zeroed (the
    dispatch layout) and the live-row mask."""
    x, w13, w2 = _ffn_inputs(act)
    live = (np.arange(x.shape[1])[None, :] < mm[:, None]).astype(
        np.float32)[..., None]
    x = (x.astype(jnp.float32) * live).astype(jnp.bfloat16)
    return (x, w13, w2), live


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("act", ACTS)
def test_masked_expert_ffn(act, mask):
    """The masked recipe on a non-SwiGLU FFN (no fused epilogue: #5 GEMM-1,
    the activation, #1): against the reference's masked Pallas route
    (cosine >= 0.999, the same ledger multiset) and the port's padded
    route bit for bit."""
    mm = np.asarray(MASKS[mask], np.int32)
    inputs, live = _masked_inputs(act, mm)
    jr = jrecipes.get_recipe("fp8_flow", use_pallas=True, **MASKED)
    ref, jled = _ref_ffn(jr, act, inputs, mm, live)
    got, led = _port_ffn(recipes.get_recipe("fp8_flow", **MASKED), act,
                         inputs, mm, live)
    for what, a, b in zip(("y", "gx", "wg13", "wg2"), got, ref):
        assert np.isfinite(a).all() and _cos(a, b) >= 0.999, (what,
                                                               _cos(a, b))
    assert Counter(led.by_tag()) == Counter(jled.by_tag())
    assert ("fused_quantize", "act_quant") in led.by_tag()
    padded, _ = _port_ffn(recipes.get_recipe("fp8_flow"), act, inputs,
                          live=live)
    for a, b in zip(got, padded):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


T, D, F = 72, 256, 256


def _dense_inputs(act):
    """tests/test_torch_dense.py's inputs with w13 (D, g*F)."""
    r = np.random.default_rng(11)
    x = jnp.asarray(r.normal(size=(T, D)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    w13 = jnp.asarray(r.normal(size=(D, GATE[act] * F)).astype(np.float32)
                      * 0.05)
    w2 = jnp.asarray(r.normal(size=(F, D)).astype(np.float32) * 0.05)
    return x, w13, w2


def _ref_dense(recipe, act, inputs):
    def fwd(x, w13, w2):
        return jdense_mlp(recipe, act, x, w13, w2)

    with jcasts.ledger() as led:
        y, vjp = jax.vjp(fwd, *inputs)
        grads = vjp((2 * y.astype(jnp.float32)).astype(y.dtype))
    return ([np.asarray(y, np.float32)]
            + [np.asarray(g, np.float32) for g in grads]), led


def _port_dense(recipe, act, inputs):
    x, w13, w2 = (_t(a).requires_grad_() for a in inputs)
    with casts.ledger() as led:
        y = dense_mlp(recipe, act, x, w13, w2)
        y.backward((2 * y.detach().to(torch.float32)).to(y.dtype))
    return [_np32(t) for t in (y, x.grad, w13.grad, w2.grad)], led


@functools.cache
def _ref_default(kind, name, act):
    """The reference's XLA-route expert FFN (kind "ffn", on _ffn_inputs)
    or dense MLP ("dense", on _dense_inputs) of recipe `name`, computed
    once a module: the parity cases and the XLA-operand cases share it."""
    if kind == "ffn":
        return _ref_ffn(jrecipes.get_recipe(name), act, _ffn_inputs(act))
    return _ref_dense(jrecipes.get_recipe(name), act, _dense_inputs(act))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("act", ACTS)
def test_dense_mlp_matches_reference(act, name):
    """dense_mlp (T = 72, padded to 128 rows) against the XLA route, its
    ledger event for event, and the masked recipe (no expert plan: the
    padded kernels) the padded one bit for bit."""
    inputs = _dense_inputs(act)
    ref, jled = _ref_default("dense", name, act)
    got, led = _port_dense(recipes.get_recipe(name), act, inputs)
    assert got[0].shape == (T, D)
    _hold(got, ref, MAX_REL[name, act], (name, act, "dense"))
    assert _events(led) == _events(jled)
    if name == "fp8_flow":
        masked, _ = _port_dense(recipes.get_recipe(name, **MASKED), act,
                                inputs)
        for a, b in zip(got, masked):
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("kind", ["ffn", "dense"])
@pytest.mark.parametrize("name", ["blockwise", "naive_fp8"])
@pytest.mark.parametrize("act", ACTS)
def test_baselines_with_xla_route_operands(act, name, kind, monkeypatch):
    """The baselines with their GEMMs on the reference XLA route's
    operands (each dequantized to bf16: payload x bf16-rounded scale, f32
    sums), as tests/test_torch_recipes.py holds the SwiGLU FFN: the
    reference to f32 summation order and the tanh bits, so the MAX_REL
    gaps above are the bf16 rounding of the linear scales.  ReLU is held
    to the SwiGLU bar (2e-3; measured 2.9e-4); a GeGLU or GELU tanh bit
    moves a few e4m3 codes (measured 3.4e-3 and 0.0144: the GELU dense
    MLP's gx, cosine 0.999998)."""
    from repro_torch.core.quant import _dequantize_nocount

    def bf16_operand(q):
        return _dequantize_nocount(q, torch.bfloat16).to(torch.float32)

    monkeypatch.setattr(linear, "_ggemm", lambda r, qx, qw, out_dtype=(
        torch.bfloat16), masked_m=None: torch.matmul(
            bf16_operand(qx), bf16_operand(qw)).to(out_dtype))
    monkeypatch.setattr(linear, "_ggemm_nt", lambda r, qa, qb, out_dtype=(
        torch.float32), masked_m=None: torch.einsum(
            "emc,enc->emn", bf16_operand(qa), bf16_operand(qb)).to(out_dtype))
    if kind == "ffn":
        inputs = _ffn_inputs(act)
        ref, _ = _ref_default("ffn", name, act)
        got, _ = _port_ffn(recipes.get_recipe(name), act, inputs)
    else:
        inputs = _dense_inputs(act)
        ref, _ = _ref_default("dense", name, act)
        got, _ = _port_dense(recipes.get_recipe(name), act, inputs)
    for what, a, b in zip(("y", "gx", "wg13", "wg2"), got, ref):
        assert _cos(a, b) >= 0.99999, (what, _cos(a, b))
        assert _max_rel(a, b) <= XLA_OPERANDS_MAX_REL[act], (
            what, _max_rel(a, b))
