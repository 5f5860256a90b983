"""The port's ``dense_mlp`` (a dense layer's MLP and the shared experts')
against the JAX reference's on the CPU, for every recipe, on the same
numpy inputs: T = 72 tokens, not a multiple of 128, so the zero padding
of the token axis and its slicing are under test.

Forward and every gradient are held to the expert FFN parity tests' bar,
cosine >= 0.999 (tests/test_torch_recipes.py, tests/test_torch_train.py),
and to a largest relative error per recipe measured on these inputs
(``DENSE_MAX_REL``, as ``FFN_MAX_REL`` is on the FFN's), against the
reference's XLA route, the route of its recipe tests; fp8_flow also
against its Pallas route (interpret mode), as tests/test_torch_train.py
holds the expert FFN: there the output and every gradient are the
reference's bits.  The cast ledger matches event for event (less the
XLA route's unfused inner quantizes), and the masked recipe (no
``masked_m`` here: the padded kernels) is the padded one bit for bit."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import casts as jcasts
from repro.core import recipes as jrecipes
from repro.core.linear import dense_mlp as jdense_mlp
from repro_torch.core import casts, recipes
from repro_torch.core.linear import dense_mlp
from test_torch_recipes import NAMES, _cos, _events, _max_rel, _np32, _t

T, D, F = 72, 256, 256

# max |port - reference| / max |reference| over (y, gx, wg13, wg2) on
# _inputs() against the XLA route only, with about the FFN bars' margin
# (FFN_MAX_REL: 1.35x).  Measured: bf16 1.16e-5 (2 of 18,432 gx lanes one
# bf16 step apart: f32 sums in another order), blockwise 0.0539,
# naive_fp8 0.0626, fp8_flow 0.163 (wg2; cosines >= 0.9993).  These lie
# above FFN_MAX_REL (1e-5 / 0.05 / 0.05 / 0.15), measured on the expert
# FFN test's inputs, and are the XLA route's, not the port's: as for the
# FFN, the FP8 differences are e4m3 code steps where that route's bf16
# rounding of linear scales or of the SwiGLU product lands a value across
# a rounding boundary.  Against the Pallas route fp8_flow is bit for bit
# (test_dense_mlp_fp8_flow_matches_reference_pallas_route); on the XLA
# route's operands the baselines are the reference to f32 summation
# order (test_dense_mlp_with_xla_route_operands).
DENSE_MAX_REL = {"bf16": 2e-5, "blockwise": 0.075, "naive_fp8": 0.085,
                 "fp8_flow": 0.22}


def _inputs():
    """bf16 x (T, D) and f32 weights w13 (D, 2F), w2 (F, D)."""
    r = np.random.default_rng(11)
    x = jnp.asarray(r.normal(size=(T, D)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    w13 = jnp.asarray(r.normal(size=(D, 2 * F)).astype(np.float32) * 0.05)
    w2 = jnp.asarray(r.normal(size=(F, D)).astype(np.float32) * 0.05)
    return x, w13, w2


def _ref(recipe, inputs):
    def fwd(x, w13, w2):
        return jdense_mlp(recipe, "swiglu", x, w13, w2)

    with jcasts.ledger() as led:
        y, vjp = jax.vjp(fwd, *inputs)
        grads = vjp((2 * y.astype(jnp.float32)).astype(y.dtype))
    return ([np.asarray(y, np.float32)]
            + [np.asarray(g, np.float32) for g in grads]), led


def _port(recipe, inputs):
    x, w13, w2 = (_t(a).requires_grad_() for a in inputs)
    with casts.ledger() as led:
        y = dense_mlp(recipe, "swiglu", x, w13, w2)
        y.backward((2 * y.detach().to(torch.float32)).to(y.dtype))
    return [_np32(t) for t in (y, x.grad, w13.grad, w2.grad)], led


def _hold(got, ref, max_rel, what):
    for name, a, b in zip(("y", "gx", "wg13", "wg2"), got, ref):
        assert a.shape == b.shape and np.isfinite(a).all(), (what, name)
        assert np.abs(a).max() > 0, (what, name)
        assert _cos(a, b) >= 0.999, (what, name, _cos(a, b))
        assert _max_rel(a, b) <= max_rel, (what, name, _max_rel(a, b))


@pytest.mark.parametrize("name", NAMES)
def test_dense_mlp_matches_reference(name):
    """Output, input and weight gradients against the reference's XLA
    route, and its cast ledger event for event."""
    inputs = _inputs()
    ref, jled = _ref(jrecipes.get_recipe(name), inputs)
    got, led = _port(recipes.get_recipe(name), inputs)
    assert got[0].shape == (T, D)
    _hold(got, ref, DENSE_MAX_REL[name], name)
    assert _events(led) == _events(jled)


def test_dense_mlp_fp8_flow_matches_reference_pallas_route():
    """fp8_flow against the reference's Pallas route (interpret mode):
    the output and every gradient bit for bit, the same cast ledger."""
    inputs = _inputs()
    jr = dataclasses.replace(jrecipes.get_recipe("fp8_flow"), use_pallas=True)
    ref, jled = _ref(jr, inputs)
    got, led = _port(recipes.get_recipe("fp8_flow"), inputs)
    for name, a, b in zip(("y", "gx", "wg13", "wg2"), got, ref):
        assert a.shape == b.shape and np.abs(a).max() > 0, name
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), name
    assert _events(led) == _events(jled)
    assert led.activation_casts() == 2


@pytest.mark.parametrize("name", ["blockwise", "naive_fp8"])
def test_dense_mlp_with_xla_route_operands(name, monkeypatch):
    """The baselines' dense MLP with its GEMMs on the reference XLA
    route's operands (each dequantized to bf16, f32 sums), as
    tests/test_torch_recipes.py's test_expert_ffn_with_xla_route_operands
    holds the expert FFN: the reference to f32 summation order, so the
    DENSE_MAX_REL gap above is the bf16 rounding of the linear scales."""
    from repro_torch.core import linear
    from repro_torch.core.quant import _dequantize_nocount

    def bf16_operand(q):
        return _dequantize_nocount(q, torch.bfloat16).to(torch.float32)

    monkeypatch.setattr(linear, "_ggemm", lambda r, qx, qw, out_dtype=(
        torch.bfloat16), masked_m=None: torch.matmul(
            bf16_operand(qx), bf16_operand(qw)).to(out_dtype))
    monkeypatch.setattr(linear, "_ggemm_nt", lambda r, qa, qb, out_dtype=(
        torch.float32), masked_m=None: torch.einsum(
            "emc,enc->emn", bf16_operand(qa), bf16_operand(qb)).to(out_dtype))
    inputs = _inputs()
    ref, _ = _ref(jrecipes.get_recipe(name), inputs)
    got, _ = _port(recipes.get_recipe(name), inputs)
    for what, a, b in zip(("y", "gx", "wg13", "wg2"), got, ref):
        assert _cos(a, b) >= 0.99999, (name, what, _cos(a, b))
        assert _max_rel(a, b) <= 2e-3, (name, what, _max_rel(a, b))


def test_dense_mlp_masked_recipe_is_the_padded_one():
    """A dense MLP has no expert plan, so the masked recipe runs the
    padded kernels: the same output and gradients, bit for bit."""
    inputs = _inputs()
    got, _ = _port(recipes.get_recipe("fp8_flow"), inputs)
    masked, _ = _port(recipes.get_recipe(
        "fp8_flow", masked_experts=True, swiglu_epilogue=True), inputs)
    for a, b in zip(got, masked):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_dense_mlp_pads_the_model_axis():
    """A d_model that is not a multiple of 128 (hymba's 1600, cut to
    200 here) is zero-padded and sliced back, as in the reference."""
    r = np.random.default_rng(12)
    x = jnp.asarray(r.normal(size=(40, 200)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    w13 = jnp.asarray(r.normal(size=(200, 2 * F)).astype(np.float32) * 0.05)
    w2 = jnp.asarray(r.normal(size=(F, 200)).astype(np.float32) * 0.05)
    ref, _ = _ref(jrecipes.get_recipe("fp8_flow"), (x, w13, w2))
    got, _ = _port(recipes.get_recipe("fp8_flow"), (x, w13, w2))
    assert [a.shape for a in got] == [(40, 200), (40, 200), (200, 2 * F),
                                      (F, 200)]
    _hold(got, ref, DENSE_MAX_REL["fp8_flow"], "D=200")
