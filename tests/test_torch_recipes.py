"""The port's bf16, blockwise and naive_fp8 recipes (and fp8_flow beside
them) against the JAX reference on the CPU, on the same numpy inputs.

Held bit for bit: the linear-scale quantize (the port's plain function,
the kernel's twin and ``ops.quantize_rowwise``), ``quantize_colwise``,
``transpose_naive`` and ``double_quant_error`` (po2 and linear, on
tests/test_double_quant.py's seeded cases), the cast ledgers ((kind, tag)
in order; tests/test_cast_count.py's counts).  Held to a tolerance: the
expert FFN's output and gradients and the MoE block's, cosine >= 0.999
against the reference's XLA route (``use_pallas=False``, the route its own
recipe tests run), with the largest relative error stated per recipe.
Where they differ: the XLA route dequantizes GEMM operands to bf16, which
rounds a linear scale to bf16 (exact only for po2), and rounds the SwiGLU
product to bf16 where fp8_flow's fused kernel quantizes the f32 product;
the port's GEMMs promote with the f32 scales, as the reference's Pallas
kernels do (held here too, in interpret mode, on linear-scale operands)."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import casts as jcasts
from repro.core import quant as jquant
from repro.core import recipes as jrecipes
from repro.core import transpose as jtranspose
from repro.core.linear import dequantize_exit as jdequantize_exit
from repro.core.linear import expert_ffn as jexpert_ffn
from repro.core.linear import quantize_entry as jquantize_entry
from repro.core.moe import MoEConfig as JMoEConfig
from repro.core.moe import fp8_dispatch_naive as jfp8_dispatch_naive
from repro.core.moe import moe_block as jmoe_block
from repro.kernels.grouped_gemm_fp8 import grouped_gemm_fp8_pallas
from repro.kernels.grouped_gemm_nt_fp8 import grouped_gemm_nt_fp8_pallas
from repro_torch.core import casts, quant, recipes, transpose
from repro_torch.core.linear import (dequantize_exit, expert_ffn,
                                     quantize_entry)
from repro_torch.core.moe import MoEConfig, fp8_dispatch_naive, moe_block
from repro_torch.kernels import ops
from repro_torch.kernels.grouped_gemm_fp8 import grouped_gemm_fp8_plain
from repro_torch.kernels.grouped_gemm_nt_fp8 import grouped_gemm_nt_fp8_plain
from repro_torch.kernels.quantize import quantize_rowwise_linear_plain
from repro_torch.weights import tensor_from_numpy
from test_cast_count import EXPECTED_FFN, EXPECTED_MOE
from test_double_quant import SEEDED_CASES, _rand_x
from torch_quant_inputs import KINDS, quant_inputs

NAMES = list(EXPECTED_MOE)          # bf16, blockwise, naive_fp8, fp8_flow


def _t(a):
    return tensor_from_numpy(np.asarray(a), device="cpu")


def _u8(a):
    return np.asarray(a).view(np.uint8)


def _bits(t):
    return t.view(torch.uint8).numpy()


def _np32(t):
    return t.detach().to(torch.float32).numpy()


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _max_rel(a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _events(led):
    """(kind, tag) of every event in order, less ``fused_quantize_inner``:
    the reference's XLA route records it inside the fused kernels it
    emulates (swiglu_quant, dgrad_out), the port's kernels do not."""
    return [(e.kind, e.tag) for e in led.events
            if e.kind != "fused_quantize_inner"]


# ---------------------------------------------------------------------------
# Recipes.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_get_recipe_presets_match_reference(name):
    r, jr = recipes.get_recipe(name), jrecipes.get_recipe(name)
    assert name in recipes.RECIPES
    assert r.scale_mode == jr.scale_mode
    assert r.scale_mode == ("po2" if name in ("bf16", "fp8_flow")
                            else "linear")
    assert (r.is_fp8, r.fp8_dispatch, r.fp8_dispatch_bwd) == (
        jr.is_fp8, jr.fp8_dispatch, jr.fp8_dispatch_bwd)


def test_what_still_raises():
    with pytest.raises(NotImplementedError, match="po2"):
        recipes.get_recipe("fp8_flow", scale_mode="linear")
    with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
        recipes.get_recipe("blockwise", save_h=True)
    with pytest.raises(ValueError):
        recipes.get_recipe("fp16")


# ---------------------------------------------------------------------------
# The linear quantize and the naive transpose: bit for bit.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_quantize_rowwise_bitwise(kind, dtype):
    """Random values, amax exactly 448 * 2**e, |exp| up to 40 and zero
    tiles: the port's quantize, the kernel's twin and the ops wrapper are
    the reference's linear quantize_rowwise bit for bit."""
    rng = np.random.default_rng([KINDS.index(kind), dtype == "bfloat16", 1])
    xj = jnp.asarray(quant_inputs(kind, rng, (48, 384))).astype(dtype)
    qj = jquant.quantize_rowwise(xj, scale_mode="linear")
    xt = _t(xj)
    qt = quant.quantize_rowwise(xt, "linear")
    assert qt.tile == tuple(qj.tile)
    ref_d, ref_s = _u8(qj.data), np.asarray(qj.scale)
    assert np.array_equal(qt.scale.numpy(), ref_s)
    assert np.array_equal(_bits(qt.data), ref_d)
    d, s = quantize_rowwise_linear_plain(xt)
    assert np.array_equal(_bits(d), ref_d) and np.array_equal(s.numpy(), ref_s)
    q = ops.quantize_rowwise(xt, "linear")
    assert np.array_equal(_bits(q.data), ref_d)
    assert np.array_equal(q.scale.numpy(), ref_s)
    if kind == "zero_tiles":
        assert (ref_s[1::3] == 1.0).all()
    if kind == "po2_amax":
        # amax = 448 * 2**e: the linear scale is the power of two itself
        amax = np.abs(np.asarray(xj.astype(jnp.float32))).reshape(48, 3, 128)
        assert np.array_equal(ref_s, amax.max(-1) / 448.0)


@pytest.mark.parametrize("scale_mode", ["po2", "linear"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_colwise_and_blockwise_quantize_bitwise(scale_mode, dtype):
    xj = jnp.asarray(_rand_x(3, 256, 384, 2.0)).astype(dtype)
    for jfn, fn in ((jquant.quantize_colwise, quant.quantize_colwise),
                    (jquant.quantize_blockwise, quant.quantize_blockwise)):
        qj = jfn(xj, scale_mode=scale_mode)
        qt = fn(_t(xj), scale_mode)
        assert qt.tile == tuple(qj.tile)
        assert np.array_equal(qt.scale.numpy(), np.asarray(qj.scale))
        assert np.array_equal(_bits(qt.data), _u8(qj.data))


@pytest.mark.parametrize("seed,shape,spread", SEEDED_CASES)
@pytest.mark.parametrize("scale_mode", ["po2", "linear"])
def test_double_quant_error_bitwise(seed, shape, spread, scale_mode):
    """Paper Eq. (1) on tests/test_double_quant.py's seeded cases, with the
    reference's ledger; linear scales leave a nonzero error."""
    x = _rand_x(seed, *shape, spread)
    with jcasts.ledger() as jled:
        ej = np.asarray(jtranspose.double_quant_error(x, scale_mode))
    with casts.ledger() as led:
        et = transpose.double_quant_error(_t(x), scale_mode).numpy()
    assert np.array_equal(et, ej)
    assert _events(led) == _events(jled)
    if scale_mode == "linear":
        assert np.abs(et).mean() > 0


@pytest.mark.parametrize("scale_mode", ["po2", "linear"])
@pytest.mark.parametrize("shape", [(256, 384), (2, 128, 256)])
def test_transpose_naive_bitwise(scale_mode, shape):
    xj = jnp.asarray(_rand_x(5, int(np.prod(shape[:-1])), shape[-1], 2.0)
                     ).reshape(shape)
    qj = jquant.quantize_rowwise(xj, scale_mode=scale_mode)
    with jcasts.ledger() as jled:
        rj = jtranspose.transpose_naive(qj, scale_mode)
    q = quant.QTensor(_t(qj.data), _t(qj.scale), tuple(qj.tile))
    with casts.ledger() as led:
        rt = transpose.transpose_naive(q, scale_mode)
    assert rt.tile == tuple(rj.tile)
    assert np.array_equal(_bits(rt.data), _u8(rj.data))
    assert np.array_equal(rt.scale.numpy(), np.asarray(rj.scale))
    assert _events(led) == _events(jled) == [
        ("dequantize", "dq_transpose"), ("quantize", "q_transpose")]


# ---------------------------------------------------------------------------
# The expert FFN of every recipe against the reference's XLA route.
# ---------------------------------------------------------------------------
def _ffn_inputs(seed=0, E=2, C=128, K=256, F=128):
    """tests/test_recipes.py's _setup: bf16 x, f32 weights."""
    r = np.random.default_rng(seed)
    x = jnp.asarray(r.normal(size=(E, C, K)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    w13 = jnp.asarray(r.normal(size=(E, K, 2 * F)).astype(np.float32) * 0.05)
    w2 = jnp.asarray(r.normal(size=(E, F, K)).astype(np.float32) * 0.05)
    return x, w13, w2


def _ref_ffn(name, inputs):
    recipe = jrecipes.get_recipe(name)

    def fwd(x, w13, w2):
        xi = jquantize_entry(recipe, x) if name == "fp8_flow" else x
        return jexpert_ffn(recipe, "swiglu", (), (), xi, w13, w2)

    with jcasts.ledger() as led:
        y, vjp = jax.vjp(fwd, *inputs)
        grads = vjp((2 * y.astype(jnp.float32)).astype(y.dtype))
    return ([np.asarray(y, np.float32)]
            + [np.asarray(g, np.float32) for g in grads]), led


def _port_ffn(name, inputs):
    recipe = recipes.get_recipe(name)
    x, w13, w2 = (_t(a).requires_grad_() for a in inputs)
    with casts.ledger() as led:
        xi = quantize_entry(recipe, x) if name == "fp8_flow" else x
        y = expert_ffn(recipe, "swiglu", xi, w13, w2)
        y.backward((2 * y.detach().to(torch.float32)).to(y.dtype))
    return [_np32(t) for t in (y, x.grad, w13.grad, w2.grad)], led


@functools.cache
def _ref_default(name):
    """_ref_ffn of recipe `name` on _ffn_inputs(), computed once a module:
    the parity and the XLA-operand cases share it."""
    return _ref_ffn(name, _ffn_inputs())


# max |port - reference| / max |reference| over (y, gx, wg13, wg2), per
# recipe, on _ffn_inputs(0).  Measured: bf16 0 (the port's bf16 products
# round once from f32 sums, as XLA's dot does: bit for bit), blockwise
# 0.0316, naive_fp8 0.0364, fp8_flow 0.111 (its gx; cosine 0.99943).
# An e4m3 code one step off moves a value by up to 1/8 of itself: the FP8
# recipes' differences are such steps, where the reference's bf16-rounded
# scales (or bf16 SwiGLU product) put a value on the other side of a
# rounding boundary (test_expert_ffn_with_xla_route_operands shows it).
FFN_MAX_REL = {"bf16": 1e-5, "blockwise": 0.05, "naive_fp8": 0.05,
               "fp8_flow": 0.15}


@pytest.mark.parametrize("name", NAMES)
def test_expert_ffn_matches_reference(name):
    inputs = _ffn_inputs()
    ref, jled = _ref_default(name)
    got, led = _port_ffn(name, inputs)
    for what, a, b in zip(("y", "gx", "wg13", "wg2"), got, ref):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert _cos(a, b) >= 0.999, (name, what, _cos(a, b))
        assert _max_rel(a, b) <= FFN_MAX_REL[name], (name, what,
                                                     _max_rel(a, b))
    # the cast ledger: the reference's events in the reference's order
    assert _events(led) == _events(jled)
    extra = 1 if name == "fp8_flow" else 0          # the entry quantize
    assert led.activation_casts() == EXPECTED_FFN[name] + extra


@pytest.mark.parametrize("name", ["blockwise", "naive_fp8"])
def test_expert_ffn_with_xla_route_operands(name, monkeypatch):
    """The port's baselines with their GEMMs on the reference XLA route's
    operands (each dequantized to bf16: payload x bf16-rounded scale, f32
    sums) are the reference to f32 summation order: all of the 0.03 of
    test_expert_ffn_matches_reference is the bf16 rounding of the linear
    scales."""
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
    inputs = _ffn_inputs()
    ref, _ = _ref_default(name)
    got, _ = _port_ffn(name, inputs)
    for what, a, b in zip(("y", "gx", "wg13", "wg2"), got, ref):
        assert _cos(a, b) >= 0.99999, (name, what, _cos(a, b))
        assert _max_rel(a, b) <= 2e-3, (name, what, _max_rel(a, b))


def _moe_inputs():
    """tests/test_cast_count.py's MoE block (E=4, D=256, F=128, top-2,
    T=256)."""
    E, D, F, T = 4, 256, 128, 256
    r = np.random.default_rng(1)
    x = jnp.asarray(r.normal(size=(T, D)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    wr = jnp.asarray(r.normal(size=(D, E)).astype(np.float32) * 0.02)
    w13 = jnp.asarray(r.normal(size=(E, D, 2 * F)).astype(np.float32) * 0.05)
    w2 = jnp.asarray(r.normal(size=(E, F, D)).astype(np.float32) * 0.05)
    return (x, wr, w13, w2), dict(n_experts=E, top_k=2, d_model=D, d_ff=F)


@pytest.mark.parametrize("name", NAMES)
def test_moe_block_matches_reference(name):
    """The MoE block at EP = 1 (the reference's local path: no mesh axis),
    forward and backward: output and every gradient cosine >= 0.999, and
    the cast ledger event for event, EXPECTED_MOE activation casts."""
    inputs, kw = _moe_inputs()
    jr = jrecipes.get_recipe(name)
    jcfg = JMoEConfig(ep_axis=None, dp_axes=(), **kw)

    def fwd(*a):
        return jmoe_block(jr, jcfg, *a)[0]

    with jcasts.ledger() as jled:
        y, vjp = jax.vjp(fwd, *inputs)
        jg = vjp((2 * y.astype(jnp.float32)).astype(y.dtype))
    ref = [np.asarray(y, np.float32)] + [np.asarray(g, np.float32)
                                         for g in jg]
    ts = [_t(a).requires_grad_() for a in inputs]
    with casts.ledger() as led:
        yt, _ = moe_block(recipes.get_recipe(name), MoEConfig(**kw), *ts)
        yt.backward((2 * yt.detach().to(torch.float32)).to(yt.dtype))
    got = [_np32(yt)] + [_np32(t.grad) for t in ts]
    for what, a, b in zip(("y", "gx", "gwr", "gw13", "gw2"), got, ref):
        assert np.isfinite(a).all() and np.abs(a).max() > 0, (name, what)
        assert _cos(a, b) >= 0.999, (name, what, _cos(a, b))
    assert _events(led) == _events(jled)
    assert led.activation_casts() == EXPECTED_MOE[name]


@functools.cache
def _port_grads(name, seed=0):
    """The port's (gx, wg13, wg2) of recipe `name` on _ffn_inputs(seed),
    computed once a module (seed 0 is shared by the two tests below)."""
    return _port_ffn(name, _ffn_inputs(seed))[0][1:]


def test_recipe_grads_track_bf16():
    """tests/test_recipes.py::test_recipe_grads_track_bf16 (swiglu) on the
    port: every FP8 recipe's gradients within cosine 0.97 of bf16's."""
    gb = _port_grads("bf16")
    for name in ["blockwise", "naive_fp8", "fp8_flow"]:
        g = _port_grads(name)
        cosines = [_cos(a, b) for a, b in zip(g, gb)]
        assert min(cosines) > 0.97, (name, cosines)


def test_flow_not_worse_than_naive():
    """tests/test_recipes.py::test_flow_not_worse_than_naive on the port:
    fp8_flow's gradients are as close to bf16's as naive_fp8's (within
    0.005 of cosine) in at least 4 of 5 seeds."""
    votes = 0
    for seed in range(5):
        gb = _port_grads("bf16", seed)
        cf = min(_cos(a, b) for a, b in zip(_port_grads("fp8_flow", seed),
                                            gb))
        cn = min(_cos(a, b) for a, b in zip(_port_grads("naive_fp8", seed),
                                            gb))
        votes += int(cf >= cn - 0.005)
    assert votes >= 4


# ---------------------------------------------------------------------------
# The Q/DQ around the naive dispatch.
# ---------------------------------------------------------------------------
def test_fp8_dispatch_naive_matches_reference():
    """Forward bitwise (quantize, permute, bf16 dequantize with the scale
    rounded to bf16, as the reference); backward the f32 segment sum of
    the bf16 gradient rows, bitwise too; two casts."""
    r = np.random.default_rng(4)
    T, D, R = 24, 256, 40
    x = jnp.asarray(r.normal(size=(T, D)).astype(np.float32) * 3
                    ).astype(jnp.bfloat16)
    row_map = r.integers(-1, T, R).astype(np.int32)
    g = jnp.asarray(r.normal(size=(R, D)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    jr = jrecipes.get_recipe("naive_fp8")
    with jcasts.ledger() as jled:
        yj, vjp = jax.vjp(lambda a: jfp8_dispatch_naive(
            jr, a, jnp.asarray(row_map), T, None), x)
        (gj,) = vjp(g)
    xt = _t(x).requires_grad_()
    with casts.ledger() as led:
        yt = fp8_dispatch_naive(recipes.get_recipe("naive_fp8"), xt,
                                torch.from_numpy(row_map))
        yt.backward(_t(g))
    assert yt.dtype == torch.bfloat16
    assert np.array_equal(yt.detach().view(torch.int16).numpy(),
                          np.asarray(yj).view(np.int16))
    assert np.array_equal(xt.grad.view(torch.int16).numpy(),
                          np.asarray(gj).view(np.int16))
    assert _events(led) == _events(jled) == [
        ("quantize", "q_entry"), ("dequantize", "dq_post_dispatch")]


def test_dequantize_exit_vjp_matches_reference():
    """dequantize_exit alone: the bf16 dequantize and its backward's
    explicit linear quantize (an FP8 cotangent), bit for bit."""
    r = np.random.default_rng(6)
    xj = jnp.asarray(r.normal(size=(16, 256)).astype(np.float32))
    qj = jquant.quantize_rowwise(xj, scale_mode="linear")
    gj_in = jnp.asarray(r.normal(size=(16, 256)).astype(np.float32)
                        ).astype(jnp.bfloat16)
    jr = jrecipes.get_recipe("naive_fp8")
    with jcasts.ledger() as jled:
        yj, vjp = jax.vjp(lambda q: jdequantize_exit(jr, q), qj)
        (qg,) = vjp(gj_in)
    q = quant.QTensor(_t(qj.data).requires_grad_(),
                      _t(qj.scale).requires_grad_(), qj.tile)
    with casts.ledger() as led:
        y = dequantize_exit(recipes.get_recipe("naive_fp8"), q)
        y.backward(_t(gj_in))
    assert np.array_equal(y.detach().view(torch.int16).numpy(),
                          np.asarray(yj).view(np.int16))
    assert _events(led) == _events(jled) == [
        ("dequantize", "dq_post_dispatch"), ("quantize", "q_bwd_dispatch")]
    # the cotangent is the gradient's linear quantize: payload and scales
    assert np.array_equal(_bits(q.data.grad), _u8(qg.data))
    assert np.array_equal(q.scale.grad.numpy(), np.asarray(qg.scale))


# ---------------------------------------------------------------------------
# The NN and NT GEMM twins on linear-scale operands, against the reference's
# Pallas kernels in interpret mode.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w_trans", [False, True])
def test_grouped_gemm_twin_on_linear_scales(w_trans):
    r = np.random.default_rng(8)
    E, C, K, N = 2, 128, 256, 384
    qxj = jquant.quantize_rowwise(jnp.asarray(
        r.normal(size=(E, C, K)).astype(np.float32)), scale_mode="linear")
    stored = (E, N, K) if w_trans else (E, K, N)
    qwj = jquant.quantize_blockwise(jnp.asarray(
        r.normal(size=stored).astype(np.float32) * 0.05), scale_mode="linear")
    wj, swj = qwj.data, qwj.scale
    if w_trans:
        wj, swj = jnp.swapaxes(wj, 1, 2), jnp.swapaxes(swj, 1, 2)
    oj = np.asarray(grouped_gemm_fp8_pallas(qxj.data, qxj.scale, wj, swj),
                    np.float32)
    ot = _np32(grouped_gemm_fp8_plain(_t(qxj.data), _t(qxj.scale),
                                      _t(qwj.data), _t(qwj.scale),
                                      w_trans=w_trans))
    np.testing.assert_allclose(ot, oj, rtol=2e-2, atol=2e-2)
    assert (np.frexp(np.asarray(qxj.scale))[0] != 0.5).any()  # not po2


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_grouped_gemm_nt_twin_on_linear_scales(out_dtype):
    r = np.random.default_rng(9)
    E, M, N, C = 2, 256, 128, 256
    qa = jquant.quantize_rowwise(jnp.asarray(
        r.normal(size=(E, M, C)).astype(np.float32)), scale_mode="linear")
    qb = jquant.quantize_rowwise(jnp.asarray(
        r.normal(size=(E, N, C)).astype(np.float32) * 0.05),
        scale_mode="linear")
    oj = np.asarray(grouped_gemm_nt_fp8_pallas(
        qa.data, qa.scale, qb.data, qb.scale,
        out_dtype=jnp.dtype(out_dtype)), np.float32)
    ot = _np32(grouped_gemm_nt_fp8_plain(_t(qa.data), _t(qa.scale),
                                         _t(qb.data), _t(qb.scale),
                                         getattr(torch, out_dtype)))
    np.testing.assert_allclose(ot, oj, rtol=2e-2, atol=2e-2)
