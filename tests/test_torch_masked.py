"""The port's masked expert layout and fused SwiGLU GEMM-1 epilogue
(``Recipe(masked_experts=True, swiglu_epilogue=True)``) against the JAX
reference on the CPU, and against the port's own padded path.

- Each twin of the four masked kernels (#5 masked GEMM, #6 masked
  quant-out GEMM, #7 masked GEMM-1 with the SwiGLU + quantize epilogue,
  #11 masked NT GEMM) against the reference's masked Pallas kernel in
  interpret mode, under the routing skews of tests/test_kernels.py
  (zero_expert, all_to_one, random) on the dispatch layout, with the
  tolerances of the padded twins' tests (GEMMs rtol=atol=2e-2; quant-out
  equal scales and codes within one on <= 0.1% of lanes; #7 equal scales
  and equal codes except on lanes where the f32 sigmoid bits of torch and
  jax differ, and there within one), and with nonzero payload beyond
  masked_m against the reference's tile-granular oracles
  (``repro.kernels.ref.masked_*_ref``).
- Inside the port, bitwise: masked == padded on the dispatch layout for
  every kernel, the fused #7 == #3 then #8, expert_ffn (forward and
  gradients), moe_block, moe_block_decode, two reduced() train steps and
  served logits and tokens.
- expert_ffn against the reference's masked Pallas route (cosine >=
  0.999) with the same cast ledger, and served teacher-forced logits
  against the reference's route B with the masked recipe (cosine >= 0.999
  and equal argmax, token seed 2, as tests/test_torch_serve.py).
"""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import contextlib
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import casts as jcasts
from repro.core.fp8 import TILE
from repro.core.linear import expert_ffn as jexpert_ffn
from repro.core.linear import quantize_entry as jquantize_entry
from repro.core.quant import quantize
from repro.core.recipes import get_recipe as jget_recipe
from repro.kernels import ref
from repro.kernels.grouped_gemm_fp8 import (
    grouped_gemm_fp8_pallas, masked_grouped_gemm_fp8_pallas,
    masked_grouped_gemm_swiglu_quant_pallas)
from repro.kernels.grouped_gemm_nt_fp8 import masked_grouped_gemm_nt_fp8_pallas
from repro_torch import kernels
from repro_torch.configs import get_arch
from repro_torch.core import casts
from repro_torch.core.linear import expert_ffn, quantize_entry
from repro_torch.core.moe import MoEConfig, moe_block, moe_block_decode
from repro_torch.core.quant import QTensor
from repro_torch.core.recipes import get_recipe
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.kernels import ops
from repro_torch.kernels.fused_swiglu_quant import fused_swiglu_quant_plain
from repro_torch.kernels.grouped_gemm_fp8 import (
    grouped_gemm_fp8_plain, masked_grouped_gemm_fp8_plain)
from repro_torch.kernels.grouped_gemm_nt_fp8 import (
    grouped_gemm_nt_fp8_plain, masked_grouped_gemm_nt_fp8_plain)
from repro_torch.kernels.grouped_gemm_swiglu_quant import \
    masked_grouped_gemm_swiglu_quant_plain
from repro_torch.models.lm import init_params
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import Request
from repro_torch.serve.w8 import quantize_params_for_serving
from repro_torch.train.train_step import init_train_state, make_train_step
from tests.test_torch_kernels import _ordinal, _t, _u8, _x

SKEWS = ["zero_expert", "all_to_one", "random"]
PADDED = get_recipe("fp8_flow")
MASKED = get_recipe("fp8_flow", masked_experts=True, swiglu_epilogue=True)
MASKED_UNFUSED = get_recipe("fp8_flow", masked_experts=True)


def _skew(kind, E, C, seed=0):
    """Per-expert live-row counts of tests/test_kernels.py's skews."""
    r = np.random.default_rng(seed)
    mm = {"zero_expert": [0] + [C] * (E - 1),
          "all_to_one": [C] + [0] * (E - 1),
          "random": list(r.integers(0, C + 1, E))}[kind]
    return np.asarray(mm, np.int32)


def _dispatch_q(x, mm, tile):
    """Quantize x (E, C, K) with the rows beyond each expert's count zeroed
    first: payload 0 and scale 1.0 there, the dispatch layout.  Returns
    the reference's and the port's QTensor (same bits)."""
    live = np.arange(x.shape[1])[None, :] < mm[:, None]
    q = quantize(jnp.asarray(np.where(live[..., None], x, 0.0)), tile, tag="t")
    return q, QTensor(_t(q.data), _t(q.scale), tuple(q.tile))


def _q(x, tile):
    q = quantize(jnp.asarray(x), tile, tag="t")
    return q, QTensor(_t(q.data), _t(q.scale), tuple(q.tile))


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _assert_codes_close(d, dj, max_frac):
    diff = np.abs(_ordinal(d.view(torch.uint8).numpy()) - _ordinal(_u8(dj)))
    assert diff.max() <= 1 and (diff > 0).mean() <= max_frac


# ---------------------------------------------------------------------------
# Twins against the reference's masked Pallas kernels (interpret mode).
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("w_trans", [False, True])
def test_masked_gemm_twin_matches_pallas(skew, w_trans):
    """#5 and #6 (as stored and read transposed) against
    masked_grouped_gemm_fp8_pallas in both forms."""
    E, C, K, N = 3, 256, 256, 128
    mm = _skew(skew, E, C)
    qxj, qx = _dispatch_q(_x(21, E, C, K, spread=0.5), mm, (1, 1, TILE))
    stored = (E, N, K) if w_trans else (E, K, N)
    qwj, qw = _q(_x(22, *stored, spread=0.3) * 0.05, (1, TILE, TILE))
    wj, swj = qwj.data, qwj.scale
    if w_trans:
        wj, swj = jnp.swapaxes(wj, 1, 2), jnp.swapaxes(swj, 1, 2)
    mmj, mmt = jnp.asarray(mm), torch.from_numpy(mm)
    oj = masked_grouped_gemm_fp8_pallas(qxj.data, qxj.scale, wj, swj, mmj)
    o = masked_grouped_gemm_fp8_plain(qx.data, qx.scale, qw.data, qw.scale,
                                      mmt, w_trans=w_trans)
    np.testing.assert_allclose(o.to(torch.float32).numpy(),
                               np.asarray(oj, np.float32), rtol=2e-2,
                               atol=2e-2)
    dj, sj = masked_grouped_gemm_fp8_pallas(qxj.data, qxj.scale, wj, swj, mmj,
                                            quant_out=True)
    d, s = masked_grouped_gemm_fp8_plain(qx.data, qx.scale, qw.data,
                                         qw.scale, mmt, w_trans=w_trans,
                                         quant_out=True)
    assert np.array_equal(s.numpy(), np.asarray(sj))
    _assert_codes_close(d, dj, 1e-3)


def _sigmoid_lanes(h_gate):
    """Lanes whose f32 sigmoid bits differ between torch and jax."""
    g = np.asarray(jnp.asarray(h_gate).astype(jnp.float32))
    sig_j = np.asarray(jax.nn.sigmoid(jnp.asarray(g))).view(np.uint32)
    sig_t = torch.sigmoid(torch.from_numpy(g.copy())).numpy().view(np.uint32)
    return sig_j != sig_t


def _check_swiglu_vs_reference(d, s, dj, sj, hj, F):
    """Equal scales; payload equal except where the sigmoid bits differ,
    and there within one code."""
    assert np.array_equal(s.numpy(), np.asarray(sj))
    differ = _sigmoid_lanes(hj[..., :F])
    assert differ.mean() < 0.01
    bt, bj = d.view(torch.uint8).numpy(), _u8(dj)
    assert np.array_equal(bt[~differ], bj[~differ])
    assert np.abs(_ordinal(bt) - _ordinal(bj))[differ].max(initial=0) <= 1


@pytest.mark.parametrize("skew", SKEWS)
def test_masked_swiglu_quant_twin_matches_pallas(skew):
    """#7 against masked_grouped_gemm_swiglu_quant_pallas."""
    E, C, K, F = 2, 256, 256, 128
    mm = _skew(skew, E, C, seed=2)
    qxj, qx = _dispatch_q(_x(25, E, C, K, spread=0.5), mm, (1, 1, TILE))
    qwj, qw = _q(_x(26, E, K, 2 * F, spread=0.3) * 0.05, (1, TILE, TILE))
    dj, sj = masked_grouped_gemm_swiglu_quant_pallas(
        qxj.data, qxj.scale, qwj.data, qwj.scale, jnp.asarray(mm))
    d, s = masked_grouped_gemm_swiglu_quant_plain(
        qx.data, qx.scale, qw.data, qw.scale, torch.from_numpy(mm))
    hj = grouped_gemm_fp8_pallas(qxj.data, qxj.scale, qwj.data, qwj.scale)
    _check_swiglu_vs_reference(d, s, dj, sj, hj, F)


@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_masked_nt_twin_matches_pallas(skew, out_dtype):
    """#11 against masked_grouped_gemm_nt_fp8_pallas, dead token columns
    zero."""
    E, M, N, C = 2, 128, 256, 256
    mm = _skew(skew, E, C, seed=1)
    live = np.arange(C)[None, None, :] < mm[:, None, None]
    qaj, qa = _q(np.where(live, _x(23, E, M, C, spread=0.5), 0.0),
                 (1, 1, TILE))
    qbj, qb = _q(np.where(live, _x(24, E, N, C, spread=0.5) * 0.1, 0.0),
                 (1, 1, TILE))
    oj = masked_grouped_gemm_nt_fp8_pallas(qaj.data, qaj.scale, qbj.data,
                                           qbj.scale, jnp.asarray(mm),
                                           out_dtype=jnp.dtype(out_dtype))
    o = masked_grouped_gemm_nt_fp8_plain(qa.data, qa.scale, qb.data, qb.scale,
                                         torch.from_numpy(mm),
                                         getattr(torch, out_dtype))
    np.testing.assert_allclose(o.to(torch.float32).numpy(),
                               np.asarray(oj, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_masked_twins_tile_granular_oracles():
    """Nonzero payload beyond masked_m (counts mid-tile): dead 128-row
    groups come out as zeros (scale 1.0), partly live groups are computed
    whole, dead contraction steps are dropped -- the reference's
    ref.masked_*_ref oracles."""
    E, C, K, N = 2, 256, 256, 128
    mm = np.asarray([37, 200], np.int32)
    mmj, mmt = jnp.asarray(mm), torch.from_numpy(mm)
    qxj, qx = _q(_x(31, E, C, K, spread=0.5), (1, 1, TILE))
    qwj, qw = _q(_x(32, E, K, N, spread=0.3) * 0.05, (1, TILE, TILE))
    args_j = (qxj.data, qxj.scale, qwj.data, qwj.scale, mmj)
    args = (qx.data, qx.scale, qw.data, qw.scale, mmt)
    o = masked_grouped_gemm_fp8_plain(*args).to(torch.float32).numpy()
    oj = np.asarray(ref.masked_grouped_gemm_fp8_ref(*args_j), np.float32)
    np.testing.assert_allclose(o, oj, rtol=2e-2, atol=2e-2)
    assert not o[0, 128:].any() and o[0, 37:128].any()
    d, s = masked_grouped_gemm_fp8_plain(*args, quant_out=True)
    dj, sj = ref.masked_grouped_gemm_fp8_quant_out_ref(*args_j)
    assert np.array_equal(s.numpy(), np.asarray(sj))
    _assert_codes_close(d, dj, 1e-3)

    qw13j, qw13 = _q(_x(33, E, K, 2 * N, spread=0.3) * 0.05, (1, TILE, TILE))
    d, s = masked_grouped_gemm_swiglu_quant_plain(qx.data, qx.scale,
                                                  qw13.data, qw13.scale, mmt)
    dj, sj = ref.masked_grouped_gemm_swiglu_quant_ref(
        qxj.data, qxj.scale, qw13j.data, qw13j.scale, mmj)
    hj = grouped_gemm_fp8_pallas(qxj.data, qxj.scale, qw13j.data,
                                 qw13j.scale)
    _check_swiglu_vs_reference(d, s, dj, sj, hj, N)

    qaj, qa = _q(_x(34, E, 128, C, spread=0.5), (1, 1, TILE))
    qbj, qb = _q(_x(35, E, 128, C, spread=0.5) * 0.1, (1, 1, TILE))
    nt = masked_grouped_gemm_nt_fp8_plain(qa.data, qa.scale, qb.data,
                                          qb.scale, mmt)
    ntj = ref.masked_grouped_gemm_nt_fp8_ref(qaj.data, qaj.scale, qbj.data,
                                             qbj.scale, mmj)
    np.testing.assert_allclose(nt.numpy(), np.asarray(ntj), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# Inside the port: masked == padded, fused == unfused, bit for bit.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("w_trans", [False, True])
def test_masked_equals_padded_twins_bitwise(skew, w_trans):
    """On the dispatch layout #5 == #3, #6 == #4 and #11 == #10, bit for
    bit, under every skew (decode's ragged C = 8 included for #5)."""
    for E, C, K, N in ((3, 256, 256, 128), (4, 8, 256, 128)):
        mm = _skew(skew, E, C)
        _, qx = _dispatch_q(_x(41, E, C, K, spread=0.5), mm, (1, 1, TILE))
        stored = (E, N, K) if w_trans else (E, K, N)
        _, qw = _q(_x(42, *stored, spread=0.3) * 0.05, (1, TILE, TILE))
        args = (qx.data, qx.scale, qw.data, qw.scale)
        for quant_out in (False, True):
            kw = dict(w_trans=w_trans, quant_out=quant_out)
            pad = grouped_gemm_fp8_plain(*args, **kw)
            msk = masked_grouped_gemm_fp8_plain(*args, torch.from_numpy(mm),
                                                **kw)
            for a, b in zip(pad if quant_out else (pad,),
                            msk if quant_out else (msk,)):
                assert torch.equal(_bits(a), _bits(b))
    E, M, N, C = 2, 128, 256, 256
    mm = _skew(skew, E, C, seed=1)
    live = np.arange(C)[None, None, :] < mm[:, None, None]
    _, qa = _q(np.where(live, _x(43, E, M, C, spread=0.5), 0.0), (1, 1, TILE))
    _, qb = _q(np.where(live, _x(44, E, N, C), 0.0), (1, 1, TILE))
    for dt in (torch.float32, torch.bfloat16):
        pad = grouped_gemm_nt_fp8_plain(qa.data, qa.scale, qb.data, qb.scale,
                                        dt)
        msk = masked_grouped_gemm_nt_fp8_plain(qa.data, qa.scale, qb.data,
                                               qb.scale, torch.from_numpy(mm),
                                               dt)
        assert torch.equal(_bits(pad), _bits(msk))


@pytest.mark.parametrize("skew", SKEWS)
def test_fused_swiglu_epilogue_equals_unfused_pair_bitwise(skew):
    """#7 == #3 (bf16 h) then #8, on the dispatch layout, through ops."""
    for E, C, K, F in ((2, 256, 256, 128), (4, 8, 256, 256)):
        mm = torch.from_numpy(_skew(skew, E, C, seed=2))
        _, qx = _dispatch_q(_x(45, E, C, K, spread=0.5), mm.numpy(),
                            (1, 1, TILE))
        _, qw13 = _q(_x(46, E, K, 2 * F, spread=0.3) * 0.05, (1, TILE, TILE))
        fused = ops.grouped_gemm_swiglu_quant_masked(qx, qw13, mm)
        h = ops.grouped_gemm_fp8(qx, qw13)
        d, s = fused_swiglu_quant_plain(h.reshape(E * C, 2 * F))
        assert fused.tile == (1, 1, TILE)
        assert torch.equal(_bits(fused.data), _bits(d.reshape(E, C, F)))
        assert torch.equal(fused.scale, s.reshape(E, C, F // TILE))


def test_masked_wrappers_launch_no_kernel_on_cpu():
    """On CPU tensors the four masked wrappers take their twins."""
    before = dict(kernels.LAUNCHES)
    mm = torch.tensor([3, 0], dtype=torch.int32)
    _, qx = _q(_x(47, 2, 8, 256), (1, 1, TILE))
    _, qw = _q(_x(48, 2, 256, 256) * 0.05, (1, TILE, TILE))
    _, qa = _q(_x(49, 2, 128, 128), (1, 1, TILE))
    ops.grouped_gemm_fp8_masked(qx, qw, mm)
    ops.grouped_gemm_fp8_masked_quant_out(qx, qw, mm)
    ops.grouped_gemm_swiglu_quant_masked(qx, qw, mm)
    ops.grouped_gemm_nt_fp8_masked(qa, qa, mm)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("expected_m", [None, 7, 8, 200])
def test_expected_m_hint_takes_the_padded_twin(monkeypatch, expected_m):
    """The reference's expected_m hint (repro/kernels/ops.py:151-218): at
    expected_m >= C the three masked wrappers call the padded twin (a spy
    counts it) and give the masked result bit for bit; the fused SwiGLU
    GEMM-1 takes the hint and never falls back."""
    calls = Counter()

    def spy(name):
        fn = getattr(ops, name)

        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)

    for name in ("grouped_gemm_fp8_plain", "masked_grouped_gemm_fp8_plain",
                 "grouped_gemm_nt_fp8_plain",
                 "masked_grouped_gemm_nt_fp8_plain",
                 "masked_grouped_gemm_swiglu_quant_plain"):
        spy(name)
    C = 8
    mm = torch.tensor([8, 3], dtype=torch.int32)
    x = _x(47, 2, C, 256)
    x[1, 3:] = 0                          # the dispatch layout of mm
    _, qx = _q(x, (1, 1, TILE))
    _, qw = _q(_x(48, 2, 256, 256) * 0.05, (1, TILE, TILE))
    a = _x(49, 2, 128, 128)
    a[1, :, 3:] = 0
    _, qa = _q(a, (1, 1, TILE))
    kw = {} if expected_m is None else dict(expected_m=expected_m)
    outs = {
        "nn": ops.grouped_gemm_fp8_masked(qx, qw, mm, **kw),
        "quant_out": ops.grouped_gemm_fp8_masked_quant_out(qx, qw, mm, **kw),
        "nt": ops.grouped_gemm_nt_fp8_masked(qa, qa, mm, **kw),
        "swiglu": ops.grouped_gemm_swiglu_quant_masked(qx, qw, mm, **kw)}
    padded = expected_m is not None and expected_m >= C
    nt_padded = expected_m is not None and expected_m >= 128
    assert calls["grouped_gemm_fp8_plain"] == (2 if padded else 0)
    assert calls["masked_grouped_gemm_fp8_plain"] == (0 if padded else 2)
    assert calls["grouped_gemm_nt_fp8_plain"] == (1 if nt_padded else 0)
    assert calls["masked_grouped_gemm_nt_fp8_plain"] == \
        (0 if nt_padded else 1)
    assert calls["masked_grouped_gemm_swiglu_quant_plain"] == 1
    ref = {"nn": ops.grouped_gemm_fp8_masked(qx, qw, mm),
           "quant_out": ops.grouped_gemm_fp8_masked_quant_out(qx, qw, mm),
           "nt": ops.grouped_gemm_nt_fp8_masked(qa, qa, mm)}
    assert torch.equal(outs["nn"], ref["nn"])
    assert torch.equal(_bits(outs["quant_out"].data),
                       _bits(ref["quant_out"].data))
    assert torch.equal(outs["quant_out"].scale, ref["quant_out"].scale)
    assert torch.equal(outs["nt"], ref["nt"])


# ---------------------------------------------------------------------------
# expert_ffn: the masked route against the reference's and the padded one.
# ---------------------------------------------------------------------------
def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _ffn_inputs(mm):
    """tests/test_cast_count.py's FFN setup with the rows beyond each
    expert's count zeroed (the dispatch layout) and a live-row mask."""
    r = np.random.default_rng(0)
    E, C, K, F = 2, 128, 256, 128
    live = (np.arange(C)[None, :] < mm[:, None]).astype(np.float32)[..., None]
    x = jnp.asarray(r.normal(size=(E, C, K)).astype(np.float32) * live
                    ).astype(jnp.bfloat16)
    w13 = jnp.asarray(r.normal(size=(E, K, 2 * F)).astype(np.float32) * 0.05)
    w2 = jnp.asarray(r.normal(size=(E, F, K)).astype(np.float32) * 0.05)
    return (x, w13, w2), live


def _reference_ffn(mm):
    """The reference's masked Pallas route (interpret mode, no mesh);
    cotangents on dead slots are zero, as the MoE block's prob weighting
    makes them."""
    recipe = jget_recipe("fp8_flow", use_pallas=True, masked_experts=True,
                         swiglu_epilogue=True)
    (x, w13, w2), live = _ffn_inputs(mm)

    def L(x, w13, w2):
        y = jexpert_ffn(recipe, "swiglu", (), (), jquantize_entry(recipe, x),
                        w13, w2, jnp.asarray(mm))
        return jnp.sum((y.astype(jnp.float32) * live) ** 2), y

    with jcasts.ledger() as led:
        (_, y), grads = jax.value_and_grad(L, argnums=(0, 1, 2),
                                           has_aux=True)(x, w13, w2)
    return [np.asarray(a, np.float32) for a in (y, *grads)], led


def _port_ffn(recipe, mm):
    (x, w13, w2), live = _ffn_inputs(mm)
    x, w13, w2 = (_t(a).requires_grad_() for a in (x, w13, w2))
    masked_m = torch.from_numpy(mm) if recipe.masked_experts else None
    with casts.ledger() as led:
        y = expert_ffn(recipe, "swiglu", quantize_entry(recipe, x), w13, w2,
                       masked_m)
        ((y.to(torch.float32) * torch.from_numpy(live)) ** 2).sum().backward()
    outs = [y.detach()] + [t.grad for t in (x, w13, w2)]
    return outs, led


MASKS = {"partial": [48, 128], "dead_expert": [0, 128]}


@pytest.mark.parametrize("mask", list(MASKS))
def test_masked_expert_ffn_matches_reference_masked_route(mask):
    """y and the gradients of x, w13, w2 against the reference's
    use_pallas=True, masked_experts=True, swiglu_epilogue=True route
    (cosine >= 0.999), and the same cast-ledger multiset."""
    mm = np.asarray(MASKS[mask], np.int32)
    ref_outs, jled = _reference_ffn(mm)
    outs, led = _port_ffn(MASKED, mm)
    for name, a, b in zip(("y", "gx", "wg13", "wg2"), outs, ref_outs):
        a = a.to(torch.float32).numpy()
        assert a.shape == b.shape and np.isfinite(a).all()
        assert _cos(a, b) >= 0.999, (name, _cos(a, b))
    assert Counter(led.by_tag()) == Counter(jled.by_tag()), led.summary()


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("recipe", [MASKED, MASKED_UNFUSED],
                         ids=["fused_epilogue", "unfused"])
def test_masked_expert_ffn_equals_padded_bitwise(mask, recipe):
    """The masked route (fused epilogue or not) gives the padded route's
    y and gradients bit for bit."""
    mm = np.asarray(MASKS[mask], np.int32)
    pad, _ = _port_ffn(PADDED, mm)
    msk, _ = _port_ffn(recipe, mm)
    for a, b in zip(pad, msk):
        assert torch.equal(a, b)


def test_masked_fused_epilogue_keeps_two_casts():
    """tests/test_cast_count.py's invariant in the port: the masked route
    with the fused epilogue records 2 activation casts, the same tag set
    as the padded route, swiglu_quant as a fused kind, no dequantize."""
    mm = np.asarray(MASKS["partial"], np.int32)
    _, base = _port_ffn(PADDED, mm)
    _, fused = _port_ffn(MASKED, mm)

    def tags(led):
        return {(e.kind, e.tag) for e in led.events
                if not e.tag.startswith("q_w")}

    assert fused.activation_casts() == base.activation_casts() == 2
    assert tags(fused) == tags(base)
    assert ("fused_quantize", "swiglu_quant") in tags(fused)
    assert not [e for e in fused.events if e.kind == "dequantize"]
    assert Counter(fused.by_tag()) == Counter(base.by_tag())


# ---------------------------------------------------------------------------
# The MoE blocks and the train step: masked == padded, bit for bit.
# ---------------------------------------------------------------------------
def _moe_inputs(T, seed=1):
    E, D, F, topk = 4, 256, 128, 2
    cfg = MoEConfig(n_experts=E, top_k=topk, d_model=D, d_ff=F)
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.normal(size=(T, D)).astype(np.float32)).to(
        torch.bfloat16)
    wr = torch.from_numpy(r.normal(size=(D, E)).astype(np.float32) * 0.1)
    w13 = torch.from_numpy(r.normal(size=(E, D, 2 * F)).astype(np.float32)
                           * 0.05).to(torch.bfloat16)
    w2 = torch.from_numpy(r.normal(size=(E, F, D)).astype(np.float32)
                          * 0.05).to(torch.bfloat16)
    return cfg, (x, wr, w13, w2)


@pytest.mark.parametrize("recipe", [MASKED, MASKED_UNFUSED],
                         ids=["fused_epilogue", "unfused"])
def test_masked_moe_block_equals_padded_bitwise(recipe):
    """tests/test_torch_train.py's MoE block (E=4, top-2, T=256; experts
    get fewer rows than their 256-row capacity): output, aux loss and
    every gradient bit for bit, 2 activation casts."""
    cfg, inputs = _moe_inputs(256)
    got = {}
    for name, rc in (("padded", PADDED), ("masked", recipe)):
        leaves = [t.clone().requires_grad_() for t in inputs]
        with casts.ledger() as led:
            y, m = moe_block(rc, cfg, *leaves)
            ((y.to(torch.float32) ** 2).sum() + m["aux_loss"]).backward()
        assert led.activation_casts() == 2
        got[name] = [y.detach(), m["aux_loss"].detach()] + \
            [t.grad for t in leaves]
    for a, b in zip(got["padded"], got["masked"]):
        assert torch.equal(a, b)


def test_masked_moe_block_decode_equals_padded_bitwise():
    """An 8-token decode batch (C_dec = 8: one 128-row group an expert,
    live iff the expert has a row), W8 expert weights."""
    from repro_torch.core.quant import quantize_blockwise
    cfg, (x, wr, w13, w2) = _moe_inputs(8, seed=3)
    qw13, qw2 = quantize_blockwise(w13), quantize_blockwise(w2)
    with torch.inference_mode():
        yp, _ = moe_block_decode(PADDED, cfg, x, wr, qw13, qw2)
        ym, _ = moe_block_decode(MASKED, cfg, x, wr, qw13, qw2)
    assert torch.equal(yp, ym) and yp.abs().sum() > 0


def test_masked_train_steps_equal_padded_bitwise():
    """Two reduced() train steps from the same params and batch: the
    losses, grad norms and updated params of the masked recipe are the
    padded recipe's, bit for bit."""
    cfg = get_arch("qwen3_moe_235b").reduced()
    opt = AdamWConfig(lr=1e-3)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8), 0, device="cpu")
    out = {}
    for name, recipe in (("padded", PADDED), ("masked", MASKED)):
        state = init_train_state(cfg, opt, device="cpu", params=init_params(
            cfg, seed=0, device="cpu"))
        step = make_train_step(cfg, recipe, opt, total_steps=10,
                               warmup_steps=1)
        metrics = []
        for _ in range(2):
            with casts.ledger() as led:
                state, m = step(state, batch)
            assert led.activation_casts() == 2 * cfg.n_layers
            metrics.append((m["loss"], m["grad_norm"]))
        out[name] = (metrics, tree_leaves(state["params"]))
    (mp, pp), (mm, pm) = out["padded"], out["masked"]
    for (lp, gp), (lm, gm) in zip(mp, mm):
        assert torch.equal(lp, lm) and torch.equal(gp, gm)
    assert all(torch.equal(a, b) for a, b in zip(pp, pm))


# ---------------------------------------------------------------------------
# Serving with the masked recipe.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def serve_setup():
    from repro.configs import get_arch as jget_arch
    from repro.models.lm import NO_PLAN
    from repro.models.lm import init_params as jinit_params
    from repro_torch.weights import params_from_numpy
    from tests.test_torch_serve import (_np_tree, _port_teacher_forced,
                                        _ref_teacher_forced)
    jcfg = jget_arch("qwen3_moe_235b").reduced()
    cfg = get_arch("qwen3_moe_235b").reduced()
    jparams = jinit_params(jcfg, jax.random.key(0))
    params = params_from_numpy(_np_tree(jparams), device="cpu")
    w8 = quantize_params_for_serving(params)
    toks = [int(t) for t in np.random.default_rng(2).integers(
        1, cfg.vocab, 12)]
    route_b = _ref_teacher_forced(
        jcfg, jget_recipe("fp8_flow", use_pallas=True, masked_experts=True,
                          swiglu_epilogue=True),
        NO_PLAN, jparams, contextlib.nullcontext(), toks)
    return dict(cfg=cfg, params=params, route_b=route_b,
                masked=_port_teacher_forced(cfg, w8, toks, MASKED),
                padded=_port_teacher_forced(cfg, w8, toks, PADDED))


def test_masked_serve_logits_match_reference_route_b(serve_setup):
    """Teacher-forced prefill + 3 decode steps, token seed 2 (no router
    near-tie), against the reference's route B with the masked recipe:
    cosine >= 0.999 and the same argmax at every step; the prefill ledger
    is the reference's but for route B's per-call weight quantizes (the
    port serves W8-resident weights; the reference's scanned stack records
    one layer at trace time)."""
    ref, jled = serve_setup["route_b"]
    port, led, _ = serve_setup["masked"]
    for step, (a, b) in enumerate(zip(port, ref)):
        assert _cos(a, b) >= 0.999, (step, _cos(a, b))
        assert int(a.argmax()) == int(b.argmax()), step
    L = serve_setup["cfg"].n_layers
    assert led == {k: v * L for k, v in jled.items()
                   if not k[1].startswith("q_w")}


def test_masked_serve_logits_equal_padded_bitwise(serve_setup):
    port_m, led_m, _ = serve_setup["masked"]
    port_p, led_p, _ = serve_setup["padded"]
    for a, b in zip(port_m, port_p):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    assert led_m == led_p


def test_masked_engine_generates_the_padded_tokens(serve_setup):
    """The engine with the masked recipe generates exactly the padded
    engine's tokens on a trace with evictions."""
    cfg = serve_setup["cfg"]
    ecfg = ServeConfig(max_batch=3, page_size=4, n_pages=7,
                       max_pages_per_req=5, token_budget=64,
                       prefill_buckets=(16,), fp8_kv=True, w8_weights=True)
    r = np.random.default_rng(4)
    prompts = [[int(t) for t in r.integers(1, cfg.vocab, int(r.integers(4, 9)))]
               for _ in range(6)]
    tokens = {}
    for name, recipe in (("padded", PADDED), ("masked", MASKED)):
        eng = ServeEngine(cfg, recipe, serve_setup["params"], ecfg,
                          device="cpu")
        reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
        res = eng.run(reqs, realtime=False)
        assert eng.sched.n_evictions >= 1
        tokens[name] = [res[q.rid]["tokens"] for q in reqs]
    assert tokens["masked"] == tokens["padded"]
