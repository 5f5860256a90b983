"""The port's flash-attention VJP (``models/layers.flash_attention``, an
autograd Function with the reference's hand-written backward) against
``jax.vjp`` of the reference's ``_flash`` custom VJP, on the same numpy
inputs, and against autograd through the same forward
(``flash_attention_plain``, its twin).

Cases: causal, a window, a softcap, GQA (G > 1) and MHA (G = 1),
non-causal (the encoder) and Sq != Skv (cross-attention).  Inputs are
f32, so both sides run the same f32 arithmetic in another order: the bar
is max |port - reference| / max |reference| <= 1e-5 for the output and
each of dq, dk, dv (f32 sums over the KV blocks and heads: at most 5.3e-7
measured here; on the card at llava_next_34b's full-width attention,
whose dk and dv sum 3072 x 7 products a lane, 7.4e-6 against the plain
twin, chip_smoke.py phase 28).  Against the plain twin the bar is the
same.  A
``saved_tensors_hooks`` count shows that the Function keeps q, k, v, the
positions, the f32 output and the log-sum-exp, nothing of size Sq x Skv,
where autograd through the plain loop keeps every block's scores."""
import torch_threads  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_attention as jflash_attention
from repro_torch.models.layers import flash_attention, flash_attention_plain

REL = 1e-5
# (name, B, Sq, Skv, H, KV, hd, causal, window, softcap, block_k)
CASES = [
    ("causal_gqa", 2, 64, 64, 4, 2, 16, True, 0, 0.0, 16),
    ("causal_mha", 1, 64, 64, 2, 2, 16, True, 0, 0.0, 32),
    ("window", 1, 64, 64, 4, 1, 16, True, 24, 0.0, 16),
    ("softcap", 2, 32, 32, 4, 2, 16, True, 0, 5.0, 16),
    ("window_softcap", 1, 64, 64, 4, 2, 8, True, 20, 3.0, 16),
    ("noncausal", 2, 32, 32, 4, 2, 16, False, 0, 0.0, 16),
    ("cross", 2, 24, 64, 4, 2, 16, False, 0, 0.0, 16),
]


def _inputs(B, Sq, Skv, H, KV, hd, seed=0):
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = r.normal(size=(B, Skv, KV, hd)).astype(np.float32)
    v = r.normal(size=(B, Skv, KV, hd)).astype(np.float32)
    g = r.normal(size=(B, Sq, H, hd)).astype(np.float32)
    return q, k, v, g


def _positions(Sq, Skv):
    """Self-attention: both at arange(S); cross-attention: the queries at
    their own positions, the encoder rows at arange(Skv)."""
    return np.arange(Sq, dtype=np.int32), np.arange(Skv, dtype=np.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _port(fn, q, k, v, g, qp, kp, causal, window, softcap, bk):
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*t, q_pos=torch.from_numpy(qp).long(),
             kv_pos=torch.from_numpy(kp).long(), causal=causal,
             window=window, softcap=softcap, block_k=bk)
    out.backward(torch.from_numpy(g))
    return [out.detach().numpy()] + [a.grad.numpy() for a in t]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_vjp_matches_reference(case):
    _, B, Sq, Skv, H, KV, hd, causal, window, softcap, bk = case
    q, k, v, g = _inputs(B, Sq, Skv, H, KV, hd)
    qp, kp = _positions(Sq, Skv)

    def f(q_, k_, v_):
        return jflash_attention(q_, k_, v_, q_pos=jnp.asarray(qp),
                                kv_pos=jnp.asarray(kp), causal=causal,
                                window=window, softcap=softcap, block_k=bk)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [out] + list(vjp(jnp.asarray(g)))
    got = _port(flash_attention, q, k, v, g, qp, kp, causal, window, softcap,
                bk)
    twin = _port(flash_attention_plain, q, k, v, g, qp, kp, causal, window,
                 softcap, bk)
    for name, a, b, c in zip(("out", "dq", "dk", "dv"), got, ref, twin):
        assert np.isfinite(a).all(), name
        assert _rel(a, b) <= REL, (name, _rel(a, b))
        assert _rel(a, c) <= REL, (name, "twin", _rel(a, c))
    # the forward is the twin's, to the bit
    np.testing.assert_array_equal(got[0], twin[0])


def _saved_numels(fn, B, Sq, Skv, H, KV, hd, bk):
    q, k, v, _ = _inputs(B, Sq, Skv, H, KV, hd)
    numels = []

    def pack(t):
        numels.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _port(fn, q, k, v, np.ones_like(q), *_positions(Sq, Skv), True, 0,
              0.0, bk)
    return numels


def test_flash_vjp_saves_nothing_of_score_size():
    B, Sq, Skv, H, KV, hd, bk = 1, 128, 128, 4, 2, 8, 32
    got = _saved_numels(flash_attention, B, Sq, Skv, H, KV, hd, bk)
    # q, k, v, q_pos, kv_pos, the f32 output, the log-sum-exp
    want = [B * Sq * H * hd, B * Skv * KV * hd, B * Skv * KV * hd, Sq, Skv,
            B * Sq * H * hd, B * Sq * H]
    assert sorted(got) == sorted(want), got
    assert max(got) < Sq * Skv
    # autograd through the plain loop keeps every block's scores: at least
    # B * H * Sq * Skv elements
    plain = _saved_numels(flash_attention_plain, B, Sq, Skv, H, KV, hd, bk)
    assert sum(plain) >= B * H * Sq * Skv > 4 * sum(got), (sum(plain),
                                                           sum(got))
