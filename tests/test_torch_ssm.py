"""The port's Mamba2 mixer and the SSM / hybrid configs against the JAX
reference on the CPU.

``ssd_chunked`` against the reference's and against the sequential
recurrence (tests/test_arch_smoke.py's check and bars); ``mamba2_block``
in its training and decode forms in f32 against the reference's, to
MIX_REL relative.  Then mamba2_27b (mixer-only layers, no FP8 site: the
bf16 recipe) and hymba_15b (attention and a Mamba2 mixer averaged, a
SwiGLU MLP: fp8_flow) at reduced() from the reference's
init_params(key(0)) carried across bit for bit, on make_batch's 8 x 64
tokens (tests/torch_model_parity.py: one reference run an arch, shared
by the cases):
- the params tree (names, shapes, dtypes) is the reference's;
- forward logits cosine >= 0.999 (tests/test_torch_archs.py's bar);
- the loss within 1e-3 relative and every leaf's gradient cosine >=
  0.999 (tests/test_torch_arch_train.py's bars);
- the cast ledger by (kind, tag) the reference's once a layer, and 2
  activation casts a dense MLP a step in fp8_flow;
- decode_step from init_cache for 4 tokens at scalar positions: logits
  cosine >= DECODE_COSINE a step, every cache leaf cosine >=
  CACHE_COSINE with the reference's dtypes (the conv history comes back
  bf16, as the reference's scan emits it).
Last, port-internal: decode_step token by token equals forward's logits
on the same prompt, at tests/test_arch_smoke.py's bars for qwen15_05b
(bf16) and f32-tight bars for mamba2_27b with f32 params."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import ssm as jssm
from repro_torch.configs import get_arch
from repro_torch.core.recipes import get_recipe
from repro_torch.models import lm, ssm
import torch_model_parity as h

RECIPE = {"mamba2_27b": "bf16", "hymba_15b": "fp8_flow"}
MIX_REL = 1e-5
DECODE_COSINE, CACHE_COSINE = 0.9999, 0.9999


def _ssd_inputs():
    r = np.random.default_rng(0)
    b, S, H, P, N = 2, 64, 4, 8, 16
    return (r.normal(size=(b, S, H, P)).astype(np.float32),
            (np.abs(r.normal(size=(b, S, H))) * 0.5).astype(np.float32),
            -np.abs(r.normal(size=(H,))).astype(np.float32),
            r.normal(size=(b, S, N)).astype(np.float32),
            r.normal(size=(b, S, N)).astype(np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_ssd_chunked_matches_reference_and_sequential():
    x, dt, A, B_, C_ = _ssd_inputs()
    y, state = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B_, C_)),
                               chunk=16)
    jy, jstate = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B_, C_)),
                                  chunk=16)
    assert _rel(y, jy) <= MIX_REL and _rel(state, jstate) <= MIX_REL
    hs = np.zeros(state.shape, np.float64)
    ys = []
    for t in range(x.shape[1]):
        a_t = np.exp(dt[:, t] * A[None])
        hs = hs * a_t[..., None, None] + np.einsum(
            "bn,bh,bhp->bhpn", B_[:, t], dt[:, t], x[:, t])
        ys.append(np.einsum("bn,bhpn->bhp", C_[:, t], hs))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(state.numpy(), hs, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("form", ["train", "decode"])
def test_mamba2_block_matches_reference(form):
    """hymba's reduced() mixer in f32 (random params, the dt bias and norm
    scale nonzero), training form on 64 tokens or one decode step from a
    random state and conv history."""
    cfg, jcfg = get_arch("hymba_15b").reduced(), jget_arch("hymba_15b").reduced()
    di, N, H, D = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.d_model
    r = np.random.default_rng(1)
    p = {"in_proj": r.normal(size=(D, 2 * di + 2 * N + H)) * 0.05,
         "conv_w": r.normal(size=(cfg.ssm_conv, di + 2 * N)) * 0.2,
         "A_log": np.log(np.linspace(1.0, 16.0, H)),
         "D": np.ones(H), "dt_bias": r.normal(size=H) * 0.1,
         "norm_s": r.normal(size=di) * 0.1,
         "out_proj": r.normal(size=(di, D)) * 0.05}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    S = 64 if form == "train" else 1
    x = r.normal(size=(2, S, D)).astype(np.float32)
    kw = {}
    if form == "decode":
        kw = dict(state=r.normal(size=(2, H, cfg.ssm_headdim, N)),
                  conv_state=r.normal(size=(2, cfg.ssm_conv - 1,
                                            di + 2 * N)), decode=True)
        kw.update({k: np.asarray(kw[k], np.float32)
                   for k in ("state", "conv_state")})
    got = ssm.mamba2_block(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x),
                           **{k: torch.from_numpy(v) if k != "decode" else v
                              for k, v in kw.items()})
    want = jssm.mamba2_block(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), **{k: jnp.asarray(v)
                                                if k != "decode" else v
                                                for k, v in kw.items()})
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _rel(a, b) <= MIX_REL


@pytest.fixture(scope="module", params=list(RECIPE))
def run(request):
    """The reference's and the port's training-forward results and decode
    steps for one arch."""
    arch = request.param
    ref = h.reference(arch, RECIPE[arch])
    toks = h.decode_tokens(get_arch(arch).reduced())
    return dict(arch=arch, ref=ref,
                port=h.port(arch, RECIPE[arch], ref["params"], ref["batch"]),
                ref_decode=h.reference_decode(ref, RECIPE[arch], toks),
                port_decode=h.port_decode(arch, RECIPE[arch], ref["params"],
                                          toks))


def test_params_tree_matches_reference(run):
    cfg = get_arch(run["arch"]).reduced()
    ours = h.named(lm.init_params(cfg, device="cpu"))
    theirs = h.named(run["ref"]["params"])
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert tuple(ours[k].shape) == theirs[k].shape, k
        assert str(ours[k].dtype).replace("torch.", "") == \
            theirs[k].dtype.name, k


def test_forward_logits_match_reference(run):
    got, want = run["port"]["logits"], run["ref"]["logits"]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert h.cos(got, want) >= 0.999


def test_loss_and_grads_match_reference(run):
    got, ref = run["port"], run["ref"]
    assert abs(got["loss"] - ref["loss"]) / abs(ref["loss"]) <= 1e-3
    assert got["grads"].keys() == ref["grads"].keys()
    low = {p: h.cos(got["grads"][p], ref["grads"][p]) for p in ref["grads"]}
    assert not {p: c for p, c in low.items() if not c >= 0.999}, low
    need = ["layers/in_proj", "layers/out_proj", "layers/conv_w",
            "layers/A_log", "layers/D", "layers/dt_bias", "layers/norm_s"]
    if run["arch"] == "hymba_15b":
        need += ["layers/wq", "layers/wo", "layers/w13", "layers/w2"]
    assert all(np.abs(ref["grads"][p]).max() > 0 for p in need), need


def test_cast_ledger_matches_reference(run):
    """The reference traces its scanned stack once; the port records each
    of its two layers.  hymba's two SwiGLU MLPs take 2 activation casts
    each; mamba2 has no FP8 site."""
    def outer(ledger, n=1):
        return {k: v * n for k, v in ledger.items()
                if not k[0].endswith("_inner")}

    cfg = get_arch(run["arch"]).reduced()
    assert outer(run["port"]["ledger"]) == outer(run["ref"]["ledger"],
                                                 cfg.n_layers)
    n_mlp = cfg.n_layers if cfg.d_ff else 0
    assert run["port"]["n_casts"] == 2 * n_mlp


def test_decode_step_matches_reference(run):
    (got, cache, dtypes), (want, jcache, jdtypes) = run["port_decode"], \
        run["ref_decode"]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and h.cos(g, w) >= DECODE_COSINE
    assert dtypes == jdtypes
    h.assert_cache_close(cache, jcache, CACHE_COSINE)


@pytest.mark.parametrize("arch", ["qwen15_05b", "mamba2_27b"])
def test_decode_step_token_by_token_equals_forward(arch):
    """Decoding 8 tokens one at a time gives forward's logits: qwen15_05b
    in bf16 at the reference's test_prefill_matches_decode bars, mamba2's
    chunked SSD against its recurrence with f32 params to 2e-4."""
    cfg = get_arch(arch).reduced()
    f32 = arch == "mamba2_27b"
    cfg = dataclasses.replace(cfg, ssm_chunk=4) if f32 else cfg
    params = lm.init_params(cfg, seed=1, device="cpu",
                            dtype=torch.float32 if f32 else torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 8)))
    recipe = get_recipe("bf16")
    with torch.no_grad():
        full, _ = lm.forward(cfg, recipe, params, {"tokens": toks},
                             compute_loss=False)
    cache = lm.init_cache(cfg, 1, 32, device="cpu")
    steps = []
    for t in range(8):
        lg, cache = lm.decode_step(cfg, recipe, params, cache,
                                   toks[:, t:t + 1], t)
        steps.append(lg[:, 0])
    dec = torch.stack(steps, 1).float().numpy()
    tol = dict(rtol=2e-4, atol=2e-4) if f32 else dict(rtol=0.1, atol=0.15)
    np.testing.assert_allclose(dec, full.float().numpy(), **tol)
