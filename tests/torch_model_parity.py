"""Shared helpers of the whole-model parity tests of the SSM, hybrid,
encoder-decoder and frontend configs (tests/test_torch_ssm.py,
tests/test_torch_encdec_frontend.py): one reference run an arch, its
params carried across bit for bit, and the port run on the same inputs.

The reference runs at reduced() on its XLA route (a 1x1 mesh plan, remat
off), as tests/test_torch_arch_train.py runs it: one jitted
value_and_grad gives the loss, the logits and every leaf's gradient, and
a forward-only trace subtracted from its cast ledger leaves one forward
and the backward.  Its decode is one jitted ``decode_step`` called at
scalar positions 0, 1, 2, ..."""
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jget_arch
from repro.core import casts as jcasts
from repro.core.recipes import get_recipe as jget_recipe
from repro.models import lm as jlm
from repro_torch.configs import get_arch
from repro_torch.core import casts
from repro_torch.core.recipes import get_recipe
from repro_torch.data.pipeline import DataConfig, make_batch_np
from repro_torch.models import lm
from repro_torch.optim.adamw import tree_leaves
from repro_torch.weights import params_from_numpy
from tests.conftest import make_mesh11

B, S, S_ENC = 8, 64, 32
DECODE_B, DECODE_STEPS, CACHE_LEN = 2, 4, 16


def cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0.0 and nb == 0.0:
        return 1.0
    return float(a @ b / max(na * nb, 1e-300))


def named(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(named(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def np32(t):
    return t.detach().to(torch.float32).numpy()


def batch_np(cfg, seed=0):
    """make_batch's B x S tokens (bitwise the reference pipeline's), and
    the frontend prefix or the encoder input (N(0, 0.5) embeddings) the
    config takes, from a numpy seed."""
    out = make_batch_np(DataConfig(vocab=cfg.vocab, seq_len=S,
                                   global_batch=B), 0)
    r = np.random.default_rng(seed)
    if cfg.frontend != "none":
        out["prefix"] = (r.normal(size=(B, cfg.frontend_len, cfg.d_model))
                         * 0.5).astype(np.float32)
    if cfg.encdec:
        out["enc_input"] = (r.normal(size=(B, S_ENC, cfg.d_model))
                            * 0.5).astype(np.float32)
    return out


def decode_tokens(cfg, seed=3):
    r = np.random.default_rng(seed)
    return r.integers(0, cfg.vocab, (DECODE_STEPS, DECODE_B, 1)).astype(np.int32)


def reference(arch, recipe_name):
    """The reference's params (numpy), batch, loss, logits, gradients by
    path and cast ledger by tag, at reduced() from init_params(key(0))."""
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), remat_policy="none")
    params = jlm.init_params(jcfg, jax.random.key(0))
    batch = batch_np(jcfg)
    mesh = make_mesh11()
    plan = jlm.ParallelPlan(mesh=mesh, dp_axes=("data",))
    recipe = jget_recipe(recipe_name)

    def loss_fn(p, b):
        logits, m = jlm.forward(jcfg, recipe, plan, p, b, compute_loss=False)
        loss = jlm._xent(logits, b["targets"], b["mask"]) \
            + jlm.AUX_LOSS_COEF * m["aux_loss"]
        return loss, logits

    with mesh:
        with jcasts.ledger() as fwd:
            jax.eval_shape(loss_fn, params, batch)
        with jcasts.ledger() as full:
            (loss, logits), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(params, batch)
            jax.block_until_ready(grads)
    led = Counter(full.by_tag())
    led.subtract(fwd.by_tag())
    assert all(n >= 0 for n in led.values()), led
    return dict(jcfg=jcfg, jparams=params, plan=plan, mesh=mesh,
                params=jax.tree.map(np.asarray, params), batch=batch,
                loss=float(loss), logits=np.asarray(logits, np.float32),
                grads=named(jax.tree.map(np.asarray, grads)), ledger=+led)


def port(arch, recipe_name, params_np, batch):
    """The port's loss, logits, gradients by path and cast ledger by tag on
    the reference's params and batch."""
    cfg = get_arch(arch).reduced()
    params = params_from_numpy(params_np, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with casts.ledger() as led:
        logits, m = lm.forward(cfg, get_recipe(recipe_name), params, tb,
                               compute_loss=False)
        loss = lm.xent(logits, tb["targets"], tb["mask"]) \
            + lm.AUX_LOSS_COEF * m["aux_loss"]
        loss.backward()
    grads = {path: np32(p.grad) if p.grad is not None
             else np.zeros(p.shape, np.float32)
             for path, p in named(params).items()}
    return dict(loss=float(loss.detach()), logits=np32(logits), grads=grads,
                ledger=led.by_tag(), n_casts=led.activation_casts())


def reference_decode(ref, recipe_name, tokens, cross=None):
    """The reference's decode_step from init_cache(B, CACHE_LEN) over the
    steps of `tokens` at scalar pos 0, 1, ...; `cross` (k, v) numpy,
    (L, B, S_enc, KV, hd), fills the first rows of cache["cross"].
    Returns (logits a step, the final cache, numpy)."""
    jcfg, plan = ref["jcfg"], ref["plan"]
    recipe = jget_recipe(recipe_name)
    cache = jlm.init_cache(jcfg, DECODE_B, CACHE_LEN)
    if cross is not None:
        n = cross[0].shape[2]
        cache["cross"] = {
            name: cache["cross"][name].at[:, :, :n].set(
                jnp.asarray(a).astype(cache["cross"][name].dtype))
            for name, a in zip(("k", "v"), cross)}
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(
        jcfg, recipe, plan, p, c, t, pos))
    out = []
    with ref["mesh"]:
        for i, t in enumerate(tokens):
            lg, cache = step(ref["jparams"], cache, jnp.asarray(t),
                             jnp.int32(i))
            out.append(np.asarray(lg, np.float32))
    return out, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                             cache), jax.tree.map(lambda a: str(a.dtype),
                                                  cache)


def port_decode(arch, recipe_name, params_np, tokens, cross=None, cfg=None):
    """The port's decode_step over the same steps (cross filled as in
    reference_decode), on `cfg` (default: the arch's reduced()).  Returns
    (logits a step, the final cache as f32 numpy, its dtypes by leaf)."""
    cfg = get_arch(arch).reduced() if cfg is None else cfg
    params = params_from_numpy(params_np, device="cpu")
    cache = lm.init_cache(cfg, DECODE_B, CACHE_LEN, device="cpu")
    if cross is not None:
        n = cross[0].shape[2]
        for name, a in zip(("k", "v"), cross):
            leaf = cache["cross"][name]
            leaf[:, :, :n] = torch.from_numpy(np.asarray(a, np.float32)).to(
                leaf.dtype)
    out = []
    for i, t in enumerate(tokens):
        lg, cache = lm.decode_step(cfg, get_recipe(recipe_name), params,
                                   cache, torch.from_numpy(t).long(), i)
        out.append(np32(lg))
    return out, {k: {n: np32(v) for n, v in d.items()}
                 for k, d in cache.items()}, {
        k: {n: str(v.dtype).replace("torch.", "") for n, v in d.items()}
        for k, d in cache.items()}


def assert_cache_close(got, want, min_cos):
    """Every cache leaf present on both sides, and each leaf's cosine >=
    min_cos (leaves zero on both sides agree)."""
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].keys() == want[k].keys(), k
        for n in want[k]:
            assert got[k][n].shape == want[k][n].shape, (k, n)
            c = cos(got[k][n], want[k][n])
            assert c >= min_cos, (k, n, c)

