"""The port's encoder-decoder (seamless_m4t_v2) and vision-frontend
(llava_next_34b) stacks against the JAX reference on the CPU, and the
serve and train entry points of the four configs the paged engine
refuses.

seamless (LayerNorm, ReLU, no RoPE; a non-causal encoder whose output
gets the decoder's final norm, then decoder layers with an RMSNorm'd
cross-attention; its reduced() config also takes the audio frontend's
8-row stub prefix) and llava (the vision frontend's stub prefix in front
of the tokens, cut off before the logits) at reduced() from the
reference's init_params(key(0)) carried across bit for bit, on
make_batch's 8 x 64 tokens with a 32-row encoder input and an 8-row
prefix from a numpy seed (tests/torch_model_parity.py), as
tests/test_torch_ssm.py holds mamba2 and hymba: the params tree; forward
logits cosine >= 0.999; the loss within 1e-3 relative and every leaf's
gradient; the cast ledger (2 activation casts a dense MLP a step in
fp8_flow, the encoder's MLPs included); decode_step at scalar positions
(logits and every cache leaf).

The gradient bar is 0.999 (tests/test_torch_arch_train.py's) but for
seamless in fp8_flow: its encoder sits under both decoder layers'
cross-attention, four FP8 MLPs deep, and reads the six-layer bar
``DEEP_GRAD_COSINE`` (0.998) of tests/test_torch_train_gelu_moe.py.
Measured there: lowest leaf enc_layers/ln2_s 0.99830 against the
reference, and 0.99889 against the port itself with its attention
summed over blocks of 8 rows instead of 72 (a last-bit perturbation:
the FP8 backward's own noise floor at that depth); in bf16 every leaf
>= 0.99985, so seamless in bf16 is held to 0.999.

seamless decodes with ``cache["cross"]`` left at zero, as the reference's
``init_cache`` leaves it and no code of either package writes it, and
with it filled in both packages, each by its own ``_project_cross_kv``
of the reference encoder's output on one input.  Cross rows are masked
causally (kv_pos <= pos) in both, the reference's behaviour."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.recipes import get_recipe as jget_recipe
from repro.models import lm as jlm
from repro_torch.configs import get_arch
from repro_torch.core.recipes import get_recipe
from repro_torch.models import lm
from repro_torch.weights import params_from_numpy
from test_torch_train_gelu_moe import DEEP_GRAD_COSINE
import torch_model_parity as h

CASES = [("seamless_m4t_v2", "fp8_flow"), ("seamless_m4t_v2", "bf16"),
         ("llava_next_34b", "fp8_flow")]
DECODE_COSINE, CACHE_COSINE = 0.9999, 0.9999


def _grad_bar(arch, recipe):
    return DEEP_GRAD_COSINE if (arch, recipe) == ("seamless_m4t_v2",
                                                  "fp8_flow") else 0.999


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def run(request):
    arch, recipe = request.param
    ref = h.reference(arch, recipe)
    return dict(arch=arch, recipe=recipe, ref=ref,
                port=h.port(arch, recipe, ref["params"], ref["batch"]))


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
    """Logits at the token positions only (the prefix is cut off)."""
    got, want = run["port"]["logits"], run["ref"]["logits"]
    cfg = get_arch(run["arch"]).reduced()
    assert got.shape == want.shape == (h.B, h.S, cfg.vocab_padded)
    assert np.isfinite(got).all() and h.cos(got, want) >= 0.999


def test_loss_and_grads_match_reference(run):
    got, ref = run["port"], run["ref"]
    assert abs(got["loss"] - ref["loss"]) / abs(ref["loss"]) <= 1e-3
    assert got["grads"].keys() == ref["grads"].keys()
    bar = _grad_bar(run["arch"], run["recipe"])
    low = {p: h.cos(got["grads"][p], ref["grads"][p]) for p in ref["grads"]}
    assert not {p: c for p, c in low.items() if not c >= bar}, low
    need = ["layers/w13", "layers/w2", "layers/wq", "layers/ln1_s", "embed"]
    if run["arch"] == "seamless_m4t_v2":
        need += ["enc_layers/w13", "enc_layers/w2", "enc_layers/wk",
                 "cross_layers/wq", "cross_layers/wk", "cross_layers/wv",
                 "cross_layers/wo", "cross_layers/ln_s", "layers/ln1_b"]
    assert all(np.abs(ref["grads"][p]).max() > 0 for p in need), need


def test_cast_ledger_matches_reference(run):
    """The reference traces each scanned stack once (two layers a stack);
    the port records every layer.  fp8_flow: 2 activation casts a dense
    MLP a step, the encoder's included; bf16: none."""
    def outer(ledger, n=1):
        return {k: v * n for k, v in ledger.items()
                if not k[0].endswith("_inner")}

    cfg = get_arch(run["arch"]).reduced()
    assert outer(run["port"]["ledger"]) == outer(run["ref"]["ledger"],
                                                 cfg.n_layers)
    n_mlp = cfg.n_layers + (cfg.n_enc_layers if cfg.encdec else 0)
    assert run["port"]["n_casts"] == \
        (2 * n_mlp if run["recipe"] == "fp8_flow" else 0)


def _cross_fill(run):
    """(reference k, v), (port k, v), each (L, 2, 16, KV, hd): each
    package's _project_cross_kv of the reference encoder's output on one
    2 x 16 input."""
    ref = run["ref"]
    jcfg, cfg = ref["jcfg"], get_arch(run["arch"]).reduced()
    enc_in = (np.random.default_rng(4).normal(
        size=(h.DECODE_B, h.CACHE_LEN, cfg.d_model)) * 0.5).astype(np.float32)
    recipe = jget_recipe(run["recipe"])

    def encode(p, e):
        e = e.astype(jnp.bfloat16)
        out, _ = jlm._run_stack(jcfg, recipe, ref["plan"], p["enc_layers"],
                                ("global",), jcfg.n_enc_layers, False, e,
                                jnp.arange(e.shape[1]), causal=False)
        return jlm.apply_norm(jcfg.norm, out, p, "final_norm")

    with ref["mesh"]:
        enc = jax.jit(encode)(ref["jparams"], jnp.asarray(enc_in))
        jkv = [jlm._project_cross_kv(
            jcfg, jax.tree.map(lambda a, l=l: a[l],
                               ref["jparams"]["cross_layers"]), enc)
            for l in range(jcfg.n_layers)]
    params = params_from_numpy(ref["params"], device="cpu")
    enc_t = torch.from_numpy(np.asarray(enc.astype(jnp.float32))).to(
        torch.bfloat16)
    tkv = [lm._project_cross_kv(cfg, lm.layer_slice(params["cross_layers"], l),
                                enc_t) for l in range(cfg.n_layers)]
    # the port's own encoder on the same input
    own, _ = lm._run_encoder(cfg, get_recipe(run["recipe"]), params,
                             torch.from_numpy(enc_in).to(torch.bfloat16))
    assert h.cos(h.np32(own), np.asarray(enc, np.float32)) >= 0.999
    return ([np.stack([np.asarray(kv[i], np.float32) for kv in jkv])
             for i in (0, 1)],
            [np.stack([h.np32(kv[i]) for kv in tkv]) for i in (0, 1)])


def test_decode_step_matches_reference(run):
    """4 tokens at scalar positions 0-3 from init_cache: logits a step and
    every cache leaf (dtypes the reference's); seamless with its cross
    cache left at zero, then filled.  llava's decode has no prefix path,
    as the reference's has none."""
    arch, recipe = run["arch"], run["recipe"]
    toks = h.decode_tokens(get_arch(arch).reduced())
    fills = [(None, None)]
    if arch == "seamless_m4t_v2":
        fills.append(_cross_fill(run))
        assert h.cos(fills[1][0][0], fills[1][1][0]) >= 0.9999
    for fill in fills:
        want, jcache, jdtypes = h.reference_decode(run["ref"], recipe, toks,
                                                   cross=fill[0])
        got, cache, dtypes = h.port_decode(arch, recipe,
                                           run["ref"]["params"], toks,
                                           cross=fill[1])
        for g, w in zip(got, want):
            assert np.isfinite(g).all() and h.cos(g, w) >= DECODE_COSINE
        assert dtypes == jdtypes
        h.assert_cache_close(cache, jcache, CACHE_COSINE)
        if arch == "seamless_m4t_v2":           # never written by decode
            np.testing.assert_array_equal(
                cache["cross"]["k"], np.zeros_like(cache["cross"]["k"])
                if fill[1] is None else fill[1][0])


def test_serve_step_and_prefill(run):
    """make_prefill gives the last position's logits of forward (against
    the reference's forward); make_serve_step's greedy tokens are the
    argmax of decode_step's logits; sampling needs a generator."""
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    arch, recipe = run["arch"], get_recipe(run["recipe"])
    cfg = get_arch(arch).reduced()
    params = params_from_numpy(run["ref"]["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in run["ref"]["batch"].items()}
    last = make_prefill(cfg, recipe)(params, batch)
    assert last.shape == (h.B, cfg.vocab_padded)
    assert h.cos(h.np32(last), run["ref"]["logits"][:, -1]) >= 0.999
    step = make_serve_step(cfg, recipe)
    cache = lm.init_cache(cfg, h.DECODE_B, h.CACHE_LEN, device="cpu")
    twin = lm.init_cache(cfg, h.DECODE_B, h.CACHE_LEN, device="cpu")
    tok = torch.ones((h.DECODE_B, 1), dtype=torch.int64)
    for pos in range(3):
        nxt, cache = step(params, cache, tok, pos)
        logits, twin = lm.decode_step(cfg, recipe, params, twin, tok, pos)
        assert torch.equal(nxt[:, 0], logits[:, -1].argmax(-1))
        tok = nxt
    with pytest.raises(ValueError, match="Generator"):
        step(params, cache, tok, 3, temps=torch.ones(h.DECODE_B))


@pytest.mark.parametrize("arch", ["llava_next_34b", "seamless_m4t_v2",
                                  "mamba2_27b", "hymba_15b"])
def test_paged_engine_refuses_and_names_serve_step(arch):
    """The paged engine and its launcher serve attention-only decoders,
    as the reference's; the four configs serve through serve_step."""
    from repro_torch.launch.serve import main
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    cfg = get_arch(arch).reduced()
    with pytest.raises(NotImplementedError, match="serve_step"):
        ServeEngine(cfg, get_recipe("fp8_flow"),
                    lm.init_params(cfg, device="cpu"), ServeConfig(),
                    device="cpu")
    with pytest.raises(NotImplementedError, match="serve_step"):
        main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_train_launcher_trains_llava_without_its_prefix():
    """The launcher's batches carry tokens only, as the reference's: llava
    trains without its prefix (seamless raises: tests/test_torch_train.py
    ::test_train_launcher_refuses_unported_arch)."""
    from repro_torch.launch.train import main
    losses = main(["--arch", "llava_next_34b", "--reduced", "--device", "cpu",
                   "--steps", "2", "--seq-len", "32", "--global-batch", "2"])
    assert len(losses) == 2 and np.isfinite(losses).all()
