"""Decoder LM: parameters, embedding, logits, the MLP and MoE stages, the
training forward with its loss, the dense-cache decode step, and the
paged prefill / decode stacks.

Counterpart of ``repro.models.lm`` for every architecture family of the
reference: dense (qwen15_05b; starcoder2's ungated GELU MLP, LayerNorm
and biases; gemma's GeGLU and local:global attention with softcaps),
all-MoE (qwen3_moe, grok-1's GeGLU experts), MoE behind a dense prologue
with shared experts (DeepSeek), SSM (mamba2: mixer-only layers) and
hybrid (hymba: attention and a Mamba2 mixer side by side, averaged),
encoder-decoder (seamless: a non-causal encoder, then decoder layers
with cross-attention) and a stub vision frontend (llava: precomputed
patch embeddings in front of the tokens).  Parameters keep the
reference's stacked layout (``params["layers"][name]`` is (L, ...), the
dense prologue's in ``params["dense_layers"]``, the encoder's in
``params["enc_layers"]``, the decoder's cross-attention in
``params["cross_layers"]``), so ``repro_torch.weights.params_from_numpy``
carries the reference's trees across unchanged; each stack runs as a
Python loop over layer slices.

Dense MLPs and shared experts run ``core.linear.dense_mlp`` (the expert
FFN as one group, so the recipe's FP8 pathway and kernels) in training
and prefill, and ``_mlp_decode`` (bf16 products, the activation in f32)
in decode:
the reference engine's route (its mesh branch, ``lm.py:480-482``).

Two serving paths, as in the reference.  ``init_cache`` / ``decode_step``
hold a dense (B, max_len) cache a stack (``dense_attn``, ``main_attn``,
``main_ssm``, ``cross``) and serve every architecture at a shared or
per-request position (``serve.serve_step``).  The paged path
(``paged_prefill`` / ``paged_decode_step``, the engine's) serves
attention-only decoders.  Caches and pools are updated IN PLACE (the
reference returns new ones from a pure function): a row write is an
indexed store into the cache tensors.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.linear import _bf16_matmul, _gelu_f32, dense_mlp
from repro_torch.core.moe import MoEConfig, moe_block, moe_block_decode
from repro_torch.core.quant import QTensor
from repro_torch.core.recipes import Recipe
from repro_torch.device import CHUNK_ELEMS, resolve_device
from repro_torch.models.layers import (apply_norm, attn_block,
                                       decode_attention, flash_attention,
                                       project_qkv, rmsnorm)
from repro_torch.models.ssm import mamba2_block
from repro_torch.serve.paged_kv import (SCRATCH_PAGE, page_read,
                                        page_write_rows)
from repro_torch.serve.w8 import w8_merge_gate


def layer_kinds(cfg: ArchConfig):
    return [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]


def _pattern_or_fallback(pattern, n_layers: int, first=None):
    """The reference's one rule for a stack's kinds: a pattern whose length
    does not divide the stack depth degrades to one kind, its first (or
    `first`: the paged stacks fall back to their first layer's kind,
    ``repro/models/lm.py:1110-1111``).  Training and serving both resolve
    their kinds here."""
    if n_layers % len(pattern) == 0:
        return tuple(pattern)
    return (pattern[0] if first is None else first,)


def _paged_stacks(cfg: ArchConfig):
    """(kinds, nd): every layer's kind and the dense prologue's depth, for
    an attention-only decoder.  The paged path refuses the others, as the
    reference's does (``repro/models/lm.py:1176-1183``)."""
    kinds = layer_kinds(cfg)
    if cfg.encdec or cfg.frontend != "none" or any(
            k in ("ssm", "hybrid") for k in kinds):
        raise NotImplementedError(
            f"{cfg.name}: paged serving supports attention-only decoder "
            "stacks; serve it through repro_torch.serve.serve_step "
            "(make_prefill, make_serve_step)")
    return kinds, _n_dense(cfg)


def _n_dense(cfg: ArchConfig) -> int:
    return cfg.n_dense_layers if cfg.moe else 0


# ---------------------------------------------------------------------------
# Parameters: the reference's shapes, dtypes and init scales, drawn from a
# torch.Generator (so different numbers than jax.random from the same seed).
# ---------------------------------------------------------------------------
def _stack_params(cfg: ArchConfig, kinds, moe_layer: bool, normal, dtype,
                  dev):
    """A stack of len(kinds) layers' parameters (the reference's
    ``_layer_params``, stacked): attention for the global, local and
    hybrid kinds, the Mamba2 mixer for the ssm and hybrid kinds; MoE
    layers carry the router, the experts and the shared experts, dense
    layers the MLP (an ssm layer none).  One stack is one tree, as the
    reference's stacking requires: its first kind decides the leaves.
    normal(shape, scale) is an f32 draw."""
    n, kind = len(kinds), kinds[0]
    attn, ssm = kind in ("global", "local", "hybrid"), kind in ("ssm",
                                                               "hybrid")

    def stacked(shape, scale, dt):
        # one layer at a time keeps the f32 draw to a single layer's size
        # (30 GB for a deepseek_v3_671b expert stack), rounded into place
        out = torch.empty((n, *shape), dtype=dt, device=dev)
        for i in range(n):
            out[i].copy_(normal(shape, scale))
        return out

    def zeros(shape):
        return torch.zeros((n, *shape), dtype=torch.float32, device=dev)

    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    E, Fe, g = cfg.n_experts, cfg.d_ff_expert, cfg.gate_factor
    sc, sc_out = 0.02, 0.02 / cfg.n_layers ** 0.5

    def norm(name):
        # RMSNorm scales 1 + s from zeros; LayerNorm scales from ones, and
        # biases
        if cfg.norm != "layernorm":
            return {f"{name}_s": zeros((D,))}
        return {f"{name}_s": zeros((D,)).fill_(1.0), f"{name}_b": zeros((D,))}

    layers = {**norm("ln1"), **norm("ln2")}
    if attn:
        layers.update(wq=stacked((D, H * hd), sc, dtype),
                      wk=stacked((D, KV * hd), sc, dtype),
                      wv=stacked((D, KV * hd), sc, dtype),
                      wo=stacked((H * hd, D), sc_out, dtype))
        if cfg.qkv_bias:
            for name, m in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
                layers[name] = zeros((m,))
        if cfg.qk_norm:
            layers["q_norm"] = zeros((hd,))
            layers["k_norm"] = zeros((hd,))
    if ssm and cfg.ssm_state:
        di, N, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        layers["in_proj"] = stacked((D, 2 * di + 2 * N + nh), sc, dtype)
        layers["conv_w"] = stacked((cfg.ssm_conv, di + 2 * N), 0.2,
                                   torch.float32)
        layers["A_log"] = torch.log(torch.linspace(
            1.0, 16.0, nh, dtype=torch.float32, device=dev)).repeat(n, 1)
        layers["D"] = zeros((nh,)).fill_(1.0)
        layers["dt_bias"] = zeros((nh,))
        layers["norm_s"] = zeros((di,))
        layers["out_proj"] = stacked((di, D), sc_out, dtype)
    if moe_layer:
        layers["w_router"] = stacked((D, E), sc, torch.float32)
        layers["we13"] = stacked((E, D, g, Fe), sc, dtype)
        layers["we2"] = stacked((E, Fe, D), sc_out, dtype)
        if cfg.n_shared_experts:
            Fs = cfg.n_shared_experts * Fe
            layers["ws13"] = stacked((D, g, Fs), sc, dtype)
            layers["ws2"] = stacked((Fs, D), sc_out, dtype)
    elif cfg.d_ff and kind != "ssm":
        layers["w13"] = stacked((D, g, cfg.d_ff), sc, dtype)
        layers["w2"] = stacked((cfg.d_ff, D), sc_out, dtype)
    return layers


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda"):
    dev = resolve_device(device)
    kinds, nd = layer_kinds(cfg), _n_dense(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev).mul_(scale)

    D, Vp = cfg.d_model, cfg.vocab_padded
    ln = cfg.norm == "layernorm"
    params = {
        "embed": normal((Vp, D), 0.02).to(dtype),
        "final_norm_s": (torch.ones if ln else torch.zeros)(
            (D,), dtype=torch.float32, device=dev),
    }
    if ln:
        params["final_norm_b"] = torch.zeros((D,), dtype=torch.float32,
                                             device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, Vp), 0.02).to(dtype)
    if nd:
        params["dense_layers"] = _stack_params(cfg, kinds[:nd], False, normal,
                                               dtype, dev)
    params["layers"] = _stack_params(cfg, kinds[nd:], cfg.moe, normal, dtype,
                                     dev)
    if cfg.encdec:
        params["enc_layers"] = _stack_params(
            cfg, ["global"] * cfg.n_enc_layers, False, normal, dtype, dev)
        # the decoder's cross-attention, stacked over its layers (every
        # matrix at scale 0.02, the RMSNorm scale from zeros)
        H, KV, hd, n = cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.n_layers
        cross = {name: torch.empty((n, *shape), dtype=dtype, device=dev)
                 for name, shape in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                                     ("wv", (D, KV * hd)),
                                     ("wo", (H * hd, D)))}
        for i in range(n):
            for leaf in cross.values():
                leaf[i].copy_(normal(leaf.shape[1:], 0.02))
        cross["ln_s"] = torch.zeros((n, D), dtype=torch.float32, device=dev)
        params["cross_layers"] = cross
    return params


def layer_slice(stack_params, i: int):
    """Layer i's parameters from the stacked (L, ...) tree (views)."""
    out = {}
    for name, leaf in stack_params.items():
        if isinstance(leaf, QTensor):
            out[name] = QTensor(leaf.data[i], leaf.scale[i], leaf.tile[1:])
        else:
            out[name] = leaf[i]
    return out


# ---------------------------------------------------------------------------
# Embedding, logits, the MLP and MoE stages.
# ---------------------------------------------------------------------------
def _embed_tokens(cfg, params, tokens):
    return params["embed"][tokens]


def _lm_logits(cfg, params, x):
    """bf16 logits; the vocab-pad columns are masked to -1e4."""
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    if cfg.final_softcap:
        logits = (cfg.final_softcap * torch.tanh(
            logits.to(torch.float32) / cfg.final_softcap)).to(logits.dtype)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e4)
    return logits


def _mlp_stage(cfg, recipe: Recipe, p, x):
    """Dense MLP (a dense layer's, or the shared experts' with p = {w13:
    ws13, w2: ws2}) on x (B, S, D): ``dense_mlp``, the reference's
    no-mesh branch (its mesh branch computes the same at one device)."""
    B, S, D = x.shape
    w13 = p["w13"]
    g, F = w13.shape[-2:]
    y = dense_mlp(recipe, cfg.act, x.reshape(B * S, D),
                  w13.reshape(D, g * F), p["w2"])
    return y.reshape(B, S, D)


def _mlp_decode(cfg, p, x):
    """Forward-only dense MLP of decode: bf16 products (f32 sums rounded
    once, as XLA's; cuBLAS on the card) around the activation in f32 --
    gated SwiGLU or GeGLU, or ungated GELU or ReLU (the reference's
    ``_mlp_decode``)."""
    B, S, D = x.shape
    w13 = p["w13"]                                    # (D, g, F)
    g, F = w13.shape[-2:]
    h = _bf16_matmul(x, w13.reshape(D, g * F).to(x.dtype)).to(torch.float32)
    if g == 2:
        gt, up = h[..., :F], h[..., F:]
        a = (torch.nn.functional.silu(gt) if cfg.act == "swiglu"
             else _gelu_f32(gt)) * up
    else:
        a = _gelu_f32(h) if cfg.act == "gelu" else torch.relu(h)
    return _bf16_matmul(a.to(x.dtype), p["w2"].to(x.dtype))


def _moe_stage(cfg, recipe: Recipe, p, x, decode=False):
    """x (B, S, D) -> (B, S, D), aux loss.  Prefill runs ``moe_block``,
    decode ``moe_block_decode`` (the reference's EP/decode modes at EP=1);
    the shared experts add their MLP after the routed block, through
    ``_mlp_stage`` or, in decode, ``_mlp_decode``."""
    B, S, D = x.shape
    mcfg = MoEConfig(n_experts=cfg.n_experts, top_k=cfg.top_k, d_model=D,
                     d_ff=cfg.d_ff_expert, capacity_factor=cfg.capacity_factor,
                     act=cfg.act)
    we13, we2 = p["we13"], p["we2"]
    if isinstance(we13, QTensor):
        we13 = w8_merge_gate(we13)
    else:
        E, Dl, g, F = we13.shape
        we13 = we13.reshape(E, Dl, g * F)
    block = moe_block_decode if decode else moe_block
    y, m = block(recipe, mcfg, x.reshape(B * S, D), p["w_router"], we13, we2)
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        shared = {"w13": p["ws13"], "w2": p["ws2"]}
        y = y + (_mlp_decode(cfg, shared, x) if decode
                 else _mlp_stage(cfg, recipe, shared, x))
    return y, m["aux_loss"]


# ---------------------------------------------------------------------------
# Training / prefill forward + loss.
# ---------------------------------------------------------------------------
AUX_LOSS_COEF = 0.01


def _train_layer_slices(stack_params, n: int):
    """Each layer's parameters of a stacked (n, ...) tree, for autograd.
    A one-layer stack's leaf is squeezed: its gradient is the layer's, a
    view (at full width a copy of w13's would be a 3.2 GB transient).
    Deeper stacks unbind, whose backward stacks the layers' gradients
    once; indexing would give the stacked leaf a full-size zero gradient
    per layer."""
    per_leaf = {name: ((leaf.squeeze(0),) if n == 1 else leaf.unbind(0))
                for name, leaf in stack_params.items()}
    return [{name: v[i] for name, v in per_leaf.items()} for i in range(n)]


def stage_ln_attn(cfg, p, x, positions, window: int, causal: bool = True):
    """Pre-norm + attention + residual add (autograd differentiates the
    flash forward; the reference's hand-written flash VJP is XLA, not
    Pallas, and comes with a later slice)."""
    h = apply_norm(cfg.norm, x, p, "ln1")
    out, _ = attn_block(cfg, p, h, positions=positions, layer_window=window,
                        causal=causal)
    return x + out


def _sub_layer(cfg, recipe, kind, moe_layer, p, x, positions, causal=True):
    """One layer: the mixer (attention; a Mamba2 mixer for ``ssm``; both
    on the same normed input, averaged, for ``hybrid``), then the MoE
    stage or the dense MLP (none for a mixer-only ssm layer).  Returns
    (x, aux), aux None without a router."""
    if kind in ("ssm", "hybrid"):
        h = apply_norm(cfg.norm, x, p, "ln1")
        mix, _, _ = mamba2_block(cfg, p, h)
        if kind == "hybrid":
            attn_out, _ = attn_block(cfg, p, h, positions=positions,
                                     causal=causal)
            mix = 0.5 * (attn_out + mix)
        x = x + mix
        if kind == "ssm" and not cfg.d_ff:
            return x, None
    else:
        x = stage_ln_attn(cfg, p, x, positions,
                          cfg.window if kind == "local" else 0, causal)
    h2 = apply_norm(cfg.norm, x, p, "ln2")
    if moe_layer:
        mo, aux = _moe_stage(cfg, recipe, p, h2)
        return x + mo, aux
    return x + _mlp_stage(cfg, recipe, p, h2), None


def _run_stack(cfg, recipe, stack_params, pattern, n_layers, moe, x,
               positions, causal=True):
    """The reference's scanned stack as a Python loop over layer slices;
    returns (x, the summed aux losses)."""
    pattern = _pattern_or_fallback(pattern, n_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(_train_layer_slices(stack_params, n_layers)):
        x, a = _sub_layer(cfg, recipe, pattern[i % len(pattern)], moe, p, x,
                          positions, causal)
        if a is not None:
            aux = aux + a
    return x, aux


def rms_or_ln(cfg, x, p_cross):
    """The cross-attention pre-norm: an RMSNorm whatever cfg.norm says (the
    reference's ``rms_or_ln``, ``lm.py:876-878``)."""
    return rmsnorm(x, p_cross["ln_s"])


def _project_cross_kv(cfg, p, enc):
    """The encoder output enc (B, S_enc, D) projected to one decoder
    layer's cross-attention k and v, each (B, S_enc, KV, hd)."""
    B, Se, _ = enc.shape
    k = enc @ p["wk"].to(enc.dtype)
    v = enc @ p["wv"].to(enc.dtype)
    return (k.reshape(B, Se, cfg.n_kv, cfg.head_dim),
            v.reshape(B, Se, cfg.n_kv, cfg.head_dim))


def _run_encoder(cfg, recipe, params, enc_input):
    """The encoder stack, non-causal over enc_input (B, S_enc, D), then the
    DECODER's final norm (the reference's encoder has none of its own,
    ``lm.py:800-803``).  Returns (enc, aux)."""
    positions = torch.arange(enc_input.shape[1], device=enc_input.device)
    enc, aux = _run_stack(cfg, recipe, params["enc_layers"], ("global",),
                          cfg.n_enc_layers, False, enc_input, positions,
                          causal=False)
    return _final_norm(cfg, params, enc), aux


def _run_encdec_decoder(cfg, recipe, params, x, positions, enc):
    """The decoder stack with cross-attention: each layer's self-attention
    and MLP, then cross-attention to its projection of `enc`, added to
    the residual."""
    n = cfg.n_layers
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_self, p_cross in zip(_train_layer_slices(params["layers"], n),
                               _train_layer_slices(params["cross_layers"],
                                                   n)):
        x, a = _sub_layer(cfg, recipe, "global", cfg.moe, p_self, x,
                          positions)
        h = rms_or_ln(cfg, x, p_cross)
        c_out, _ = attn_block(cfg, p_cross, h, positions=positions,
                              cross_kv=_project_cross_kv(cfg, p_cross, enc))
        x = x + c_out
        if a is not None:
            aux = aux + a
    return x, aux


class _Xent(torch.autograd.Function):
    """Cross-entropy over bf16 logits (the reference's custom VJP): the
    forward reductions and the backward dlogits run in f32 a block of rows
    at a time, so the (T, V) tensor never exists in f32; dlogits is bf16."""

    @staticmethod
    def forward(ctx, logits, targets, mask):
        V = logits.shape[-1]
        lf2 = logits.reshape(-1, V)
        t = targets.reshape(-1).long()
        step = max(1, CHUNK_ELEMS // V)
        lse, gold = [], []
        for r in range(0, lf2.shape[0], step):
            lf = lf2[r:r + step].to(torch.float32)
            m = lf.amax(dim=-1)
            lse.append(torch.log(torch.exp(lf - m[:, None]).sum(-1)) + m)
            gold.append(lf.gather(-1, t[r:r + step, None])[:, 0])
        lse, gold = torch.cat(lse), torch.cat(gold)
        mk = mask.reshape(-1).to(torch.float32)
        denom = torch.clamp(mk.sum(), min=1.0)
        ctx.save_for_backward(logits, t, mk, lse, denom)
        return ((lse - gold) * mk).sum() / denom

    @staticmethod
    def backward(ctx, g):
        logits, t, mk, lse, denom = ctx.saved_tensors
        V = logits.shape[-1]
        lf2 = logits.reshape(-1, V)
        out = torch.empty_like(lf2)
        w = mk * g / denom
        step = max(1, CHUNK_ELEMS // V)
        for r in range(0, lf2.shape[0], step):
            p = torch.exp(lf2[r:r + step].to(torch.float32)
                          - lse[r:r + step, None])
            p.scatter_add_(-1, t[r:r + step, None],
                           torch.full_like(p[:, :1], -1.0))   # p - onehot
            out[r:r + step] = (p * w[r:r + step, None]).to(out.dtype)
        return out.reshape(logits.shape), None, None


def xent(logits, targets, mask):
    return _Xent.apply(logits, targets, mask)


def forward(cfg: ArchConfig, recipe: Recipe, params, batch,
            compute_loss: bool = True):
    """batch: {'tokens' (B, S) int, 'targets' (B, S), optional 'mask'
    (B, S), optional 'prefix' (B, P, D) [the vision or audio frontend's
    stub embeddings, put in front of the tokens and cut off before the
    logits], 'enc_input' (B, S_enc, D) [an encoder-decoder's; required]}.
    Runs the encoder, the dense prologue, then the main stack.  Returns
    (loss, metrics) or, with compute_loss=False, (logits, metrics)."""
    nd = _n_dense(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(cfg, params, tokens)
    prefix = batch.get("prefix") if cfg.frontend != "none" else None
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.encdec:
        if "enc_input" not in batch:
            raise KeyError(
                f"enc_input: {cfg.name} is an encoder-decoder, and its "
                "batch needs the encoder's input embeddings (B, S_enc, D)")
        enc, a = _run_encoder(cfg, recipe, params,
                              batch["enc_input"].to(x.dtype))
        aux = aux + a
    if nd:
        x, a = _run_stack(cfg, recipe, params["dense_layers"],
                          (cfg.pattern[0],), nd, False, x, positions)
        aux = aux + a
    if cfg.encdec:
        x, a = _run_encdec_decoder(cfg, recipe, params, x, positions, enc)
    else:
        x, a = _run_stack(cfg, recipe, params["layers"], cfg.pattern,
                          cfg.n_layers - nd, cfg.moe, x, positions)
    aux = aux + a
    x = _final_norm(cfg, params, x)
    if prefix is not None:
        x = x[:, prefix.shape[1]:]
    logits = _lm_logits(cfg, params, x)
    metrics = {"aux_loss": aux}
    if not compute_loss:
        return logits, metrics
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=x.device)
    loss = xent(logits, batch["targets"], mask) + AUX_LOSS_COEF * aux
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving over a dense cache: one decode token a step for every
# architecture (the reference's fixed-batch serve path).
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               cache_dtype=torch.bfloat16, device="cuda"):
    """The decode cache, zeros: per stack, K/V (n, batch, max_len, KV, hd)
    in cache_dtype for the attention kinds (``main_attn``, ``dense_attn``),
    the f32 SSM state (n, batch, H, P, N) and conv history (n, batch,
    conv - 1, channels) for the ssm and hybrid kinds (``main_ssm``), and
    for an encoder-decoder the cross-attention K/V (``cross``, n_layers
    deep).  ``cross`` stays zero unless the caller fills it: no code of the
    reference writes it (its ``init_cache``, ``lm.py:926-931``)."""
    dev = resolve_device(device)
    kinds, nd = layer_kinds(cfg), _n_dense(cfg)
    KV, hd = cfg.n_kv, cfg.head_dim

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def attn_cache(n):
        return {"k": zeros((n, batch, max_len, KV, hd), cache_dtype),
                "v": zeros((n, batch, max_len, KV, hd), cache_dtype)}

    cache = {}
    main_kinds = kinds[nd:]
    n_main = len(main_kinds)
    if any(k != "ssm" for k in main_kinds):
        cache["main_attn"] = attn_cache(n_main)
    if any(k in ("ssm", "hybrid") for k in main_kinds):
        di, N = cfg.d_inner, cfg.ssm_state
        cache["main_ssm"] = {
            "state": zeros((n_main, batch, cfg.ssm_heads, cfg.ssm_headdim, N),
                           torch.float32),
            "conv": zeros((n_main, batch, cfg.ssm_conv - 1, di + 2 * N),
                          torch.float32)}
    if nd:
        cache["dense_attn"] = attn_cache(nd)
    if cfg.encdec:
        cache["cross"] = attn_cache(cfg.n_layers)
    return cache


def _decode_stack(cfg, recipe, stack_params, stack_kinds, moe, x, positions,
                  pos, attn_c, ssm_c, cross_c=None, cross_params=None):
    """One decode step through a stack: each layer's mixer against its
    cache slices (K/V rows and SSM states written in place), then
    cross-attention over ``cross`` (read, never written) for an
    encoder-decoder, then the MoE or dense MLP.  The kinds follow the
    reference's fallback: a pattern that does not divide the stack
    degrades to the stack's first kind.  Returns (x, the new SSM conv
    histories stacked, or None): the reference emits them in the
    activation dtype, so after a step the cache's conv leaf is bf16."""
    n = len(stack_kinds)
    pat = _pattern_or_fallback(cfg.pattern, n, first=stack_kinds[0])
    convs = []
    for i in range(n):
        kind = pat[i % len(pat)]
        pi = layer_slice(stack_params, i)
        kv = None if attn_c is None else (attn_c["k"][i], attn_c["v"][i])
        h = apply_norm(cfg.norm, x, pi, "ln1")
        if kind in ("ssm", "hybrid"):
            mix, new_state, new_conv = mamba2_block(
                cfg, pi, h, state=ssm_c["state"][i],
                conv_state=ssm_c["conv"][i], decode=True)
            ssm_c["state"][i].copy_(new_state)
            convs.append(new_conv)
            if kind == "hybrid":
                attn_out, _ = attn_block(cfg, pi, h, positions=positions,
                                         cache=kv, cache_pos=pos)
                mix = 0.5 * (attn_out + mix)
        else:
            if ssm_c is not None:
                convs.append(ssm_c["conv"][i])
            mix, _ = attn_block(cfg, pi, h, positions=positions,
                                layer_window=cfg.window if kind == "local"
                                else 0, cache=kv, cache_pos=pos)
        x = x + mix
        if cross_params is not None:
            pc = layer_slice(cross_params, i)
            ck, cv = cross_c["k"][i], cross_c["v"][i]
            hc = rms_or_ln(cfg, x, pc)
            c_out, _ = attn_block(cfg, pc, hc, positions=positions,
                                  cache=(ck, cv), cache_pos=pos,
                                  cross_kv=(ck.to(hc.dtype), cv.to(hc.dtype)))
            x = x + c_out
        if not (kind == "ssm" and not cfg.d_ff):
            h2 = apply_norm(cfg.norm, x, pi, "ln2")
            mo = _moe_stage(cfg, recipe, pi, h2, decode=True)[0] if moe \
                else _mlp_decode(cfg, pi, h2)
            x = x + mo
    return x, (torch.stack(convs) if ssm_c is not None else None)


@torch.no_grad()
def decode_step(cfg: ArchConfig, recipe: Recipe, params, cache, tokens, pos):
    """One decode step.  tokens (B, 1) int; pos: a scalar (one shared
    position, the fixed-batch path) or a (B,) tensor of per-request
    positions (cache rows [0, pos_b) hold the history).  The cache (from
    ``init_cache``) is updated in place but for the SSM conv histories,
    which are replaced.  Returns (logits (B, 1, V), the cache)."""
    x = _embed_tokens(cfg, params, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[:, None] if pos.ndim == 1 else pos.reshape(1)
    kinds, nd = layer_kinds(cfg), _n_dense(cfg)
    new_cache = dict(cache)
    if nd:
        x, _ = _decode_stack(cfg, recipe, params["dense_layers"], kinds[:nd],
                             False, x, positions, pos,
                             cache.get("dense_attn"), None)
    ssm_c = cache.get("main_ssm")
    x, convs = _decode_stack(cfg, recipe, params["layers"], kinds[nd:],
                             cfg.moe, x, positions, pos,
                             cache.get("main_attn"), ssm_c,
                             cache.get("cross"), params.get("cross_layers"))
    if convs is not None:
        new_cache["main_ssm"] = {"state": ssm_c["state"], "conv": convs}
    logits = _lm_logits(cfg, params, _final_norm(cfg, params, x))
    return logits, new_cache


# ---------------------------------------------------------------------------
# Paged serving.
# ---------------------------------------------------------------------------
def _run_paged_stack(cfg, recipe, stack_params, stack_kinds, moe, x, pool,
                     positions, page_idx, slot_idx, *, decode,
                     page_tables=None, pos=None, history=False):
    """Run a layer stack against its paged K/V pools (updated in place).

    decode=True reads the paged history through `page_tables` and masks by
    per-request `pos`; decode=False runs causal flash attention over the
    in-flight chunk, and with history=True (a chunked-prefill continuation)
    over the request's pages read back after this chunk's rows are written.
    A dense stack (moe=False) runs ``_mlp_stage`` in prefill and
    ``_mlp_decode`` in decode.  The layers' kinds follow the reference's
    fallback rule (``_pattern_or_fallback``): gemma3_4b's six-kind pattern
    over 34 layers serves every layer local, as the reference does."""
    n = len(stack_kinds)
    pat = _pattern_or_fallback(cfg.pattern, n, first=stack_kinds[0])
    for i in range(n):
        kind = pat[i % len(pat)]
        pi = layer_slice(stack_params, i)
        kc = {name: t[i] for name, t in pool["k"].items()}
        vc = {name: t[i] for name, t in pool["v"].items()}
        window = cfg.window if kind == "local" else 0
        h = apply_norm(cfg.norm, x, pi, "ln1")
        q, k, v = project_qkv(cfg, pi, h, positions)
        page_write_rows(kc, k[:, 0] if decode else k[0], page_idx, slot_idx)
        page_write_rows(vc, v[:, 0] if decode else v[0], page_idx, slot_idx)
        if decode:
            kd = page_read(kc, page_tables, q.dtype)
            vd = page_read(vc, page_tables, q.dtype)
            o = decode_attention(q, kd, vd, pos=pos, window=window,
                                 softcap=cfg.attn_softcap)
        elif history:
            kd = page_read(kc, page_tables, q.dtype)
            vd = page_read(vc, page_tables, q.dtype)
            Skv = kd.shape[1]
            bk = next(b for b in (256, 128, 64, 32, 16, 8, 4, 2, 1)
                      if Skv % b == 0)
            o = flash_attention(q, kd, vd, q_pos=positions,
                                kv_pos=torch.arange(Skv, device=x.device),
                                causal=True, window=window,
                                softcap=cfg.attn_softcap, block_k=bk)
        else:
            o = flash_attention(q, k, v, q_pos=positions, kv_pos=positions,
                                causal=True, window=window,
                                softcap=cfg.attn_softcap)
        B, S = x.shape[:2]
        x = x + o.reshape(B, S, -1) @ pi["wo"].to(x.dtype)
        h2 = apply_norm(cfg.norm, x, pi, "ln2")
        if moe:
            mo, _ = _moe_stage(cfg, recipe, pi, h2, decode=decode)
        else:
            mo = _mlp_decode(cfg, pi, h2) if decode \
                else _mlp_stage(cfg, recipe, pi, h2)
        x = x + mo
    return x


def _run_paged_stacks(cfg, recipe, params, pools, x, positions, page_idx,
                      slot_idx, **kw):
    """The dense prologue's stack against ``dense_attn``, then the main
    stack against ``main_attn``."""
    kinds, nd = _paged_stacks(cfg)
    if nd:
        x = _run_paged_stack(cfg, recipe, params["dense_layers"], kinds[:nd],
                             False, x, pools["dense_attn"], positions,
                             page_idx, slot_idx, **kw)
    return _run_paged_stack(cfg, recipe, params["layers"], kinds[nd:],
                            cfg.moe, x, pools["main_attn"], positions,
                            page_idx, slot_idx, **kw)


def _final_norm(cfg, params, x):
    return apply_norm(cfg.norm, x, {"final_norm_s": params["final_norm_s"],
                                    "final_norm_b": params.get("final_norm_b")},
                      "final_norm")


def paged_decode_step(cfg: ArchConfig, recipe: Recipe, params, pools,
                      page_tables, tokens, pos, active):
    """One continuous-batching decode step over paged pools.

    tokens (B, 1) int; pos (B,) per-request positions of this token; active
    (B,) bool (inactive slots write to the scratch page; their outputs are
    garbage); page_tables (B, max_pages).  Returns logits (B, 1, V)."""
    x = _embed_tokens(cfg, params, tokens)
    B = x.shape[0]
    pos = pos.to(torch.int64)
    ps = pools["main_attn"]["k"]["data"].shape[2]
    rows = torch.arange(B, device=x.device)
    page_idx = torch.where(active, page_tables[rows, pos // ps].to(torch.int64),
                           SCRATCH_PAGE)
    x = _run_paged_stacks(cfg, recipe, params, pools, x, pos[:, None],
                          page_idx, pos % ps, decode=True,
                          page_tables=page_tables, pos=pos)
    return _lm_logits(cfg, params, _final_norm(cfg, params, x))


def paged_prefill(cfg: ArchConfig, recipe: Recipe, params, pools,
                  page_table_row, tokens, length: int, start: int = 0,
                  history: bool = False):
    """Prefill ONE request's prompt chunk into its pages.

    tokens (1, S), right-padded to the bucket S; `length` valid tokens in
    this chunk at absolute offset `start`; rows >= length land on the
    scratch page.  history=True attends to the rows [0, start) already in
    the pages.  Returns logits (1, 1, V) at position start + length - 1."""
    x = _embed_tokens(cfg, params, tokens)
    S = x.shape[1]
    rel = torch.arange(S, device=x.device)
    positions = start + rel
    ps = pools["main_attn"]["k"]["data"].shape[2]
    mp = page_table_row.shape[0]
    # out-of-table page indices only occur on padded rows (masked to the
    # scratch page); clamp them as jax indexing would
    pages = page_table_row[torch.clamp(positions // ps, max=mp - 1)]
    page_idx = torch.where(rel < length, pages.to(torch.int64), SCRATCH_PAGE)
    x = _run_paged_stacks(cfg, recipe, params, pools, x, positions,
                          page_idx, positions % ps, decode=False,
                          page_tables=page_table_row[None], history=history)
    x = _final_norm(cfg, params, x)
    last = min(max(int(length) - 1, 0), S - 1)
    return _lm_logits(cfg, params, x[:, last:last + 1])
