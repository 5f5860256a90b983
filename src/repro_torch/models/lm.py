"""Decoder LM: parameters, embedding, logits, the MLP and MoE stages, the
training forward with its loss, and the paged prefill / decode stacks.

Counterpart of ``repro.models.lm`` for attention-only decoders: dense
(qwen15_05b; starcoder2's ungated GELU MLP, LayerNorm and biases;
gemma's GeGLU and local:global attention with softcaps), all-MoE
(qwen3_moe, grok-1's GeGLU experts) and MoE behind a dense prologue with
shared experts (DeepSeek).  Parameters keep the reference's stacked
layout (``params["layers"][name]`` is (L, ...), the dense prologue's in
``params["dense_layers"]``), so ``repro_torch.weights.params_from_numpy``
carries the reference's trees across unchanged; each stack runs as a
Python loop over layer slices.  SSM, hybrid, encoder-decoder and frontend
architectures raise (ROADMAP.md, Queue 1, item 2).

Dense MLPs and shared experts run ``core.linear.dense_mlp`` (the expert
FFN as one group, so the recipe's FP8 pathway and kernels) in training
and prefill, and ``_mlp_decode`` (bf16 products, the activation in f32)
in decode:
the reference engine's route (its mesh branch, ``lm.py:480-482``).

Pools are updated IN PLACE (the reference returns new pools from a pure
function): a page write is an indexed store into the pool tensors.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.linear import _bf16_matmul, _gelu_f32, dense_mlp
from repro_torch.core.moe import MoEConfig, moe_block, moe_block_decode
from repro_torch.core.quant import QTensor
from repro_torch.core.recipes import Recipe
from repro_torch.device import CHUNK_ELEMS, resolve_device
from repro_torch.models.layers import (apply_norm, decode_attention,
                                       flash_attention, project_qkv)
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
    an attention-only decoder; other architectures raise."""
    kinds = layer_kinds(cfg)
    if cfg.encdec or cfg.frontend != "none" or any(
            k in ("ssm", "hybrid") for k in kinds):
        raise NotImplementedError(
            f"{cfg.name}: only attention-only decoder stacks are ported "
            "(ROADMAP.md, Queue 1, item 2)")
    return kinds, (cfg.n_dense_layers if cfg.moe else 0)


# ---------------------------------------------------------------------------
# Parameters: the reference's shapes, dtypes and init scales, drawn from a
# torch.Generator (so different numbers than jax.random from the same seed).
# ---------------------------------------------------------------------------
def _stack_params(cfg: ArchConfig, n: int, moe_layer: bool, normal, dtype,
                  dev):
    """A stack of n layers' parameters (the reference's ``_layer_params``,
    stacked): MoE layers carry the router, the experts and the shared
    experts, dense layers the MLP.  normal(shape, scale) is an f32 draw."""
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

    layers = {**norm("ln1"), **norm("ln2"),
              "wq": stacked((D, H * hd), sc, dtype),
              "wk": stacked((D, KV * hd), sc, dtype),
              "wv": stacked((D, KV * hd), sc, dtype),
              "wo": stacked((H * hd, D), sc_out, dtype)}
    if cfg.qkv_bias:
        for name, m in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            layers[name] = zeros((m,))
    if cfg.qk_norm:
        layers["q_norm"] = zeros((hd,))
        layers["k_norm"] = zeros((hd,))
    if moe_layer:
        layers["w_router"] = stacked((D, E), sc, torch.float32)
        layers["we13"] = stacked((E, D, g, Fe), sc, dtype)
        layers["we2"] = stacked((E, Fe, D), sc_out, dtype)
        if cfg.n_shared_experts:
            Fs = cfg.n_shared_experts * Fe
            layers["ws13"] = stacked((D, g, Fs), sc, dtype)
            layers["ws2"] = stacked((Fs, D), sc_out, dtype)
    elif cfg.d_ff:
        layers["w13"] = stacked((D, g, cfg.d_ff), sc, dtype)
        layers["w2"] = stacked((cfg.d_ff, D), sc_out, dtype)
    return layers


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda"):
    dev = resolve_device(device)
    _, nd = _paged_stacks(cfg)
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
        params["dense_layers"] = _stack_params(cfg, nd, False, normal, dtype,
                                               dev)
    params["layers"] = _stack_params(cfg, cfg.n_layers - nd, cfg.moe, normal,
                                     dtype, dev)
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


def stage_ln_attn(cfg, p, x, positions, window: int):
    """Pre-norm + causal attention + residual add (autograd differentiates
    the flash forward; the reference's hand-written flash VJP is XLA, not
    Pallas, and comes with a later slice)."""
    B, S, _ = x.shape
    h = apply_norm(cfg.norm, x, p, "ln1")
    q, k, v = project_qkv(cfg, p, h, positions)
    o = flash_attention(q, k, v, q_pos=positions, kv_pos=positions,
                        causal=True, window=window, softcap=cfg.attn_softcap)
    return x + o.reshape(B, S, -1) @ p["wo"].to(x.dtype)


def _sub_layer(cfg, recipe, kind, moe_layer, p, x, positions):
    """One decoder layer: attention, then the MoE stage or the dense MLP.
    Returns (x, aux), aux None for a dense layer."""
    x = stage_ln_attn(cfg, p, x, positions,
                      cfg.window if kind == "local" else 0)
    h2 = apply_norm(cfg.norm, x, p, "ln2")
    if moe_layer:
        mo, aux = _moe_stage(cfg, recipe, p, h2)
        return x + mo, aux
    return x + _mlp_stage(cfg, recipe, p, h2), None


def _run_stack(cfg, recipe, stack_params, pattern, n_layers, moe, x,
               positions):
    """The reference's scanned stack as a Python loop over layer slices;
    returns (x, the summed aux losses)."""
    pattern = _pattern_or_fallback(pattern, n_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(_train_layer_slices(stack_params, n_layers)):
        x, a = _sub_layer(cfg, recipe, pattern[i % len(pattern)], moe, p, x,
                          positions)
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
    (B, S)}.  Runs the dense prologue, then the main stack.  Returns
    (loss, metrics) or, with compute_loss=False, (logits, metrics)."""
    _, nd = _paged_stacks(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(cfg, params, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if nd:
        x, a = _run_stack(cfg, recipe, params["dense_layers"],
                          (cfg.pattern[0],), nd, False, x, positions)
        aux = aux + a
    x, a = _run_stack(cfg, recipe, params["layers"], cfg.pattern,
                      cfg.n_layers - nd, cfg.moe, x, positions)
    aux = aux + a
    logits = _lm_logits(cfg, params, _final_norm(cfg, params, x))
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
