"""Decoder LM: parameters, embedding, logits, the MoE stage, the training
forward with its loss, and the paged prefill / decode stacks.

Counterpart of ``repro.models.lm`` for attention-only decoders whose every
layer is an MoE layer (qwen3_moe).  Parameters keep the reference's
stacked layout (``params["layers"][name]`` is (L, ...)), so
``repro_torch.weights.params_from_numpy`` carries the reference's trees
across unchanged; the stack runs as a Python loop over layer slices.
Architectures with dense layers or shared experts raise until the dense
MLP is ported (ROADMAP.md, Queue 1, item 2).

Pools are updated IN PLACE (the reference returns new pools from a pure
function): a page write is an indexed store into the pool tensors.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
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


def _paged_stacks(cfg: ArchConfig):
    kinds = layer_kinds(cfg)
    if cfg.encdec or cfg.frontend != "none" or any(
            k in ("ssm", "hybrid") for k in kinds):
        raise NotImplementedError(
            "paged serving supports attention-only decoder stacks")
    if not cfg.moe or cfg.n_dense_layers or cfg.n_shared_experts:
        raise NotImplementedError(
            f"{cfg.name}: dense layers and shared experts are not ported yet "
            "(ROADMAP.md, Queue 1, item 2)")
    return kinds


# ---------------------------------------------------------------------------
# Parameters: the reference's shapes, dtypes and init scales, drawn from a
# torch.Generator (so different numbers than jax.random from the same seed).
# ---------------------------------------------------------------------------
def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda"):
    dev = resolve_device(device)
    _paged_stacks(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, scale, dt):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * scale).to(dt)

    def stacked(shape, scale, dt):
        # one layer at a time keeps the f32 draw to a single layer's size
        out = torch.empty((cfg.n_layers, *shape), dtype=dt, device=dev)
        for i in range(cfg.n_layers):
            out[i] = normal(shape, scale, dt)
        return out

    def zeros(shape):
        return torch.zeros((cfg.n_layers, *shape), dtype=torch.float32,
                           device=dev)

    L, D, H, KV, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, \
        cfg.head_dim
    Vp, E, Fe, g = cfg.vocab_padded, cfg.n_experts, cfg.d_ff_expert, \
        cfg.gate_factor
    sc, sc_out = 0.02, 0.02 / L ** 0.5
    params = {
        "embed": normal((Vp, D), 0.02, dtype),
        "final_norm_s": torch.zeros((D,), dtype=torch.float32, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, Vp), 0.02, dtype)
    layers = {"ln1_s": zeros((D,)), "ln2_s": zeros((D,)),
              "wq": stacked((D, H * hd), sc, dtype),
              "wk": stacked((D, KV * hd), sc, dtype),
              "wv": stacked((D, KV * hd), sc, dtype),
              "wo": stacked((H * hd, D), sc_out, dtype)}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            layers[name] = zeros((n,))
    if cfg.qk_norm:
        layers["q_norm"] = zeros((hd,))
        layers["k_norm"] = zeros((hd,))
    layers["w_router"] = stacked((D, E), sc, torch.float32)
    layers["we13"] = stacked((E, D, g, Fe), sc, dtype)
    layers["we2"] = stacked((E, Fe, D), sc_out, dtype)
    params["layers"] = layers
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
# Embedding, logits, MoE stage.
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


def _moe_stage(cfg, recipe: Recipe, p, x, decode=False):
    """x (B, S, D) -> (B, S, D), aux loss.  Prefill runs ``moe_block``,
    decode ``moe_block_decode`` (the reference's EP/decode modes at EP=1)."""
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
    return y.reshape(B, S, D), m["aux_loss"]


# ---------------------------------------------------------------------------
# Training / prefill forward + loss.
# ---------------------------------------------------------------------------
AUX_LOSS_COEF = 0.01


class _LayerSlice(torch.autograd.Function):
    """leaf[i] of a stacked (L, ...) parameter.  Plain indexing would give
    the stacked leaf a full-size zero gradient per layer; a one-layer stack
    takes its layer's gradient as it comes (a view, no copy), which at full
    width saves a 3.2 GB transient on w13."""

    @staticmethod
    def forward(ctx, leaf, i):
        ctx.i, ctx.shape = i, leaf.shape
        return leaf[i]

    @staticmethod
    def backward(ctx, g):
        if ctx.shape[0] == 1:
            return g.unsqueeze(0), None
        full = g.new_zeros(ctx.shape)
        full[ctx.i] = g
        return full, None


def _train_layer_slice(stack_params, i: int):
    return {name: _LayerSlice.apply(leaf, i)
            for name, leaf in stack_params.items()}


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


def _sub_layer(cfg, recipe, kind, p, x, positions):
    """One decoder layer: attention, then the MoE stage.  Returns (x, aux)."""
    x = stage_ln_attn(cfg, p, x, positions,
                      cfg.window if kind == "local" else 0)
    mo, aux = _moe_stage(cfg, recipe, p, apply_norm(cfg.norm, x, p, "ln2"))
    return x + mo, aux


def _run_stack(cfg, recipe, stack_params, pattern, n_layers, x, positions):
    """The reference's scanned stack as a Python loop over layer slices."""
    if n_layers % len(pattern):
        pattern = (pattern[0],)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_layers):
        x, a = _sub_layer(cfg, recipe, pattern[i % len(pattern)],
                          _train_layer_slice(stack_params, i), x, positions)
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
    (B, S)}.  Returns (loss, metrics) or, with compute_loss=False,
    (logits, metrics)."""
    _paged_stacks(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(cfg, params, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    x, aux = _run_stack(cfg, recipe, params["layers"], cfg.pattern,
                        cfg.n_layers, x, positions)
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
def _run_paged_stack(cfg, recipe, stack_params, stack_kinds, x, pool,
                     positions, page_idx, slot_idx, *, decode,
                     page_tables=None, pos=None, history=False):
    """Run a layer stack against its paged K/V pools (updated in place).

    decode=True reads the paged history through `page_tables` and masks by
    per-request `pos`; decode=False runs causal flash attention over the
    in-flight chunk, and with history=True (a chunked-prefill continuation)
    over the request's pages read back after this chunk's rows are written."""
    for i, kind in enumerate(stack_kinds):
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
        mo, _ = _moe_stage(cfg, recipe, pi, h2, decode=decode)
        x = x + mo
    return x


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
    kinds = _paged_stacks(cfg)
    x = _embed_tokens(cfg, params, tokens)
    B = x.shape[0]
    pos = pos.to(torch.int64)
    ps = pools["main_attn"]["k"]["data"].shape[2]
    rows = torch.arange(B, device=x.device)
    page_idx = torch.where(active, page_tables[rows, pos // ps].to(torch.int64),
                           SCRATCH_PAGE)
    x = _run_paged_stack(cfg, recipe, params["layers"], kinds, x,
                         pools["main_attn"], pos[:, None], page_idx, pos % ps,
                         decode=True, page_tables=page_tables, pos=pos)
    return _lm_logits(cfg, params, _final_norm(cfg, params, x))


def paged_prefill(cfg: ArchConfig, recipe: Recipe, params, pools,
                  page_table_row, tokens, length: int, start: int = 0,
                  history: bool = False):
    """Prefill ONE request's prompt chunk into its pages.

    tokens (1, S), right-padded to the bucket S; `length` valid tokens in
    this chunk at absolute offset `start`; rows >= length land on the
    scratch page.  history=True attends to the rows [0, start) already in
    the pages.  Returns logits (1, 1, V) at position start + length - 1."""
    kinds = _paged_stacks(cfg)
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
    x = _run_paged_stack(cfg, recipe, params["layers"], kinds, x,
                         pools["main_attn"], positions, page_idx,
                         positions % ps, decode=False,
                         page_tables=page_table_row[None], history=history)
    x = _final_norm(cfg, params, x)
    last = min(max(int(length) - 1, 0), S - 1)
    return _lm_logits(cfg, params, x[:, last:last + 1])
