"""Transformer layer primitives for the serving and training paths: norms,
RoPE, the QKV projection, blocked (flash-style) prefill attention
(causal, windowed, or non-causal over an encoder's rows), decode
attention at a per-request or shared position, and the attention block
over a dense decode cache.

Counterpart of the forward subset of ``repro.models.layers``, in plain
PyTorch ops with the reference's layouts (q (B, S, H, hd), k/v
(B, S, KV, hd)) and arithmetic: f32 softmax, the softmax scale folded
into q for prefill, -1e30 masking.  Training differentiates these with
autograd: the reference's hand-written flash-attention VJP is XLA code,
not a Pallas kernel, and a hand-written backward is a later slice's.  Attention stays bf16 in every recipe
(the paper's FP8 scope is the MoE stage).  ``scaled_dot_product_attention``
is not used: it is a library kernel.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def rmsnorm(x, scale, eps=1e-6):
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def apply_norm(kind, x, p, name):
    if kind == "layernorm":
        return layernorm(x, p[f"{name}_s"], p[f"{name}_b"])
    return rmsnorm(x, p[f"{name}_s"])


def rope_freqs(head_dim, theta, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """x (..., S, H, hd); positions (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _softmax_scale(hd: int, device) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                         device=device))


def _mask(q_pos, kv_pos, causal: bool, window: int):
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= kv_pos[None, :] > (q_pos[:, None] - window)
    return mask


def flash_attention(q, k, v, *, q_pos, kv_pos, causal=True, window=0,
                    softcap=0.0, block_k=256):
    """q (B, Sq, H, hd); k, v (B, Skv, KV, hd); q_pos (Sq,), kv_pos (Skv,).
    Online softmax over KV blocks of block_k rows (GQA by head grouping)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = (q.to(torch.float32) * _softmax_scale(hd, q.device)).reshape(
        B, Sq, KV, G, hd)
    bk = min(block_k, Skv)
    if Skv % bk:
        raise ValueError(f"kv length {Skv} is not a multiple of block {bk}")
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, KV, G, hd), dtype=torch.float32, device=q.device)
    for b0 in range(0, Skv, bk):
        kblk = k[:, b0:b0 + bk].to(torch.float32)
        vblk = v[:, b0:b0 + bk].to(torch.float32)
        s = torch.einsum("bqkgh,bckh->bqkgc", qf, kblk)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        mask = _mask(q_pos, kv_pos[b0:b0 + bk], causal, window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckh->bqkgh", p, vblk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, pos, window=0, softcap=0.0):
    """Single-step decode: q (B, 1, H, hd); caches (B, Smax, KV, hd); rows
    [0, pos] are valid.  pos is a (B,) tensor (each request at its own
    depth: the full cache is read and window-masked) or a scalar (one
    shared position: a windowed layer reads only the `window` rows that end
    at pos, the reference's dynamic slice, whose values equal the masked
    read)."""
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    pos = torch.as_tensor(pos, device=q.device)
    per_request = pos.ndim == 1
    if window and window < Smax and not per_request:
        start = torch.clamp(pos - window + 1, 0, Smax - window)
        kv_pos = start + torch.arange(window, device=q.device)
        k_cache = k_cache.index_select(1, kv_pos)
        v_cache = v_cache.index_select(1, kv_pos)
    else:
        kv_pos = torch.arange(Smax, device=q.device)
    G = H // KV
    qf = q.to(torch.float32).reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bckh->bkgc", qf, k_cache.to(torch.float32)) \
        * _softmax_scale(hd, q.device)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if per_request:
        mask = kv_pos[None, :] <= pos[:, None]
        if window:
            mask &= kv_pos[None, :] > (pos[:, None] - window)
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
    else:
        s = torch.where((kv_pos <= pos)[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckh->bkgh", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def project_qkv(cfg, p, x, positions, cross_kv=None):
    """QKV projections + bias + qk-norm + RoPE.  x (B, S, D); positions
    (S,) or (B, S).  Returns q (B,S,H,hd), k and v (B,S,KV,hd); with
    `cross_kv` (the encoder's projected k, v) only q is projected, and
    neither is normed or rotated."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, S, H, hd)
    if cross_kv is None:
        k = x @ p["wk"].to(x.dtype)
        v = x @ p["wv"].to(x.dtype)
        if cfg.qkv_bias:
            k = k + p["bk"].to(x.dtype)
            v = v + p["bv"].to(x.dtype)
        k = k.reshape(B, S, KV, hd)
        v = v.reshape(B, S, KV, hd)
    else:
        k, v = cross_kv
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        if cross_kv is None:
            k = rmsnorm(k, p["k_norm"])
    if cross_kv is None and cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_block(cfg, p, x, *, positions, layer_window=0, cache=None,
               cache_pos=None, cross_kv=None, causal=True):
    """Projections + RoPE + attention + output projection.  x (B, S, D).

    cache: optional dense (k_cache, v_cache), each (B, Smax, KV, hd), for
    decode: this step's row is written IN PLACE at cache_pos (a scalar
    shared position, clamped into the cache as the reference's dynamic
    update is, or a (B,) vector), and the step attends over the cache.
    cross_kv: the encoder's projected (k, v): no row is written, and
    without a cache the attention is non-causal over kv positions
    arange(S_enc).  Returns (out (B, S, D), the cache or None)."""
    B, S, D = x.shape
    q, k, v = project_qkv(cfg, p, x, positions, cross_kv=cross_kv)
    if cache is not None:
        k_cache, v_cache = cache
        if cross_kv is None:
            cp = torch.as_tensor(cache_pos, device=x.device)
            if cp.ndim == 1:                   # per-request write rows
                rows = torch.arange(B, device=x.device)
                k_cache[rows, cp] = k[:, 0].to(k_cache.dtype)
                v_cache[rows, cp] = v[:, 0].to(v_cache.dtype)
            else:
                row = torch.clamp(cp, 0, k_cache.shape[1] - 1).reshape(1)
                k_cache.index_copy_(1, row, k.to(k_cache.dtype))
                v_cache.index_copy_(1, row, v.to(v_cache.dtype))
        o = decode_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                             pos=cache_pos, window=layer_window,
                             softcap=cfg.attn_softcap)
        new_cache = (k_cache, v_cache)
    else:
        kv_pos = positions if cross_kv is None else torch.arange(
            k.shape[1], device=x.device)
        o = flash_attention(q, k, v, q_pos=positions, kv_pos=kv_pos,
                            causal=causal and cross_kv is None,
                            window=layer_window, softcap=cfg.attn_softcap)
        new_cache = None
    return o.reshape(B, S, -1) @ p["wo"].to(x.dtype), new_cache
