"""Mamba2 (SSD, state-space duality) mixer: the chunked training form and
the O(1) decode recurrence.

Counterpart of ``repro.models.ssm`` in plain PyTorch, with the
reference's order of operations and dtypes: the in/out projections in
the activation dtype (bf16; their widths 2*di + 2*N + nh break the
128-tile alignment of the FP8 pathway, so they stay bf16 in every
recipe, as in the reference), the causal depthwise conv in that dtype,
f32 from the conv's SiLU on, ``rmsnorm(y.to(x.dtype))`` before the out
projection.  The reference's SSD is XLA (a ``lax.scan`` over chunks), not
a Pallas kernel; the inter-chunk recurrence here is a Python loop over
chunks with an f32 state.

Each three-operand einsum of the reference is contracted pairwise in the
order that keeps every intermediate at most (b, nc, H, Q, Q): dt * x
before the intra-chunk product, C against the chunk states before the
decay.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.linear import _bf16_matmul
from repro_torch.models.layers import rmsnorm


def _segsum(log_a):
    """log_a (..., Q) -> (..., Q, Q): out[..., i, j] = sum over j < k <= i
    of log_a_k, and -inf above the diagonal."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(Q, device=log_a.device)
    return torch.where(i[:, None] >= i[None, :], diff, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD forward.  x (b, S, H, P) per-head inputs; dt (b, S, H) positive
    step sizes; A (H,) negative decay rates; B, C (b, S, N) input and
    output maps (one group, broadcast over heads).  Returns y (b, S, H, P)
    and the final state (b, H, P, N), f32."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    if nc * Q != S:
        raise ValueError(f"sequence {S} is not a multiple of chunk {Q}")
    xb = x.reshape(b, nc, Q, H, P)
    dtb = dt.reshape(b, nc, Q, H)
    Bb = B.reshape(b, nc, Q, N)
    Cb = C.reshape(b, nc, Q, N)
    log_a = dtb * A                                       # (b,nc,Q,H)

    # intra-chunk (quadratic within a chunk)
    L = torch.exp(_segsum(log_a.movedim(-1, -2)))         # (b,nc,H,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", Cb, Bb)      # (b,nc,Q,Q)
    M = scores[:, :, None] * L                            # (b,nc,H,Q,Q)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M, dtb[..., None] * xb)

    # each chunk's contribution to the state at its end
    csum = torch.cumsum(log_a, dim=2)                     # (b,nc,Q,H)
    decay_to_end = torch.exp(csum[:, :, -1:, :] - csum)
    S_chunk = torch.einsum("bcjn,bcjhp->bchpn", Bb,
                           (dtb * decay_to_end)[..., None] * xb)
    a_chunk = torch.exp(csum[:, :, -1, :])                # (b,nc,H)

    # the inter-chunk recurrence, sequential over chunks
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    prev = []
    S_chunk, a_chunk = S_chunk.to(torch.float32), a_chunk.to(torch.float32)
    for c in range(nc):
        prev.append(state)                                # state BEFORE chunk
        state = state * a_chunk[:, c, :, None, None] + S_chunk[:, c]
    prev_states = torch.stack(prev, dim=1).to(Cb.dtype)   # (b,nc,H,P,N)

    y_inter = torch.einsum("bcin,bchpn->bcihp", Cb, prev_states) \
        * torch.exp(csum)[..., None]
    return (y_intra + y_inter).reshape(b, S, H, P), state


def _matmul(x, w):
    """x @ w in x's dtype: bf16 products from f32 sums rounded once (the
    reference's XLA dot), f32 as is."""
    w = w.to(x.dtype)
    return _bf16_matmul(x, w) if x.dtype == torch.bfloat16 else x @ w


def _softplus(x):
    """jax.nn.softplus's form: logaddexp(x, 0)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def mamba2_block(cfg, p, x, *, state=None, conv_state=None, decode=False):
    """The Mamba2 mixer on x (B, S, D).  Training (decode=False) returns
    (y, None, None); decode (S == 1) returns (y, the new state (B, H, P, N)
    f32, the new conv history (B, conv - 1, channels) in x's dtype)."""
    Bsz, S, D = x.shape
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P, conv = cfg.ssm_headdim, cfg.ssm_conv

    zxbcdt = _matmul(x, p["in_proj"])
    z, xs, Bm, Cm, dt = torch.split(zxbcdt, [di, di, N, N, H], dim=-1)

    # causal depthwise conv over [xs | B | C]
    xbc = torch.cat([xs, Bm, Cm], dim=-1)                 # (B,S,ch)
    w = p["conv_w"].to(xbc.dtype)
    if decode:
        hist = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        new_conv = hist[:, -(conv - 1):]
        xbc = torch.einsum("bck,ck->bk", hist[:, -conv:].to(torch.float32),
                           w.to(torch.float32)).to(xbc.dtype)[:, None, :]
    else:
        pad = torch.zeros((Bsz, conv - 1, xbc.shape[-1]), dtype=xbc.dtype,
                          device=x.device)
        hist = torch.cat([pad, xbc], dim=1)
        xbc = sum(hist[:, i:i + S] * w[i] for i in range(conv))
        new_conv = None
    xbc = F.silu(xbc.to(torch.float32))
    xs, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)

    dt = _softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))          # (H,)
    xh = xs.reshape(Bsz, S, H, P)

    if decode:
        a = torch.exp(dt[:, 0, :] * A)                    # (B,H)
        dBx = (dt[:, 0, :, None] * xh[:, 0])[..., None] \
            * Bm[:, 0, None, None, :]                     # (B,H,P,N)
        new_state = state * a[..., None, None] + dBx
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], new_state)
        y = y.reshape(Bsz, 1, H, P)
    else:
        y, new_state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)

    y = y + xh * p["D"].to(torch.float32)[None, None, :, None]
    y = y.reshape(Bsz, S, di)
    # gated RMSNorm (mamba2), then the output projection
    y = y * F.silu(z.to(torch.float32))
    y = rmsnorm(y.to(x.dtype), p["norm_s"])
    out = _matmul(y, p["out_proj"])
    return out, (new_state if decode else None), new_conv
