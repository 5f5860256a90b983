"""The MoE block, EP = 1: router -> dispatch -> expert grouping ->
grouped expert FFN -> combine, forward and backward, for every recipe.

Counterpart of the EP = 1 subset of ``repro.core.moe``.  With one
expert-parallel rank every all-to-all and psum of the reference is an
identity, so it is left out; the routing plans, the capacities and the
drop rules are kept bit for bit, because they decide which assignments
drop (core/moe.py:279, :283, :503 in the reference; the 128-row rounding
of C_exp is part of that).  The plans use stable argsorts, and their
scatters hit duplicate indices only on the scratch slot that is sliced
off, as in the reference.

The dispatch follows the recipe, as in the reference: fp8_flow sends FP8
both ways (``dispatch_quantize``, then ``permute_q`` into the expert
layout), naive_fp8 quantizes, permutes and dequantizes around the send
with a bf16 backward (``fp8_dispatch_naive``: 2 explicit casts), bf16 and
blockwise gather bf16 rows.  The FP8 boundaries are
``torch.autograd.Function``s, as they are ``custom_vjp``s in the
reference: ``dispatch_quantize`` (backward: the FP8 gradient rows
dequantized inside the per-token segment sum), ``permute_q`` (backward:
the same fused permute+pad kernel gathers the FP8 cotangent by the inverse
map, with no dequantize) and ``fp8_dispatch_naive``.  The router, the bf16
gathers, the probability weighting and the combine are plain
differentiable ops.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import casts
from repro_torch.core.fp8 import TILE
from repro_torch.core.linear import (dequantize_exit, expert_ffn,
                                     quantize_entry)
from repro_torch.core.quant import QTensor, _dequantize_nocount, row_tile
from repro_torch.core.recipes import Recipe
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                      # per-expert hidden (F); w13 is (K, 2F)
    capacity_factor: float = 1.25
    act: str = "swiglu"


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# Routing (f32).
# ---------------------------------------------------------------------------
def router_topk(x, w_router, top_k: int):
    """Returns (probs (T,k) f32, ids (T,k) int64, aux_loss scalar)."""
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    probs_full = torch.softmax(logits, dim=-1)                  # (T, E)
    p, ids = torch.topk(probs_full, top_k, dim=-1)              # (T, k)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-9)
    E = w_router.shape[-1]
    me = probs_full.mean(0)
    ce = torch.nn.functional.one_hot(ids[:, 0], E).to(torch.float32).mean(0)
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    return p, ids, lb_loss + 1e-3 * z_loss


# ---------------------------------------------------------------------------
# Static routing plans (integer-only: argsort + searchsorted + scatter).
# ---------------------------------------------------------------------------
def _scatter_map(n: int, slot, values):
    """(n+1,) int32 filled with -1, values scattered at slot, scratch slot
    n dropped."""
    out = torch.full((n + 1,), -1, dtype=torch.int64, device=slot.device)
    return out.scatter_(0, slot, values)[:-1].to(torch.int32)


def _group_positions(keys):
    """Stable sort of keys, and each element's position inside its group."""
    order = torch.argsort(keys, stable=True)
    sorted_keys = keys[order].contiguous()
    ar = torch.arange(keys.shape[0], device=keys.device)
    return order, sorted_keys, ar - torch.searchsorted(sorted_keys, sorted_keys)


def _dispatch_plan(ids, top_k: int, EP: int, E_loc: int, C_send: int):
    """ids (T, k) global expert ids -> (row_map_send, slot_expert,
    slot_assign, drop_frac) over EP*C_send send slots (-1 = pad)."""
    T = ids.shape[0]
    A = T * top_k
    flat_ids = ids.reshape(A).to(torch.int64)
    dest = flat_ids // E_loc
    order, sorted_dest, pos_all = _group_positions(dest)
    keep = pos_all < C_send
    n_slots = EP * C_send
    slot = torch.where(keep, sorted_dest * C_send + pos_all, n_slots)
    row_map_send = _scatter_map(n_slots, slot, order // top_k)
    slot_expert = _scatter_map(n_slots, slot, flat_ids[order] % E_loc)
    slot_assign = _scatter_map(n_slots, slot, order)
    drop_frac = 1.0 - keep.to(torch.float32).sum() / A
    return row_map_send, slot_expert, slot_assign, drop_frac


def _expert_plan(recv_expert, E_loc: int, C_exp: int):
    """recv_expert (R,) local expert id per received row (-1 invalid) ->
    row_map_exp (E_loc*C_exp,) source row per expert slot (-1 pad) and
    ret_map (R,) expert slot per row (-1 dropped)."""
    R = recv_expert.shape[0]
    re = recv_expert.to(torch.int64)
    e = torch.where(re >= 0, re, E_loc)          # invalid -> bucket E_loc
    order, sorted_e, pos = _group_positions(e)
    keep = (pos < C_exp) & (sorted_e < E_loc)
    slot = torch.where(keep, sorted_e * C_exp + pos, E_loc * C_exp)
    row_map_exp = _scatter_map(E_loc * C_exp, slot, order)
    ret_map = _scatter_map(R, torch.where(keep, order, R),
                           torch.where(keep, slot, -1))
    return row_map_exp, ret_map


def _expert_loads(row_map_exp, E_loc: int, C_exp: int):
    """Per-expert live-row counts from the expert plan: the ``masked_m``
    vector of the masked grouped-GEMM layout, computed on the device (no
    host read).  _expert_plan fills each expert's slots contiguously from
    0, so the count IS the live prefix length (rows >= count are the
    zero-padded dead slots)."""
    return (row_map_exp.reshape(E_loc, C_exp) >= 0).sum(
        dim=1, dtype=torch.int32)


def _masked_m_or_none(recipe: Recipe, row_map_exp, E_loc: int, C_exp: int):
    """masked_m for the grouped FFN when the recipe opts in (fp8_flow only:
    the masked kernels live on the FP8 pathway), else None."""
    if recipe.masked_experts and recipe.name == "fp8_flow":
        return _expert_loads(row_map_exp, E_loc, C_exp)
    return None


def _take_rows(x, row_map, fill=0.0):
    valid = (row_map >= 0)[:, None]
    rows = x[torch.clamp(row_map, min=0).to(torch.int64)]
    return torch.where(valid, rows, torch.tensor(fill, dtype=x.dtype,
                                                 device=x.device))


def _segment_sum(rows, seg, n: int):
    """f32 sum of rows into n segments (seg == n drops the row), each
    segment's rows added in row order, so a step gives the same bits in
    every run.  The CPU's index_add_ adds serially.  On the card index_add_
    adds with atomics, whose order changes from run to run, so there
    index_put_ with accumulate (a stable sort of the indices, then ordered
    adds) takes its place, each dropped row sent to a scratch row of its
    own: in one shared row they would be added one after another."""
    R, D = rows.shape
    seg, rows = seg.to(torch.int64), rows.to(torch.float32)
    if not rows.is_cuda:
        out = torch.zeros((n + 1, D), dtype=torch.float32)
        return out.index_add_(0, seg, rows)[:n]
    out = torch.zeros((n + R, D), dtype=torch.float32, device=rows.device)
    idx = torch.where(seg < n, seg, n + torch.arange(R, device=rows.device))
    return out.index_put_((idx,), rows, accumulate=True)[:n]


# ---------------------------------------------------------------------------
# QTensor permute and the dispatch boundary, each with its explicit VJP.
# ---------------------------------------------------------------------------
class _PermuteQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, scale, row_map, inv_map):
        ctx.save_for_backward(inv_map)
        q = ops.fused_permute_pad(QTensor(data, scale, row_tile(2)), row_map)
        return q.data, q.scale

    @staticmethod
    def backward(ctx, gd, gs):
        (inv_map,) = ctx.saved_tensors
        q = ops.fused_permute_pad(QTensor(gd, gs, row_tile(2)), inv_map)
        return q.data, q.scale, None, None


def permute_q(recipe: Recipe, q: QTensor, row_map, inv_map) -> QTensor:
    """Gather the rows of a 2-D row-tiled QTensor by row_map (fused
    permute+pad kernel).  row_map must be injective on valid slots; the
    backward gathers the FP8 cotangent by inv_map -- FP8 gradients route
    without any dequantization."""
    data, scale = _PermuteQ.apply(q.data, q.scale, row_map, inv_map)
    return QTensor(data, scale, q.tile)


class _DispatchQuantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, row_map):
        ctx.ledger = casts.current()
        ctx.save_for_backward(row_map)
        ctx.T, ctx.x_dtype = x.shape[0], x.dtype
        casts.record("quantize", "q_entry", x.numel())
        q = ops.fused_permute_pad(ops.quantize_rowwise(x), row_map)
        return q.data, q.scale

    @staticmethod
    def backward(ctx, gd, gs):
        (row_map,) = ctx.saved_tensors
        with casts.use(ctx.ledger):
            casts.record("fused_dequantize", "dispatch_bwd", gd.numel())
        g_rows = _dequantize_nocount(QTensor(gd, gs, row_tile(2)),
                                     torch.bfloat16)
        seg = torch.where(row_map >= 0, row_map, ctx.T)
        return _segment_sum(g_rows, seg, ctx.T).to(ctx.x_dtype), None


def dispatch_quantize(recipe: Recipe, x, row_map) -> QTensor:
    """fp8_flow entry: ONE explicit quantize (the paper's entry cast), then
    the fused permute+pad into the padded send layout.  Backward: the FP8
    gradient rows are dequantized inside the consuming segment sum (fused)
    and summed per source token (the top-k reduction, kept in f32/bf16 by
    design)."""
    data, scale = _DispatchQuantize.apply(x, row_map)
    return QTensor(data, scale, row_tile(2))


class _FP8DispatchNaive(torch.autograd.Function):
    @staticmethod
    def forward(ctx, recipe, x, row_map):
        ctx.save_for_backward(row_map)
        ctx.T, ctx.x_dtype = x.shape[0], x.dtype
        casts.record("quantize", "q_entry", x.numel())
        q = ops.fused_permute_pad(ops.quantize_rowwise(x, recipe.scale_mode),
                                  row_map)
        return dequantize_exit(recipe, q)

    @staticmethod
    def backward(ctx, g):
        (row_map,) = ctx.saved_tensors
        seg = torch.where(row_map >= 0, row_map, ctx.T)
        return None, _segment_sum(g.to(torch.bfloat16), seg,
                                  ctx.T).to(ctx.x_dtype), None


def fp8_dispatch_naive(recipe: Recipe, x, row_map) -> torch.Tensor:
    """naive_fp8 (Fig. 2c): quantize -> permute+pad -> (the FP8 send, an
    identity at EP = 1) -> dequantize, two explicit casts (``q_entry``,
    ``dq_post_dispatch``): the Q/DQ-around-comm pair of Table 1.  The
    backward stays bf16 (DeepSeek keeps the backward comm in BF16): the
    gradient rows summed per source token in f32."""
    return _FP8DispatchNaive.apply(recipe, x, row_map)


# ---------------------------------------------------------------------------
# The prefill MoE block.
# ---------------------------------------------------------------------------
def moe_block(recipe: Recipe, cfg: MoEConfig, x, w_router, w13, w2):
    """x (T, D) tokens; w13 (E, D, 2F), w2 (E, F, D) (QTensors when W8
    resident).  Returns (y (T, D), metrics)."""
    T, D = x.shape
    EP = 1
    E_loc = cfg.n_experts // EP
    k = cfg.top_k
    C_send = _round_up(max(int(T * k / EP * cfg.capacity_factor), 8), 8)
    R = EP * C_send
    # the FP8 recipes need 128-row expert groups (transpose blocks and
    # GEMM tiles); bf16 only the reference's sublane alignment
    C_exp = _round_up(max(R // E_loc, 8), 128 if recipe.is_fp8 else 8)

    p, ids, aux = router_topk(x, w_router, k)
    row_map_send, slot_expert, slot_assign, drop_frac = _dispatch_plan(
        ids, k, EP, E_loc, C_send)

    if recipe.name == "fp8_flow":
        recv_in = dispatch_quantize(recipe, x, row_map_send)
    elif recipe.name == "naive_fp8":
        recv_in = fp8_dispatch_naive(recipe, x, row_map_send)
    else:                                   # bf16 / blockwise: bf16 rows
        recv_in = _take_rows(x.to(torch.bfloat16), row_map_send)
    p_flat = torch.where(slot_assign >= 0,
                         p.reshape(-1)[torch.clamp(slot_assign, min=0).long()],
                         0.0)

    row_map_exp, ret_map = _expert_plan(slot_expert, E_loc, C_exp)
    if recipe.name == "fp8_flow":
        q_exp = permute_q(recipe, recv_in, row_map_exp, ret_map)
        ffn_in = QTensor(q_exp.data.reshape(E_loc, C_exp, D),
                         q_exp.scale.reshape(E_loc, C_exp, D // TILE),
                         (1, 1, TILE))
    else:
        ffn_in = _take_rows(recv_in, row_map_exp).reshape(E_loc, C_exp, D)
    masked_m = _masked_m_or_none(recipe, row_map_exp, E_loc, C_exp)
    y_exp = expert_ffn(recipe, cfg.act, ffn_in, w13, w2, masked_m)

    p_exp = _take_rows(p_flat[:, None], row_map_exp).reshape(E_loc, C_exp)
    y_exp = y_exp * p_exp[..., None].to(y_exp.dtype)
    y_ret = _take_rows(y_exp.reshape(E_loc * C_exp, D), ret_map)
    seg = torch.where(row_map_send >= 0, row_map_send, T)
    y = _segment_sum(y_ret, seg, T)
    return y.to(x.dtype), {"aux_loss": aux, "drop_frac": drop_frac}


# ---------------------------------------------------------------------------
# The decode MoE block as its three stages (router -> dispatch -> expert;
# the combine psum of the reference is an identity at EP = 1).
# ---------------------------------------------------------------------------
# The reference cannot decode blockwise or naive_fp8: its decode router
# hands the FFN a QTensor for every FP8 recipe (repro/core/moe.py:433-438),
# whose blockwise / naive_fp8 forward quantizes its input again
# (repro/core/linear.py:258, :270) and fails on the QTensor.  The port has
# no reference to hold such a path to, so it refuses it.
DECODE_RECIPES = ("bf16", "fp8_flow")


def check_decode_recipe(recipe: Recipe) -> None:
    if recipe.name not in DECODE_RECIPES:
        raise NotImplementedError(
            f"serving {recipe.name!r} is not ported: the reference cannot "
            "decode it either (its decode router hands the FFN a QTensor, "
            "repro/core/moe.py:433-438, which the blockwise / naive_fp8 "
            "forward quantizes again, repro/core/linear.py:258/270: "
            "AttributeError; ROADMAP.md, Queue 3)")


def decode_stage_router(recipe: Recipe, cfg: MoEConfig, x, w_router, r: int,
                        E_loc: int):
    """Top-k routing, the local-assignment map and the block's ONE entry
    quantize (fp8_flow; bf16 keeps the bf16 rows)."""
    check_decode_recipe(recipe)
    p, ids, aux = router_topk(x, w_router, cfg.top_k)
    local = (ids // E_loc) == r
    local_e = torch.where(local, ids % E_loc, -1).reshape(-1)
    xq = quantize_entry(recipe, x) if recipe.is_fp8 else x.to(torch.bfloat16)
    return p, aux, local_e, xq


def decode_stage_dispatch(recipe: Recipe, cfg: MoEConfig, xq,
                          local_e_c, tok0: int, E_loc: int, C_dec: int):
    """Expert-slot plan + the gather into the (E_loc, C_dec, D) grouped
    layout (FP8: the fused permute+pad kernel, payload 0 / scale 1.0
    padding; bf16: zero rows)."""
    D = cfg.d_model
    row_map_exp, _ = _expert_plan(local_e_c, E_loc, C_dec)
    tok_loc = torch.where(row_map_exp >= 0, row_map_exp // cfg.top_k, -1)
    tok_glob = torch.where(tok_loc >= 0, tok_loc + tok0, -1)
    if isinstance(xq, QTensor):
        q = ops.fused_permute_pad(xq, tok_glob)
        ffn_in = QTensor(q.data.reshape(E_loc, C_dec, D),
                         q.scale.reshape(E_loc, C_dec, D // TILE),
                         (1, 1, TILE))
    else:
        ffn_in = _take_rows(xq, tok_glob).reshape(E_loc, C_dec, D)
    n_valid = (local_e_c >= 0).to(torch.float32).sum()
    n_kept = (row_map_exp >= 0).to(torch.float32).sum()
    return ffn_in, row_map_exp, tok_loc, n_valid, n_kept


def decode_stage_expert(recipe: Recipe, cfg: MoEConfig, ffn_in, w13,
                        w2, p_c, row_map_exp, tok_loc, Tc: int):
    """Grouped FFN + prob weighting + the per-token segment sum (f32)."""
    D = cfg.d_model
    grouped = ffn_in.data if isinstance(ffn_in, QTensor) else ffn_in
    E_loc, C_dec = grouped.shape[0], grouped.shape[1]
    masked_m = _masked_m_or_none(recipe, row_map_exp, E_loc, C_dec)
    y_exp = expert_ffn(recipe, cfg.act, ffn_in, w13, w2, masked_m)
    p_of_slot = torch.where(
        row_map_exp >= 0,
        p_c.reshape(-1)[torch.clamp(row_map_exp, min=0).long()], 0.0)
    y_exp = y_exp * p_of_slot.reshape(E_loc, C_dec)[..., None].to(y_exp.dtype)
    seg = torch.where(tok_loc >= 0, tok_loc, Tc)
    return _segment_sum(y_exp.reshape(E_loc * C_dec, D), seg, Tc)


def moe_block_decode(recipe: Recipe, cfg: MoEConfig, x, w_router, w13, w2):
    """Decode-time MoE over a small batch (the reference's staged program
    at pipeline depth 1, one EP rank)."""
    T, D = x.shape
    E_loc = cfg.n_experts
    k = cfg.top_k
    C_dec = _round_up(max(int(2.0 * T * k / cfg.n_experts), 8), 8)
    p, aux, local_e, xq = decode_stage_router(recipe, cfg, x, w_router, 0,
                                              E_loc)
    ffn_in, rme, tok_loc, n_valid, n_kept = decode_stage_dispatch(
        recipe, cfg, xq, local_e, 0, E_loc, C_dec)
    y = decode_stage_expert(recipe, cfg, ffn_in, w13, w2, p, rme, tok_loc, T)
    drop_frac = (n_valid - n_kept) / (T * k)
    return y.to(x.dtype), {"aux_loss": aux, "drop_frac": drop_frac}
