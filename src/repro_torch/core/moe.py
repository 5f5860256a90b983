"""The MoE block: router -> dispatch (all-to-all) -> expert grouping ->
grouped expert FFN -> combine (all-to-all), forward and backward, for
every recipe, at any expert-parallel size.

Counterpart of ``repro.core.moe``'s EP blocks.  ``MoEConfig.ep_group``
(a ``torch.distributed`` group: the mesh's ``model`` axis) holds the EP
ranks; each holds E_loc = E / EP experts (the leading axis of w13 / w2)
and its own T tokens.  Every all-to-all of the reference
(``jax.lax.all_to_all(split_axis=0, concat_axis=0)``, its ``:232-241``)
is ``dist/comm.all_to_all`` over a contiguous (EP * C, ...) tensor, and
the decode combine's psum an all-reduce.  With no group (EP = 1, no
mesh) each is the identity, as the reference's are with no expert axis;
with a group, even of one rank, each launches.  The routing plans, the
capacities (C_send and C_exp, the reference's ``:276-283``) and the drop
rules are kept bit for bit, because they decide which assignments drop
(the 128-row rounding of C_exp is part of that).  The plans use stable
argsorts, and their scatters hit duplicate indices only on the scratch
slot that is sliced off, as in the reference.

An all-to-all with a gradient sits in ``_AllToAll``, whose backward is
the same all-to-all of the cotangents (with equal blocks it is its own
inverse): fp8_flow's dispatch sends the e4m3 payload and its scales both
ways, so the input gradient crosses back as e4m3 plus scales; the bf16
rows, the router probabilities and the combine carry bf16 / f32
cotangents.  The expert weights' gradients stay local sums: the train
step sums them over the ``data`` axis (the reference's ``dp_axes`` Wgrad
psum).

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

``moe_block_tp`` is the reference's TP-sharded block (E < tp): every
rank holds every expert's F-slice and the model group's tokens, the
combine is an all-reduce or a reduce-scatter and no all-to-all runs.

Each block names its stages with the reference's profiler ranges
(``obs/trace.py``: router, dispatch, expert, combine).  The decode block
is the reference's staged pipeline; ``moe_block_overlapped`` and
``moe_block_decode_overlapped`` chunk the block by a ``DispatchPlan``, the
dispatch of a chunk packed into one uint8 message (the section at the end
of this module).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import casts
from repro_torch.core.fp8 import TILE
from repro_torch.core.linear import (_q_row, _quant_weights, _save_q,
                                     _saved_q, dequantize_exit, expert_ffn,
                                     ffn_bwd_fp8_core, ffn_fwd_fp8_core,
                                     quantize_entry)
from repro_torch.core.quant import (QTensor, _dequantize_nocount,
                                    record_entry_stats, row_tile)
from repro_torch.core.recipes import Recipe
from repro_torch.dist import comm
from repro_torch.kernels import ops
from repro_torch.obs.trace import stage_annotation
from repro_torch.runtime import fault_injection


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                      # per-expert hidden (F); w13 is (K, 2F)
    capacity_factor: float = 1.25
    act: str = "swiglu"
    # the expert-parallel group (the mesh's 'model' axis); None = EP 1
    ep_group: object = dataclasses.field(default=None, compare=False)


def _ep(cfg: MoEConfig, w13=None):
    """(group, EP, this rank's index in it, E_loc); checks that E splits
    evenly and that the resident expert weights hold E_loc experts."""
    group = cfg.ep_group
    EP = comm.size(group)
    E_loc = cfg.n_experts // EP
    if E_loc * EP != cfg.n_experts:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"{EP} expert-parallel ranks")
    if w13 is not None:
        held = (w13.data if isinstance(w13, QTensor) else w13).shape[0]
        if held != E_loc:
            raise ValueError(f"w13 holds {held} experts; EP = {EP} needs "
                             f"E_loc = {E_loc}")
    return group, EP, comm.rank(group), E_loc


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


def _slot_probs(p, slot_assign):
    """Each send slot's router prob (0 on an empty slot)."""
    return torch.where(slot_assign >= 0,
                       p.reshape(-1)[torch.clamp(slot_assign, min=0).long()],
                       0.0)


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
# The all-to-all with its VJP.
# ---------------------------------------------------------------------------
class _AllToAll(torch.autograd.Function):
    """All-to-all of one or more tensors over a group; the backward sends
    the cotangents the same way back (an e4m3 cotangent as its bytes)."""

    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        outs = tuple(comm.all_to_all(t, group) for t in ts)
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(None if g is None
                               else comm.all_to_all(g, ctx.group)
                               for g in gs)


def a2a(t, group):
    """Differentiable all-to-all of t (the identity with no group)."""
    return t if group is None else _AllToAll.apply(group, t)


def a2a_q(q: QTensor, group) -> QTensor:
    """A QTensor's payload and scales through the differentiable
    all-to-all (two collectives, as the reference's two)."""
    if group is None:
        return q
    data, scale = _AllToAll.apply(group, q.data, q.scale)
    return QTensor(data, scale, q.tile)


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
        x = fault_injection.apply("activation", "q_entry", x)
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
    def forward(ctx, recipe, x, row_map, group):
        ctx.save_for_backward(row_map)
        ctx.T, ctx.x_dtype, ctx.group = x.shape[0], x.dtype, group
        casts.record("quantize", "q_entry", x.numel())
        x = fault_injection.apply("activation", "q_entry", x)
        q = ops.fused_permute_pad(ops.quantize_rowwise(x, recipe.scale_mode),
                                  row_map)
        q = QTensor(comm.all_to_all(q.data, group),
                    comm.all_to_all(q.scale, group), q.tile)
        return dequantize_exit(recipe, q)

    @staticmethod
    def backward(ctx, g):
        (row_map,) = ctx.saved_tensors
        g = comm.all_to_all(g.to(torch.bfloat16), ctx.group)  # bf16 comm
        seg = torch.where(row_map >= 0, row_map, ctx.T)
        return None, _segment_sum(g, seg, ctx.T).to(ctx.x_dtype), None, None


def fp8_dispatch_naive(recipe: Recipe, x, row_map, group=None
                       ) -> torch.Tensor:
    """naive_fp8 (Fig. 2c): quantize -> permute+pad -> the FP8 all-to-all
    (payload and scales) -> dequantize, two explicit casts (``q_entry``,
    ``dq_post_dispatch``): the Q/DQ-around-comm pair of Table 1.  The
    backward stays bf16 (DeepSeek keeps the backward comm in BF16): a bf16
    all-to-all, then the gradient rows summed per source token in f32."""
    return _FP8DispatchNaive.apply(recipe, x, row_map, group)


# ---------------------------------------------------------------------------
# The prefill MoE block.
# ---------------------------------------------------------------------------
def moe_block(recipe: Recipe, cfg: MoEConfig, x, w_router, w13, w2):
    """x (T, D) this rank's tokens; w13 (E_loc, D, 2F), w2 (E_loc, F, D)
    this rank's experts (QTensors when W8 resident); w_router (D, E)
    replicated.  Returns (y (T, D), metrics)."""
    T, D = x.shape
    group, EP, _, E_loc = _ep(cfg, w13)
    k = cfg.top_k
    C_send = _round_up(max(int(T * k / EP * cfg.capacity_factor), 8), 8)
    R = EP * C_send
    # the FP8 recipes need 128-row expert groups (transpose blocks and
    # GEMM tiles); bf16 only the reference's sublane alignment
    C_exp = _round_up(max(R // E_loc, 8), 128 if recipe.is_fp8 else 8)

    with stage_annotation("router"):
        p, ids, aux = router_topk(x, w_router, k)
        row_map_send, slot_expert, slot_assign, drop_frac = _dispatch_plan(
            ids, k, EP, E_loc, C_send)

    with stage_annotation("dispatch"):
        if recipe.name == "fp8_flow":
            recv_in = a2a_q(dispatch_quantize(recipe, x, row_map_send),
                            group)
            record_entry_stats("q_entry_moe", x, scale_mode=recipe.scale_mode)
        elif recipe.name == "naive_fp8":
            recv_in = fp8_dispatch_naive(recipe, x, row_map_send, group)
        else:                               # bf16 / blockwise: bf16 rows
            recv_in = a2a(_take_rows(x.to(torch.bfloat16), row_map_send),
                          group)
        # the expert ids and the probabilities ride all-to-alls of their
        # own, as in the reference
        recv_expert = comm.all_to_all(slot_expert, group)
        p_flat = a2a(_slot_probs(p, slot_assign), group)

    with stage_annotation("expert"):
        row_map_exp, ret_map = _expert_plan(recv_expert, E_loc, C_exp)
        if recipe.name == "fp8_flow":
            q_exp = permute_q(recipe, recv_in, row_map_exp, ret_map)
            ffn_in = QTensor(q_exp.data.reshape(E_loc, C_exp, D),
                             q_exp.scale.reshape(E_loc, C_exp, D // TILE),
                             (1, 1, TILE))
        else:
            ffn_in = _take_rows(recv_in, row_map_exp).reshape(E_loc, C_exp,
                                                              D)
        masked_m = _masked_m_or_none(recipe, row_map_exp, E_loc, C_exp)
        y_exp = expert_ffn(recipe, cfg.act, ffn_in, w13, w2, masked_m,
                           out_tag="stage_expert_out")
        p_exp = _take_rows(p_flat[:, None], row_map_exp).reshape(E_loc,
                                                                 C_exp)
        y_exp = y_exp * p_exp[..., None].to(y_exp.dtype)

    with stage_annotation("combine"):
        y_back = a2a(_take_rows(y_exp.reshape(E_loc * C_exp, D), ret_map),
                     group)
        seg = torch.where(row_map_send >= 0, row_map_send, T)
        y = _segment_sum(y_back, seg, T)
    return y.to(x.dtype), {"aux_loss": aux, "drop_frac": drop_frac}


def moe_block_tp(recipe: Recipe, cfg: MoEConfig, x, w_router, w13, w2,
                 tp_group=None, combine_mode: str = "local_first"):
    """TP-sharded experts (the reference's ``moe_block_tp``,
    ``repro/core/moe.py:348-414``; E < tp, e.g. grok-1's 8 experts on a
    16-wide model axis): every rank holds ALL experts with their d_ff
    sliced over `tp_group`, w13 (E, D, 2F_loc) and w2 (E, F_loc, D), and
    the same tokens x (T, D) (``models/lm._moe_stage`` gathers them).  No
    dispatch all-to-all: tokens are grouped locally into E groups of the
    reference's C_exp (``T * k / E * cf`` rounded up to 128 for the FP8
    recipes), each rank runs its F-slice of the grouped FFN, and the
    partial sums reduce over the group.  The input gradient's partial sum
    is all-reduced inside the FFN's backward (``gx_groups``): fp8_flow's
    Dgrad-1 runs #3 and #1 there instead of #4.

    combine_mode (the reference's):
      'psum_first'      all-reduce the (E, C_exp, D) expert outputs, then
                        weight and combine them locally;
      'local_first'     weight and combine the rows into (T, D) first, then
                        all-reduce the token rows in bf16 (top_k * cf
                        times fewer bytes);
      'reduce_scatter'  local_first with a reduce-scatter: this rank's
                        T / tp rows of the sum (the caller's own rows).
    The router, the probabilities and the aux loss are the same on every
    rank; under the last two combines the probabilities' cotangent is a
    partial sum and is all-reduced (``dist/tp.sum_grad``).  The combine's
    all-reduce has an identity backward: the caller's cotangent is the
    same on every rank (``dist/tp.py``).  Returns (y, metrics)."""
    from repro_torch.dist import tp
    if combine_mode not in ("psum_first", "local_first", "reduce_scatter"):
        raise ValueError(f"unknown combine_mode {combine_mode!r}")
    T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    held = (w13.data if isinstance(w13, QTensor) else w13).shape[0]
    if held != E:
        raise ValueError(f"moe_block_tp: w13 holds {held} experts; TP "
                         f"holds all {E}")
    C_exp = _round_up(max(int(T * k / E * cfg.capacity_factor), 8),
                      128 if recipe.is_fp8 else 8)

    with stage_annotation("router"):
        p, ids, aux = router_topk(x, w_router, k)
        # local grouping: one send group (EP = 1) of E * C_exp slots
        row_map, slot_expert, slot_assign, drop_frac = _dispatch_plan(
            ids, k, 1, E, E * C_exp)

    with stage_annotation("dispatch"):
        row_map_exp, _ = _expert_plan(slot_expert, E, C_exp)
        # expert slot -> send slot -> token row
        tok_of_slot = torch.where(
            row_map_exp >= 0,
            row_map[torch.clamp(row_map_exp, min=0).long()], -1)
        if recipe.name == "fp8_flow":
            q_exp = dispatch_quantize(recipe, x, tok_of_slot)
            record_entry_stats("q_entry_moe", x, scale_mode=recipe.scale_mode)
            ffn_in = QTensor(q_exp.data.reshape(E, C_exp, D),
                             q_exp.scale.reshape(E, C_exp, D // TILE),
                             (1, 1, TILE))
        else:
            ffn_in = _take_rows(x.to(torch.bfloat16),
                                tok_of_slot).reshape(E, C_exp, D)

    with stage_annotation("expert"):
        masked_m = _masked_m_or_none(recipe, row_map_exp, E, C_exp)
        y_exp = expert_ffn(recipe, cfg.act, ffn_in, w13, w2, masked_m,
                           out_tag="stage_expert_out",
                           gx_groups=(tp_group,))       # F-sliced partial

    with stage_annotation("combine"):
        if combine_mode == "psum_first":
            y_exp = tp.all_reduce_sum(y_exp, tp_group)
        p_exp = _take_rows(_slot_probs(p, slot_assign)[:, None],
                           row_map_exp).reshape(E, C_exp)
        if combine_mode != "psum_first":
            p_exp = tp.sum_grad(p_exp, tp_group)
        y_exp = y_exp * p_exp[..., None].to(y_exp.dtype)
        seg = torch.where(tok_of_slot >= 0, tok_of_slot, T)
        y = _segment_sum(y_exp.reshape(E * C_exp, D), seg, T)
        if combine_mode == "local_first":
            y = tp.all_reduce_sum(y.to(torch.bfloat16), tp_group)
        elif combine_mode == "reduce_scatter":
            y = tp.reduce_scatter_rows(y.to(torch.bfloat16), tp_group)
    return y.to(x.dtype), {"aux_loss": aux, "drop_frac": drop_frac}


# ---------------------------------------------------------------------------
# The decode MoE block as its stages (router -> dispatch -> expert ->
# combine).  The batch is replicated over the EP ranks; each computes its
# resident experts' assignments and the combine is an all-reduce (the
# reference's psum over ep_axis).
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


def _decode_pipeline(recipe: Recipe, cfg: MoEConfig, x, w_router, w13, w2,
                     n_chunks: int):
    """The staged decode program at pipeline depth n_chunks (the
    reference's ``_decode_pipeline``): the router and the entry quantize
    over the whole batch, then each chunk's dispatch and expert stages;
    chunk c's combine all-reduce is issued as soon as its partial exists
    and is in flight while chunk c+1 computes.  The drop count is summed
    over the EP ranks against the global T * k."""
    T, D = x.shape
    group, EP, r, E_loc = _ep(cfg, w13)
    k = cfg.top_k
    n = DispatchPlan(decode_chunks=n_chunks,
                     min_decode_tokens=1).decode_chunks_for(T)
    Tc = T // n
    C_dec = _round_up(max(int(2.0 * Tc * k / cfg.n_experts), 8), 8)

    with stage_annotation("router"):
        p, aux, local_e, xq = decode_stage_router(recipe, cfg, x, w_router,
                                                  r, E_loc)
    pend, drops = [], None
    for c in range(n):
        with stage_annotation("dispatch"):
            ffn_in, rme, tok_loc, nv, nk = decode_stage_dispatch(
                recipe, cfg, xq, local_e[c * Tc * k:(c + 1) * Tc * k],
                c * Tc, E_loc, C_dec)
        with stage_annotation("expert"):
            y_loc = decode_stage_expert(recipe, cfg, ffn_in, w13, w2,
                                        p[c * Tc:(c + 1) * Tc], rme, tok_loc,
                                        Tc)
        with stage_annotation("combine"):
            pend.append(comm.all_reduce_async(y_loc, group))
        drops = nv - nk if drops is None else drops + (nv - nk)
    with stage_annotation("combine"):
        ys = [h.wait() for h in pend]
        y = torch.cat(ys, dim=0) if n > 1 else ys[0]
        drops = comm.all_reduce_(drops.reshape(1).clone(), group)[0]
    drop_frac = drops / (T * k)
    return y.to(x.dtype), {"aux_loss": aux, "drop_frac": drop_frac}


def moe_block_decode(recipe: Recipe, cfg: MoEConfig, x, w_router, w13, w2):
    """Decode-time MoE over a small batch, replicated over the EP ranks:
    the staged pipeline at depth 1 (one synchronous combine)."""
    return _decode_pipeline(recipe, cfg, x, w_router, w13, w2, n_chunks=1)


def moe_block_decode_overlapped(recipe: Recipe, cfg: MoEConfig, x, w_router,
                                w13, w2, n_chunks: int = 2):
    """The decode pipeline at depth n_chunks (clamped to a divisor of T).
    Per-token math is moe_block_decode's when no capacity drops occur:
    C_dec is per chunk, so drop SETS can differ under overflow."""
    return _decode_pipeline(recipe, cfg, x, w_router, w13, w2,
                            n_chunks=n_chunks)


# ---------------------------------------------------------------------------
# The chunked (overlapped) dispatch pipeline.
#
# The reference's moe_block_overlapped splits the token block into n_chunks
# and software-pipelines them: chunk c+1's fused dispatch message is issued
# before chunk c's grouped FFN, so its all-to-all hides behind compute.
# fp8_flow's pipeline sends each chunk's one uint8 message (payload,
# scales, expert ids, probabilities) with async_op=True and waits on it
# only where it is unpacked; each chunk's combine is in flight while the
# next chunk's FFN runs, and lands one chunk later; the backward's fused
# reverse messages likewise.  Waiting before a read keeps the results
# those of the synchronous all-to-alls, bit for bit.
#
# Quantization stays block-level: ONE entry quantize over the whole block
# (chunks gather its rows: row-tile scales are row-local) and ONE backward
# island quantize over every chunk's FFN-output cotangent, so fp8_flow
# keeps its 2 explicit casts at any n_chunks.  Numerics match moe_block up
# to f32 summation order PROVIDED no capacity drops occur: C_send and C_exp
# are per chunk, so drop SETS can differ from the monolithic block's.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Static overlap configuration (the reference's, threaded through
    ``models/lm.py`` as ``moe_overlap``).

    n_chunks          pipeline depth per MoE layer (1 = fused message only)
    min_chunk_tokens  never chunk below this many tokens per chunk
    decode_chunks     pipeline depth of the decode MoE
    min_decode_tokens decode batches are small: no pipeline below this
    """
    n_chunks: int = 2
    min_chunk_tokens: int = 64
    decode_chunks: int = 2
    min_decode_tokens: int = 8

    def chunks_for(self, T: int) -> int:
        cap = max(1, min(self.n_chunks, T // max(self.min_chunk_tokens, 1)))
        return max(d for d in range(1, cap + 1) if T % d == 0)

    def decode_chunks_for(self, T: int) -> int:
        cap = max(1, min(self.decode_chunks,
                         T // max(self.min_decode_tokens, 1)))
        return max(d for d in range(1, cap + 1) if T % d == 0)


def _u8(t):
    """The bytes of t as (R, w) uint8 (a view of the same bits, no cast):
    the trailing axes flattened, little-endian, as the reference's
    bitcast gives them."""
    t = t.contiguous()
    return t.view(torch.uint8).reshape(t.shape[0], -1)


def _from_u8(u, dtype, shape):
    """(R, w) uint8 columns -> a contiguous tensor of dtype and shape (a
    view of the bits)."""
    return u.contiguous().view(dtype).reshape(shape)


def _pack_dispatch_msg(d, s, se, pf):
    """One chunk's dispatch as a single uint8 message: d (R, D) e4m3
    payload | s (R, D/TILE) f32 scales | se (R,) int32 local expert ids |
    pf (R,) f32 router probs.  Width D + 4*D/TILE + 8 bytes a row."""
    return torch.cat([_u8(d), _u8(s), _u8(se.to(torch.int32)[:, None]),
                      _u8(pf.to(torch.float32)[:, None])], dim=1)


def _unpack_dispatch_msg(msg, D: int):
    R, Ds = msg.shape[0], D // TILE
    d = _from_u8(msg[:, :D], torch.float8_e4m3fn, (R, D))
    o = D
    s = _from_u8(msg[:, o:o + 4 * Ds], torch.float32, (R, Ds))
    o += 4 * Ds
    se = _from_u8(msg[:, o:o + 4], torch.int32, (R,))
    pf = _from_u8(msg[:, o + 4:o + 8], torch.float32, (R,))
    return d, s, se, pf


def _pack_bwd_msg(gd, gs, gp):
    """The backward's message: the FP8 input-gradient payload, its scales
    and the per-row router-prob gradient."""
    return torch.cat([_u8(gd), _u8(gs), _u8(gp.to(torch.float32)[:, None])],
                     dim=1)


def _unpack_bwd_msg(msg, D: int):
    R, Ds = msg.shape[0], D // TILE
    gd = _from_u8(msg[:, :D], torch.float8_e4m3fn, (R, D))
    gs = _from_u8(msg[:, D:D + 4 * Ds], torch.float32, (R, Ds))
    gp = _from_u8(msg[:, D + 4 * Ds:], torch.float32, (R,))
    return gd, gs, gp


def _chunk_geometry(recipe: Recipe, cfg: MoEConfig, T: int, n: int, EP: int,
                    E_loc: int):
    """(Tc, C_send, R, C_exp) of one chunk of T // n tokens: the
    monolithic block's capacities at the chunk's size, C_exp rounded up
    to 128 rows for the FP8 recipes (so a chunked FP8 block can hold more
    padded rows than the monolithic one)."""
    Tc = T // n
    k = cfg.top_k
    C_send = _round_up(max(int(Tc * k / EP * cfg.capacity_factor), 8), 8)
    R = EP * C_send
    C_exp = _round_up(max(R // E_loc, 8), 128 if recipe.is_fp8 else 8)
    return Tc, C_send, R, C_exp


def moe_block_overlapped(recipe: Recipe, cfg: MoEConfig, x, w_router, w13,
                         w2, n_chunks: int = 2):
    """moe_block with the chunked dispatch pipeline: the same signature and
    returns, plus n_chunks (clamped to a divisor of T).  fp8_flow runs the
    hand-written pipeline (``_OverlapFlow``; W8-resident weights its
    forward alone), the baselines chunks of their own autograd Functions."""
    T, D = x.shape
    n = DispatchPlan(n_chunks=n_chunks, min_chunk_tokens=1).chunks_for(T)
    with stage_annotation("router"):
        p, ids, aux = router_topk(x, w_router, cfg.top_k)
    if recipe.name == "fp8_flow":
        record_entry_stats("q_entry_moe", x, scale_mode=recipe.scale_mode)
        if isinstance(w13, QTensor) or isinstance(w2, QTensor):
            y, drop, _ = _flow_fwd(recipe, cfg, n, x, p, ids, w13, w2)
        else:
            y, drop = _OverlapFlow.apply(recipe, cfg, n, x, p, ids, w13, w2)
    else:
        y, drop = _overlap_chunks_autodiff(recipe, cfg, n, x, p, ids, w13,
                                           w2)
    return y, {"aux_loss": aux, "drop_frac": drop}


def _overlap_chunks_autodiff(recipe, cfg, n, x, p, ids, w13, w2):
    """bf16 / blockwise / naive_fp8: the chunks built from the block's own
    differentiable pieces, each keeping its recipe's casts at the dispatch
    boundary (for the baselines the per-chunk casts ARE the cost the
    paper counts)."""
    T, D = x.shape
    group, EP, _, E_loc = _ep(cfg, w13)
    k = cfg.top_k
    Tc, C_send, R, C_exp = _chunk_geometry(recipe, cfg, T, n, EP, E_loc)
    ys, drops = [], []
    for c in range(n):
        xc, pc = x[c * Tc:(c + 1) * Tc], p[c * Tc:(c + 1) * Tc]
        with stage_annotation("dispatch"):
            rms, se, sa, dc = _dispatch_plan(ids[c * Tc:(c + 1) * Tc], k, EP,
                                             E_loc, C_send)
            if recipe.name == "naive_fp8":
                recv_in = fp8_dispatch_naive(recipe, xc, rms, group)
            else:
                recv_in = a2a(_take_rows(xc.to(torch.bfloat16), rms), group)
            recv_expert = comm.all_to_all(se, group)
            recv_p = a2a(_slot_probs(pc, sa), group)
        with stage_annotation("expert"):
            rme, ret = _expert_plan(recv_expert, E_loc, C_exp)
            x_exp = _take_rows(recv_in, rme).reshape(E_loc, C_exp, D)
            y_exp = expert_ffn(recipe, cfg.act, x_exp, w13, w2,
                               out_tag="stage_expert_out")
            p_exp = _take_rows(recv_p[:, None], rme).reshape(E_loc, C_exp)
            y_exp = y_exp * p_exp[..., None].to(y_exp.dtype)
        with stage_annotation("combine"):
            y_back = a2a(_take_rows(y_exp.reshape(E_loc * C_exp, D), ret),
                         group)
            ys.append(_segment_sum(y_back, torch.where(rms >= 0, rms, Tc),
                                   Tc))
        drops.append(dc)
    y = torch.cat(ys, dim=0).to(x.dtype)
    return y, torch.stack(drops).mean()


def _flow_fwd(recipe, cfg, n, x, p, ids, w13, w2):
    """fp8_flow's forward pipeline (the reference's ``_flow_fwd_impl``).
    Returns (y, drop_frac, what the backward needs)."""
    T, D = x.shape
    group, EP, _, E_loc = _ep(cfg, w13)
    k = cfg.top_k
    Tc, C_send, R, C_exp = _chunk_geometry(recipe, cfg, T, n, EP, E_loc)
    qw13, qw2 = _quant_weights(recipe, w13, w2)

    with stage_annotation("dispatch"):
        # ONE entry quantize for the whole block (the counted forward
        # cast); each chunk gathers its rows
        casts.record("quantize", "q_entry", x.numel())
        q = ops.quantize_rowwise(
            fault_injection.apply("activation", "q_entry", x))
        plans = [_dispatch_plan(ids[c * Tc:(c + 1) * Tc], k, EP, E_loc,
                                C_send) for c in range(n)]

    def issue_dispatch(c):
        rms, se, sa, _ = plans[c]
        gmap = torch.where(rms >= 0, rms + c * Tc, -1)
        qs = ops.fused_permute_pad(q, gmap)
        pf = _slot_probs(p[c * Tc:(c + 1) * Tc], sa)
        return comm.all_to_all(
            _pack_dispatch_msg(qs.data, qs.scale, se, pf), group,
            async_op=True)

    ys, saved = [None] * n, []

    def land_combine(c, pending):
        rms = plans[c][0]
        ys[c] = _segment_sum(pending.wait(), torch.where(rms >= 0, rms, Tc),
                             Tc)

    with stage_annotation("dispatch"):
        recv = issue_dispatch(0)
    combine = None
    for c in range(n):
        with stage_annotation("dispatch"):
            # chunk c+1's message is in flight during chunk c's FFN
            nxt = issue_dispatch(c + 1) if c + 1 < n else None
            d_r, s_r, e_r, p_r = _unpack_dispatch_msg(recv.wait(), D)
        with stage_annotation("expert"):
            rme, ret = _expert_plan(e_r, E_loc, C_exp)
            qe = ops.fused_permute_pad(QTensor(d_r, s_r, row_tile(2)), rme)
            qx_c = QTensor(qe.data.reshape(E_loc, C_exp, D),
                           qe.scale.reshape(E_loc, C_exp, D // TILE),
                           (1, 1, TILE))
            mm_c = _masked_m_or_none(recipe, rme, E_loc, C_exp)
            y_exp, (qx_c, qa_c, h_c) = ffn_fwd_fp8_core(
                recipe, cfg.act, qx_c, qw13, qw2, mm_c,
                out_tag="stage_expert_out")
            p_exp = _take_rows(p_r[:, None], rme).reshape(E_loc, C_exp)
            y_w = y_exp * p_exp[..., None].to(y_exp.dtype)
        with stage_annotation("combine"):
            # chunk c's combine flies during chunk c+1's FFN; chunk c-1's
            # lands now
            pend = comm.all_to_all(
                _take_rows(y_w.reshape(E_loc * C_exp, D), ret), group,
                async_op=True)
            if combine is not None:
                land_combine(*combine)
            combine = (c, pend)
        saved.append((plans[c][0], plans[c][2], rme, ret, qx_c, qa_c, h_c,
                      p_exp, y_exp, mm_c))
        recv = nxt
    with stage_annotation("combine"):
        land_combine(*combine)
    y = torch.cat(ys, dim=0).to(x.dtype)
    drop = torch.stack([pl[3] for pl in plans]).mean()
    return y, drop, (saved, qw13, qw2)


class _OverlapFlow(torch.autograd.Function):
    """fp8_flow's overlapped core with the reference's hand-written
    backward pipeline (``_ocf_bwd``): a reverse combine a chunk (bf16),
    ONE island quantize over every chunk's cotangent, then a chunk at a
    time the FFN backward and the fused reverse message with the FP8
    input gradient and the prob gradient, landed one chunk later.  The
    ledger of the forward is re-entered in the backward (casts.py)."""

    @staticmethod
    def forward(ctx, recipe, cfg, n, x, p, ids, w13, w2):
        ctx.ledger = casts.current()
        y, drop, (saved, qw13, qw2) = _flow_fwd(recipe, cfg, n, x, p, ids,
                                                w13, w2)
        flat = [qw13, qw2]
        for sv in saved:
            flat += list(sv)
        _save_q(ctx, *flat)
        ctx.recipe, ctx.cfg, ctx.n = recipe, cfg, n
        ctx.x_dtype, ctx.w_dtypes = x.dtype, (w13.dtype, w2.dtype)
        ctx.mark_non_differentiable(drop)
        return y, drop

    @staticmethod
    def backward(ctx, g_y, _g_drop):
        flat = _saved_q(ctx)
        qw13, qw2 = flat[:2]
        saved = [flat[2 + 10 * c:12 + 10 * c] for c in range(ctx.n)]
        with casts.use(ctx.ledger):
            g_x, g_p, wg13, wg2 = _flow_bwd(ctx.recipe, ctx.cfg, ctx.n,
                                            saved, qw13, qw2, g_y,
                                            ctx.x_dtype)
        wd13, wd2 = ctx.w_dtypes
        return (None, None, None, g_x, g_p, None, wg13.to(wd13),
                wg2.to(wd2))


def _flow_bwd(recipe, cfg, n, saved, qw13, qw2, g_y, x_dtype):
    T, D = g_y.shape
    Tc, k = T // n, cfg.top_k
    group = cfg.ep_group
    E_loc, C_exp, _ = saved[0][4].data.shape
    S = E_loc * C_exp

    # stage 1: each chunk's reverse combine (bf16), every chunk's message
    # issued first, each landed in turn
    rev = [comm.all_to_all(
        _take_rows(g_y[c * Tc:(c + 1) * Tc].to(torch.float32),
                   saved[c][0]).to(torch.bfloat16), group, async_op=True)
        for c in range(n)]
    g_yexp, g_pexp = [], []
    for c in range(n):
        rms, sa, rme, ret, qx_c, qa_c, h_c, p_exp, y_exp, mm_c = saved[c]
        g_ret = rev[c].wait()
        rev[c] = None
        g_yw = _take_rows(g_ret, rme).reshape(E_loc, C_exp, D)
        g_yexp.append(g_yw * p_exp[..., None].to(g_yw.dtype))
        g_pexp.append((g_yw.to(torch.float32)
                       * y_exp.to(torch.float32)).sum(-1))
        del g_ret, g_yw

    # the ONE explicit backward cast (BF16 island -> FP8), hoisted out of
    # the chunk loop.  The reference quantizes concat(g_yexp, axis=1) and
    # slices it; row-wise scales make quantize(rows) independent of the
    # rows' order, so the chunks are stacked on a leading axis instead and
    # each chunk's slice stays contiguous: the same rows, bits and count.
    qg_all = _q_row(recipe, torch.stack(g_yexp).reshape(n * E_loc, C_exp, D),
                    "q_bwd_island")
    del g_yexp
    qg_d = qg_all.data.reshape(n, E_loc, C_exp, D)
    qg_s = qg_all.scale.reshape(n, E_loc, C_exp, D // TILE)

    # stage 2: a chunk at a time, the FFN backward and the fused reverse
    # message; chunk c's message lands while chunk c+1's FFN backward runs
    wg13 = wg2 = None
    gx_chunks, gp_chunks = [None] * n, [None] * n

    def land(c, msg):
        rms, sa = saved[c][0], saved[c][1]
        gd, gs, gp = _unpack_bwd_msg(msg, D)
        casts.record("fused_dequantize", "dispatch_bwd", gd.numel())
        g_rows = _dequantize_nocount(QTensor(gd, gs, row_tile(2)),
                                     torch.bfloat16)
        gx_chunks[c] = _segment_sum(g_rows, torch.where(rms >= 0, rms, Tc),
                                    Tc).to(x_dtype)
        gp_chunks[c] = _segment_sum(
            gp[:, None], torch.where(sa >= 0, sa, Tc * k),
            Tc * k)[:, 0].reshape(Tc, k)

    pending = None
    for c in range(n):
        rms, sa, rme, ret, qx_c, qa_c, h_c, p_exp, y_exp, mm_c = saved[c]
        qg_c = QTensor(qg_d[c], qg_s[c], qg_all.tile)
        gxq, wg13_c, wg2_c = ffn_bwd_fp8_core(
            recipe, cfg.act, qx_c, qa_c, qw13, qw2, qg_c, torch.float32,
            torch.float32, masked_m=mm_c, h_saved=h_c)
        wg13 = wg13_c if wg13 is None else wg13.add_(wg13_c)
        wg2 = wg2_c if wg2 is None else wg2.add_(wg2_c)
        del wg13_c, wg2_c
        # the inverse expert-grouping permute (FP8-exact), then ONE fused
        # reverse message: payload, scales and the prob gradients together
        gq = ops.fused_permute_pad(
            QTensor(gxq.data.reshape(S, D), gxq.scale.reshape(S, D // TILE),
                    row_tile(2)), ret)
        gp_r = _take_rows(g_pexp[c].reshape(S, 1), ret)[:, 0]
        msg = comm.all_to_all(_pack_bwd_msg(gq.data, gq.scale, gp_r),
                              group, async_op=True)
        del gxq, gq
        if pending is not None:
            land(pending[0], pending[1].wait())
        pending = (c, msg)
    land(pending[0], pending[1].wait())
    return (torch.cat(gx_chunks, dim=0), torch.cat(gp_chunks, dim=0),
            wg13, wg2)
