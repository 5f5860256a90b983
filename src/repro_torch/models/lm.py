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

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.linear import _bf16_matmul, _gelu_f32, dense_mlp
from repro_torch.core.moe import (MoEConfig, moe_block, moe_block_decode,
                                  moe_block_decode_overlapped,
                                  moe_block_overlapped, moe_block_tp)
from repro_torch.core.quant import QTensor, tag_saveable
from repro_torch.core.recipes import Recipe
from repro_torch.device import CHUNK_ELEMS, resolve_device
from repro_torch.dist import comm, tp
from repro_torch.models.layers import (apply_norm, attn_block,
                                       decode_attention, flash_attention,
                                       project_qkv, rmsnorm)
from repro_torch.models.ssm import mamba2_block
from repro_torch.obs.trace import stage_annotation
from repro_torch.serve.paged_kv import (SCRATCH_PAGE, page_read,
                                        page_write_rows)
from repro_torch.serve.w8 import w8_merge_gate
from repro_torch.train.memory import MemoryPlan


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
# The parallel plan (the reference's ParallelPlan, lm.py:36-72).
# ---------------------------------------------------------------------------
TP_COMBINES = ("psum_first", "local_first", "reduce_scatter")


def layer_weight_shape(cfg, name: str):
    """The full per-layer shape of an expert, dense-MLP or shared-expert
    weight (None for any other leaf name, or a weight the config lacks)."""
    D, g = cfg.d_model, cfg.gate_factor
    E, Fe = cfg.n_experts, cfg.d_ff_expert
    Fs = cfg.n_shared_experts * Fe
    shapes = {"w13": (D, g, cfg.d_ff), "w2": (cfg.d_ff, D)}
    if cfg.moe:
        shapes.update(we13=(E, D, g, Fe), we2=(E, Fe, D))
        if Fs:
            shapes.update(ws13=(D, g, Fs), ws2=(Fs, D))
    shape = shapes.get(name)
    return shape if shape is not None and all(shape) else None


def mlp_tp_ok(F: int, tp: int) -> bool:
    """F can TP-shard over `tp` only if the shard stays 128-tile aligned
    (the FP8 transpose and quantize blocks), the reference's rule."""
    return F % tp == 0 and (F // tp) % 128 == 0


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """How a run maps onto the mesh (``launch/mesh.Mesh``; None = one
    process, every collective the identity).  The reference's levers
    (``repro/models/lm.py:36-72``); ``launch/sharding.make_plan`` picks
    them as the reference's launcher does.

    dp_axes         axes sharding the batch: the mesh's data-parallel
                    axes, ('data',) or, on a pod mesh, ('pod', 'data') (the
                    default picks them from the mesh); the port's Megatron
                    layout splits the global batch over every rank, the
                    reference's ``token_axes_moe`` (launch/sharding.py);
                    any other value raises
    tp_axis         the model axis: 'model'; any other raises
    moe_mode        'ep': experts sharded on E over tp_axis (the all-to-all
                    blocks); 'tp': every rank holds every expert with its
                    d_ff sliced over tp_axis (``core.moe.moe_block_tp``,
                    for E < tp), the tokens of the model group gathered
    moe_tp_combine  the TP block's combine: 'psum_first' | 'local_first' |
                    'reduce_scatter' (``moe_block_tp``)
    moe_overlap     a ``core.moe.DispatchPlan``: the chunked EP blocks (TP
                    mode runs ``moe_block_tp`` whatever it says, as in the
                    reference)
    fsdp_axis       'data': the expert, dense-MLP and shared-expert weights
                    are stored cut on their d_model axis over the data
                    group and all-gathered inside their stage
                    (``dist/tp.fsdp_gather``); None keeps them whole
    mlp_tp          the dense MLPs and shared experts F-sliced over
                    tp_axis where ``mlp_tp_ok(F, tp)`` (the tokens
                    gathered, the output all-reduced), else DP mode
    stage_layers    the reference's switch from its scanned stack to its
                    unrolled staged program (``_run_stack_unrolled``).  The
                    port's stack loop (``_run_blocks``) is that staged
                    program always, so True and False run the same code
                    and give the same bits
    serving         the serving layout (``for_serving()``): every rank
                    holds the same rows, and each MoE stage cuts them as
                    the reference's ``shard_map`` boundary does
                    (``_serving_split``) and gathers the output back, so
                    every rank ends the stage with the same rows.  Its
                    weights are the serving cut (launch/sharding.py): the
                    experts cut, every other leaf whole."""
    mesh: object = None
    dp_axes: Optional[tuple] = None
    tp_axis: str = "model"
    moe_mode: str = "ep"
    moe_tp_combine: str = "local_first"
    moe_overlap: Optional[object] = None
    fsdp_axis: Optional[str] = None
    mlp_tp: bool = False
    stage_layers: bool = False
    serving: bool = False

    def __post_init__(self):
        if self.moe_mode not in ("ep", "tp"):
            raise ValueError(f"unknown moe_mode {self.moe_mode!r}")
        if self.moe_tp_combine not in TP_COMBINES:
            raise ValueError(f"unknown moe_tp_combine "
                             f"{self.moe_tp_combine!r}; pick from "
                             f"{TP_COMBINES}")
        if self.fsdp_axis not in (None, "data"):
            raise ValueError(f"fsdp_axis {self.fsdp_axis!r}: the mesh's "
                             "FSDP axis is 'data' (or None)")
        want = ("data",) if self.mesh is None else tuple(
            a for a in ("pod", "data") if a in self.mesh.axis_names)
        if self.dp_axes is None:
            object.__setattr__(self, "dp_axes", want)
        ok = (want,) if self.mesh is not None else (want, ("pod", "data"))
        if tuple(self.dp_axes) not in ok or self.tp_axis != "model":
            raise ValueError(
                f"the mesh's data-parallel axes are {want!r} and its model "
                f"axis 'model' (launch/mesh.py): dp_axes={want!r}, "
                f"tp_axis='model'; got {self.dp_axes!r}, {self.tp_axis!r}")

    def for_serving(self) -> "ParallelPlan":
        """This plan in the serving layout: the rows replicated, the
        experts cut as ``launch.sharding.serving_cut`` cuts them, every
        other weight whole (no FSDP gather, no TP MLP; the reference's
        other layouts give the same arithmetic)."""
        return dataclasses.replace(self, serving=True, fsdp_axis=None,
                                   mlp_tp=False)

    def _group(self, axis):
        return None if self.mesh is None else self.mesh.group(axis)

    @property
    def model_group(self):
        """The model axis's group: the EP blocks' all-to-alls and the TP
        stages' collectives run over it (None: no mesh, or no groups)."""
        return self._group(self.tp_axis)

    @property
    def fsdp_group(self):
        """The group FSDP weights are cut over (None: no FSDP)."""
        return None if self.fsdp_axis is None else \
            self._group(self.fsdp_axis)

    def _size(self, axis) -> int:
        return 1 if self.mesh is None else self.mesh.shape[axis]

    def mlp_tp_on(self, F: int) -> bool:
        """A dense MLP or shared expert of hidden F runs in TP mode."""
        return self.mlp_tp and mlp_tp_ok(F, self._size(self.tp_axis))

    def leaf_cuts(self, cfg, path: str) -> tuple:
        """The (axis, mesh axis) cuts of a params leaf at its dotted path,
        on its stacked axes: the stacked main and dense-prologue stacks'
        weights by ``weight_cuts``; every other leaf is whole."""
        parts = path.split(".")
        if len(parts) != 2 or parts[0] not in ("layers", "dense_layers"):
            return ()
        shape = layer_weight_shape(cfg, parts[1])
        if shape is None:
            return ()
        return tuple((ax + 1, m) for ax, m in self.weight_cuts(parts[1],
                                                                shape))

    def shards_weights(self, cfg) -> bool:
        """Whether any leaf is cut (the train step's global norm then sums
        each cut leaf's squares over its groups)."""
        names = ("we13", "we2") if cfg.moe else ()
        names += ("w13", "w2", "ws13", "ws2")
        return any(self.weight_cuts(n, layer_weight_shape(cfg, n))
                   for n in names if layer_weight_shape(cfg, n) is not None)

    def weight_cuts(self, name: str, shape) -> tuple:
        """The (axis, mesh axis) cuts of one layer's weight `name` of the
        full (world-1) per-layer `shape` (the stacked leaf's axes less its
        layer axis), in the reference's ``param_specs`` and stages
        (``repro/launch/sharding.py:88-96``, ``lm.py:236-241``,
        ``:346-358``): the experts on E over model (EP, at EP > 1) or on
        F over model (TP), the TP MLP on F over model, and with FSDP each
        on its d_model axis over data.  A cut applies only where it
        divides and leaves the last axis a multiple of 128 (the state
        encodings' rows then regroup exactly, launch/sharding.py); the
        reference cuts wherever it divides, a divergence held in
        ROADMAP.md, Queue 3."""
        tp, dp = self._size(self.tp_axis), self._size("data")
        cuts = []
        if name in ("we13", "we2"):
            if self.moe_mode == "ep" and tp > 1:
                cuts.append((0, "model"))
            elif self.moe_mode == "tp":
                f_ax = 3 if name == "we13" else 1
                if shape[f_ax] % tp:
                    raise ValueError(f"{name} {tuple(shape)}: d_ff "
                                     f"{shape[f_ax]} does not split over "
                                     f"TP = {tp}")
                cuts.append((f_ax, "model"))
            d_ax = 1 if name == "we13" else 2
        elif name in ("w13", "ws13", "w2", "ws2"):
            gated = name in ("w13", "ws13")
            F = shape[-1] if gated else shape[0]
            if self.mlp_tp_on(F):
                cuts.append((len(shape) - 1 if gated else 0, "model"))
            d_ax = 0 if gated else 1
        else:
            return ()
        if self.fsdp_axis == "data":
            local = list(shape)
            for ax, _ in cuts:
                local[ax] //= tp
            if shape[d_ax] % dp == 0:
                local[d_ax] //= dp
                if local[-1] % 128 == 0 and shape[-1] % 128 == 0:
                    cuts.append((d_ax, "data"))
        return tuple(cuts)


NO_PLAN = ParallelPlan()


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


def _fsdp_weight(plan, name, w, full_shape):
    """A weight of one layer as its stage uses it: gathered over the data
    group on its FSDP cut (``dist/tp.fsdp_gather``), as it is."""
    for ax, mesh_ax in plan.weight_cuts(name, full_shape):
        if mesh_ax == "data":
            return tp.fsdp_gather(w, plan.fsdp_group, ax)
    return w


def _mlp_stage(cfg, recipe: Recipe, p, x, plan=None, d_ff=None):
    """Dense MLP (a dense layer's, or the shared experts' with p = {w13:
    ws13, w2: ws2} and d_ff their hidden) on x (B, S, D): ``dense_mlp``,
    the reference's ``_mlp_stage``.  Without a plan (or on a plan with
    neither lever) the weights are whole: its no-mesh branch, whose DP
    mode computes the same at one device.  With ``plan.fsdp_axis`` the
    weights are gathered over the data group first.  In TP mode
    (``plan.mlp_tp_on(d_ff)``) w13 is F-sliced and w2 row-sliced over the
    model group: the group's tokens are gathered, each rank runs its
    slice, the input gradient's partial sum is all-reduced inside the
    backward (``gx_groups``) and the output is all-reduced after GEMM-2,
    each rank keeping its rows (``dist/tp.py``).  T and D pad to 128 as in
    the reference's ``_dense_mlp_sharded`` (``dense_mlp`` pads)."""
    plan = NO_PLAN if plan is None else plan
    B, S, D = x.shape
    w13, w2 = p["w13"], p["w2"]
    g = w13.shape[-2]
    F = cfg.d_ff if d_ff is None else d_ff
    w13 = _fsdp_weight(plan, "w13", w13, (D, g, F))
    w2 = _fsdp_weight(plan, "w2", w2, (F, D))
    Fl = w13.shape[-1]
    if not plan.mlp_tp_on(F):
        y = dense_mlp(recipe, cfg.act, x.reshape(B * S, D),
                      w13.reshape(D, g * Fl), w2)
        return y.reshape(B, S, D)
    group = plan.model_group
    xf = tp.gather_rows(x.reshape(B * S, D), group)
    y = dense_mlp(recipe, cfg.act, xf, w13.reshape(D, g * Fl), w2,
                  gx_groups=(group,))
    y = tp.own_rows(tp.all_reduce_sum(y, group), group)
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


def _serving_split(plan, x, split_seq: bool):
    """The reference's ``shard_map`` boundary of a MoE stage in the
    serving layout (every rank holds the same x (B, S, D); its
    ``lm.py:395-426``): B cut over the pod x data group where it divides
    (``dp3``), and, where `split_seq` (an EP prefill: ``token_axes_moe``),
    S over the model group where it divides (``seq3``); otherwise the rows
    stay replicated.  Capacities and drops follow each rank's own T, as
    in the reference.  Returns (this rank's block, the groups its output
    is gathered over: (dp, seq), None where not cut)."""
    mesh = plan.mesh
    if mesh is None or not mesh.has_groups:
        return x, None, None
    B, S, _ = x.shape
    dp_g = seq_g = None
    n_dp, tp = mesh.dp_size, mesh.shape[plan.tp_axis]
    if n_dp > 1 and B % n_dp == 0:
        b = B // n_dp
        x = x[mesh.dp_index * b:(mesh.dp_index + 1) * b]
        dp_g = mesh.dp_group
    if split_seq and tp > 1 and S % tp == 0:
        s = S // tp
        x = x[:, mesh.model_index * s:(mesh.model_index + 1) * s]
        seq_g = plan.model_group
    return x, dp_g, seq_g


def _serving_join(y, dp_g, seq_g):
    """The blocks of ``_serving_split`` gathered back into (B, S, D) on
    every rank (S over the model group, then B over the dp group, each in
    rank order)."""
    if seq_g is not None:
        y = comm.all_gather(y.transpose(0, 1).contiguous(),
                            seq_g).transpose(0, 1)
    if dp_g is not None:
        y = comm.all_gather(y.contiguous(), dp_g)
    return y


def _moe_stage(cfg, recipe: Recipe, p, x, decode=False, plan=None):
    """x (B, S, D) -> (B, S, D), aux loss.  Prefill runs ``moe_block``,
    decode ``moe_block_decode`` (the reference's 'ep' and 'decode' modes)
    over the plan's expert-parallel group (none without a mesh); the
    shared experts add their MLP after the routed block, through
    ``_mlp_stage`` or, in decode, ``_mlp_decode``.  With
    ``plan.moe_overlap`` (a ``core.moe.DispatchPlan``) prefill runs
    ``moe_block_overlapped`` at ``chunks_for(T)`` chunks, with the shared
    experts issued before the routed block, and decode
    ``moe_block_decode_overlapped`` at ``decode_chunks_for(T)``.  None
    keeps the monolithic blocks.

    ``plan.moe_mode == 'tp'`` (the reference's ``lm.py:316-488``): every
    rank runs ``moe_block_tp`` on its F-slice of every expert, in prefill
    and in decode (``lm.py:347-350``, ``:377-380``).  In training the
    model group's tokens are gathered (``dist/tp.gather_rows``) and each
    rank keeps its rows of the combined output (the ``reduce_scatter``
    combine gives them directly, the other two all-reduce then slice);
    the aux loss is the same on every rank of the group, and its cotangent
    is summed over the group (``dist/tp.sum_grad``), since every rank's
    loss reads it.

    ``plan.serving`` (the serving layout: every rank holds the same rows)
    cuts the rows as the reference's boundary does (``_serving_split``:
    a decode step's and a TP stage's over the pod x data group only, an
    EP prefill's over the model group too) and gathers the output back.
    With ``plan.fsdp_axis`` the expert weights are gathered over the data
    group first; W8 serving weights never are."""
    B, S, D = x.shape
    plan = NO_PLAN if plan is None else plan
    moe_overlap = plan.moe_overlap
    tp_mode = plan.moe_mode == "tp"
    mcfg = MoEConfig(n_experts=cfg.n_experts, top_k=cfg.top_k, d_model=D,
                     d_ff=cfg.d_ff_expert, capacity_factor=cfg.capacity_factor,
                     act=cfg.act, ep_group=plan.model_group)
    we13, we2 = p["we13"], p["we2"]
    if isinstance(we13, QTensor):
        we13 = w8_merge_gate(we13)
    else:
        E, g, Fe = cfg.n_experts, cfg.gate_factor, cfg.d_ff_expert
        we13 = _fsdp_weight(plan, "we13", we13, (E, D, g, Fe))
        we2 = _fsdp_weight(plan, "we2", we2, (E, Fe, D))
        El, Dl, gl, Fl = we13.shape
        we13 = we13.reshape(El, Dl, gl * Fl)
    xs, dp_g, seq_g = x, None, None
    if plan.serving:
        xs, dp_g, seq_g = _serving_split(plan, x, split_seq=not (
            decode or tp_mode))
    Bl, Sl = xs.shape[:2]
    xf = xs.reshape(Bl * Sl, D)
    shared = {"w13": p.get("ws13"), "w2": p.get("ws2")}
    Fs = cfg.n_shared_experts * cfg.d_ff_expert
    shared_out = None
    if tp_mode:
        group = plan.model_group
        combine = plan.moe_tp_combine
        # training gathers the model group's rows; serving holds them
        rows = xf if plan.serving else tp.gather_rows(xf, group)
        y, m = moe_block_tp(recipe, mcfg, rows, p["w_router"], we13, we2,
                            tp_group=group, combine_mode=combine)
        if plan.serving:
            if combine == "reduce_scatter":
                y = comm.all_gather(y, group)
        else:
            if combine != "reduce_scatter":
                y = tp.own_rows(y, group)
            m = dict(m, aux_loss=tp.sum_grad(m["aux_loss"], group))
    elif moe_overlap is None:
        block = moe_block_decode if decode else moe_block
        y, m = block(recipe, mcfg, xf, p["w_router"], we13, we2)
    elif decode:
        y, m = moe_block_decode_overlapped(
            recipe, mcfg, xf, p["w_router"], we13, we2,
            n_chunks=moe_overlap.decode_chunks_for(Bl * Sl))
    else:
        # the shared experts depend on x only: issued before the routed
        # block, as the reference does under its overlap plan
        if cfg.n_shared_experts:
            shared_out = _mlp_stage(cfg, recipe, shared, x, plan, Fs)
        y, m = moe_block_overlapped(
            recipe, mcfg, xf, p["w_router"], we13, we2,
            n_chunks=moe_overlap.chunks_for(Bl * Sl))
    y = _serving_join(y.reshape(Bl, Sl, D), dp_g, seq_g)
    if cfg.n_shared_experts:
        if shared_out is None:
            shared_out = (_mlp_decode(cfg, shared, x) if decode
                          else _mlp_stage(cfg, recipe, shared, x, plan, Fs))
        y = y + shared_out
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
    def split(leaf):
        if isinstance(leaf, QTensor):           # W8 serving weights
            return [QTensor(leaf.data[i], leaf.scale[i], leaf.tile[1:])
                    for i in range(n)]
        return (leaf.squeeze(0),) if n == 1 else leaf.unbind(0)
    per_leaf = {name: split(leaf) for name, leaf in stack_params.items()}
    return [{name: v[i] for name, v in per_leaf.items()} for i in range(n)]


def stage_ln_attn(cfg, p, x, positions, window: int, causal: bool = True):
    """Named stage 'attn': pre-norm + attention + residual add; the stage
    output is tagged for the 'full' policy (train/memory.py)."""
    with stage_annotation("attn"):
        h = apply_norm(cfg.norm, x, p, "ln1")
        out, _ = attn_block(cfg, p, h, positions=positions,
                            layer_window=window, causal=causal)
        return tag_saveable(x + out, "stage_attn_out")


def _sub_layer(cfg, recipe, kind, moe_layer, p, x, positions, causal=True,
               plan=None):
    """One layer: the mixer (attention; a Mamba2 mixer for ``ssm``; both
    on the same normed input, averaged, for ``hybrid``), then the MoE
    stage or the dense MLP (none for a mixer-only ssm layer; the dense
    FFN is one 'expert' stage, as in the reference).  Returns (x, aux),
    aux None without a router."""
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
    h2 = tag_saveable(apply_norm(cfg.norm, x, p, "ln2"), "stage_ffn_in")
    if moe_layer:
        mo, aux = _moe_stage(cfg, recipe, p, h2, plan=plan)
        return x + mo, aux
    with stage_annotation("expert"):
        mo = _mlp_stage(cfg, recipe, p, h2, plan)
    return x + mo, None


def run_block(cfg, fns, x):
    """One checkpoint block of the config's MemoryPlan (train/memory.py)
    over the layer functions `fns` (fn(x) -> (x, aux or None)): returns
    (x, the block's auxes).  The block loop of ``_run_blocks`` and the
    streamed train step's, which keeps each block's input and outputs."""
    def block(xc):
        auxes = []
        for fn in fns:
            xc, a = fn(xc)
            auxes.append(a)
        return xc, tuple(auxes)
    return MemoryPlan.from_config(cfg).wrap(block)(x)


def add_auxes(aux, auxes):
    """aux plus a block's aux losses, in layer order (so every policy and
    driver adds them alike)."""
    for a in auxes:
        if a is not None:
            aux = aux + a
    return aux


def _run_blocks(cfg, layer_fns, x):
    """Run the layers in the checkpoint blocks of the config's MemoryPlan
    (one layer a block, two under 'pair'; 'none' wraps nothing), the
    reference's unrolled driver.  layer_fns[i](x) -> (x, aux or None).
    Returns (x, the auxes summed in layer order)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for fns in MemoryPlan.from_config(cfg).blocks_of(layer_fns):
        x, auxes = run_block(cfg, fns, x)
        aux = add_auxes(aux, auxes)
    return x, aux


def stack_layer_fns(cfg, recipe, layers, pattern, moe, positions,
                    causal=True, plan=None):
    """One function a layer of a stack whose layers' params are `layers`
    (one dict a layer, in order): ``_sub_layer`` of its kind."""
    pattern = _pattern_or_fallback(pattern, len(layers))
    return [functools.partial(_sub_layer, cfg, recipe,
                              pattern[i % len(pattern)], moe, p,
                              positions=positions, causal=causal, plan=plan)
            for i, p in enumerate(layers)]


def decoder_stacks(cfg):
    """(stack, pattern, n_layers, moe) of the decoder's stacked layers in
    forward order: the dense prologue (if any), then the main stack."""
    nd = _n_dense(cfg)
    prologue = [("dense_layers", (cfg.pattern[0],), nd, False)] if nd else []
    return prologue + [("layers", cfg.pattern, cfg.n_layers - nd, cfg.moe)]


def _run_stack(cfg, recipe, stack_params, pattern, n_layers, moe, x,
               positions, causal=True, plan=None):
    """The reference's stack as a loop over layer slices in checkpoint
    blocks; returns (x, the summed aux losses)."""
    return _run_blocks(cfg, stack_layer_fns(
        cfg, recipe, _train_layer_slices(stack_params, n_layers), pattern,
        moe, positions, causal, plan), x)


def first_layer(cfg, params):
    """(kind, moe_layer, params) of the main stack's first layer: the
    first MoE layer, or a dense arch's first layer (the layer the residual
    accounting of train/memory.py measures), sliced as training slices
    it."""
    n = cfg.n_layers - _n_dense(cfg)
    return (_pattern_or_fallback(cfg.pattern, n)[0], cfg.moe,
            _train_layer_slices(params["layers"], n)[0])


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


def _run_encdec_decoder(cfg, recipe, params, x, positions, enc,
                        plan=None):
    """The decoder stack with cross-attention: each layer's self-attention
    and MLP, then cross-attention to its projection of `enc`, added to
    the residual."""
    n = cfg.n_layers

    def layer(p_self, p_cross, x):
        x, a = _sub_layer(cfg, recipe, "global", cfg.moe, p_self, x,
                          positions, plan=plan)
        h = rms_or_ln(cfg, x, p_cross)
        c_out, _ = attn_block(cfg, p_cross, h, positions=positions,
                              cross_kv=_project_cross_kv(cfg, p_cross, enc))
        return x + c_out, a

    fns = [functools.partial(layer, p_self, p_cross)
           for p_self, p_cross in zip(
               _train_layer_slices(params["layers"], n),
               _train_layer_slices(params["cross_layers"], n))]
    return _run_blocks(cfg, fns, x)


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
            compute_loss: bool = True, plan=None):
    """batch: {'tokens' (B, S) int, 'targets' (B, S), optional 'mask'
    (B, S), optional 'prefix' (B, P, D) [the vision or audio frontend's
    stub embeddings, put in front of the tokens and cut off before the
    logits], 'enc_input' (B, S_enc, D) [an encoder-decoder's; required]}.
    Runs the encoder, the dense prologue, then the main stack.  Returns
    (loss, metrics) or, with compute_loss=False, (logits, metrics).
    `plan` (a ``ParallelPlan``) maps the MoE layers onto the mesh's
    expert-parallel group and carries the chunked blocks' DispatchPlan
    (``_moe_stage``).  On a mesh the batch is this rank's share and the
    loss is its mean (the train step averages the ranks'); under a
    serving plan (``ParallelPlan.for_serving``, ``serve_step.
    make_prefill``) every rank holds the whole batch."""
    plan = NO_PLAN if plan is None else plan
    x = _embed_tokens(cfg, params, batch["tokens"])
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
    stacks = decoder_stacks(cfg)
    for stack, pattern, n, moe in stacks[:-1] if cfg.encdec else stacks:
        x, a = _run_stack(cfg, recipe, params[stack], pattern, n, moe, x,
                          positions, plan=plan)
        aux = aux + a
    if cfg.encdec:
        x, a = _run_encdec_decoder(cfg, recipe, params, x, positions, enc,
                                   plan)
        aux = aux + a
    logits = head_logits(cfg, params, x,
                         0 if prefix is None else prefix.shape[1])
    metrics = {"aux_loss": aux}
    if not compute_loss:
        return logits, metrics
    loss = batch_xent(logits, batch) + AUX_LOSS_COEF * aux
    metrics["loss"] = loss
    return loss, metrics


def head_logits(cfg, params, x, n_prefix: int = 0):
    """The forward's tail up to the logits: the final norm, the frontend's
    `n_prefix` rows cut off, the LM head."""
    x = _final_norm(cfg, params, x)
    if n_prefix:
        x = x[:, n_prefix:]
    return _lm_logits(cfg, params, x)


def batch_xent(logits, batch):
    """The token cross-entropy of the batch's targets, under its mask (all
    ones when it has none)."""
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(batch["tokens"].shape, dtype=torch.float32,
                          device=logits.device)
    return xent(logits, batch["targets"], mask)


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
                  pos, attn_c, ssm_c, cross_c=None, cross_params=None,
                  plan=None):
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
            with stage_annotation("attn"):
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
            if moe:
                mo = _moe_stage(cfg, recipe, pi, h2, decode=True,
                                plan=plan)[0]
            else:
                with stage_annotation("expert"):
                    mo = _mlp_decode(cfg, pi, h2)
            x = x + mo
    return x, (torch.stack(convs) if ssm_c is not None else None)


@torch.no_grad()
def decode_step(cfg: ArchConfig, recipe: Recipe, params, cache, tokens, pos,
                plan=None):
    """One decode step.  tokens (B, 1) int; pos: a scalar (one shared
    position, the fixed-batch path) or a (B,) tensor of per-request
    positions (cache rows [0, pos_b) hold the history).  The cache (from
    ``init_cache``) is updated in place but for the SSM conv histories,
    which are replaced.  `plan`: as ``forward``'s, its decode depth, in
    the serving layout (``ParallelPlan.for_serving``): every rank holds
    the same rows and the same cache, its experts cut by
    ``launch.sharding.serving_cut``.  Returns (logits (B, 1, V), the
    cache)."""
    plan = (NO_PLAN if plan is None else plan).for_serving()
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
                             cache.get("cross"), params.get("cross_layers"),
                             plan=plan)
    if convs is not None:
        new_cache["main_ssm"] = {"state": ssm_c["state"], "conv": convs}
    logits = _lm_logits(cfg, params, _final_norm(cfg, params, x))
    return logits, new_cache


# ---------------------------------------------------------------------------
# Paged serving.
# ---------------------------------------------------------------------------
def _run_paged_stack(cfg, recipe, stack_params, stack_kinds, moe, x, pool,
                     positions, page_idx, slot_idx, *, decode,
                     page_tables=None, pos=None, history=False,
                     plan=None):
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
        with stage_annotation("attn"):
            h = apply_norm(cfg.norm, x, pi, "ln1")
            q, k, v = project_qkv(cfg, pi, h, positions)
            page_write_rows(kc, k[:, 0] if decode else k[0], page_idx,
                            slot_idx)
            page_write_rows(vc, v[:, 0] if decode else v[0], page_idx,
                            slot_idx)
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
                o = flash_attention(q, k, v, q_pos=positions,
                                    kv_pos=positions, causal=True,
                                    window=window, softcap=cfg.attn_softcap)
            B, S = x.shape[:2]
            x = x + o.reshape(B, S, -1) @ pi["wo"].to(x.dtype)
        h2 = apply_norm(cfg.norm, x, pi, "ln2")
        if moe:
            mo, _ = _moe_stage(cfg, recipe, pi, h2, decode=decode,
                               plan=plan)
        else:
            with stage_annotation("expert"):
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
                      page_tables, tokens, pos, active, plan=None):
    """One continuous-batching decode step over paged pools.

    tokens (B, 1) int; pos (B,) per-request positions of this token; active
    (B,) bool (inactive slots write to the scratch page; their outputs are
    garbage); page_tables (B, max_pages).  `plan`: as ``decode_step``'s
    (the serving layout).  Returns logits (B, 1, V)."""
    plan = (NO_PLAN if plan is None else plan).for_serving()
    x = _embed_tokens(cfg, params, tokens)
    B = x.shape[0]
    pos = pos.to(torch.int64)
    ps = pools["main_attn"]["k"]["data"].shape[2]
    rows = torch.arange(B, device=x.device)
    page_idx = torch.where(active, page_tables[rows, pos // ps].to(torch.int64),
                           SCRATCH_PAGE)
    x = _run_paged_stacks(cfg, recipe, params, pools, x, pos[:, None],
                          page_idx, pos % ps, decode=True,
                          page_tables=page_tables, pos=pos,
                          plan=plan)
    return _lm_logits(cfg, params, _final_norm(cfg, params, x))


def paged_prefill(cfg: ArchConfig, recipe: Recipe, params, pools,
                  page_table_row, tokens, length: int, start: int = 0,
                  history: bool = False, plan=None):
    """Prefill ONE request's prompt chunk into its pages.

    tokens (1, S), right-padded to the bucket S; `length` valid tokens in
    this chunk at absolute offset `start`; rows >= length land on the
    scratch page.  history=True attends to the rows [0, start) already in
    the pages.  `plan`: as ``decode_step``'s (the serving layout).
    Returns logits (1, 1, V) at position start + length - 1."""
    plan = (NO_PLAN if plan is None else plan).for_serving()
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
                          page_tables=page_table_row[None], history=history,
                          plan=plan)
    x = _final_norm(cfg, params, x)
    last = min(max(int(length) - 1, 0), S - 1)
    return _lm_logits(cfg, params, x[:, last:last + 1])
