"""Quantization-aware rematerialization: the activation-residency plan.

Counterpart of ``repro.train.memory``.  ``MemoryPlan`` decides, per
checkpoint block of decoder layers (``models/lm.py``'s stack drivers),
what stays resident across the forward/backward boundary:

  none          no rematerialization: autograd saves every backward
                residual.  In fp8_flow the grouped-FFN residuals are already
                QTensors (the recipe's own FP8 activation checkpointing),
                but the attention / norm / stage glue keeps wide bf16 and
                f32 tensors per layer: the maximum-memory corner.
  full          BF16-boundary checkpointing: the BF16 stage outputs
                (``core/quant.BF16_STAGE_NAMES``: the attention residual
                out, the FFN input, the FFN's bf16 island h, the expert
                output) are kept; everything else is recomputed, the FP8
                QTensors included (re-quantized in the recompute).
  fp8_resident  the paper's policy: only the QTensor stage outputs
                (``FP8_SAVE_NAMES``: the FFN's qx and qa, payload and
                scales) are kept; the recompute rebuilds the BF16 glue
                (norms, attention, router, dispatch maps) from the block's
                input and hands every FFN its kept qx and qa (GEMM-1 and the
                activation quantize are skipped).  Nothing wider than e4m3
                and its scales crosses the boundary but the residual stream.
  pair          plain input-only checkpoints over TWO-layer blocks: one
                bf16 residual per two layers, everything recomputed.

The mechanism is ``torch.utils.checkpoint`` (non-reentrant) around each
block, called in ``MemoryPlan.checkpoint`` and nowhere else in the port.
PyTorch's selective checkpointing picks ops by dispatcher name and cannot
see the hand-written kernels (ctypes launches), so the kept set is a
per-block stash instead: in the block's forward ``core/quant.tag_saveable``
/ ``tag_qtensor`` put the tensors of the policy's names in it; in the
recompute (the block's forward run again inside the backward, to rebuild
what autograd saved) the tags hand the kept tensors back, and
``core/quant.kept`` lets a producer skip its work (GEMM-1 under 'full'
and 'fp8_resident', GEMM-2 under 'full').  Tensors the backward needs are
``ctx.save_for_backward``d by every autograd Function of the port, so the
checkpoint drops and rebuilds them.

The recompute records nothing: the cast ledger and the quant-stats
collector are muted in it (its forward recorded already; on the card
autograd runs it on its device thread, on the CPU in the caller's), and
the fault armed in the forward is armed again, so the recompute computes
the forward's bits.  The port runs eagerly and its kernels and plain ops
are deterministic, so every policy computes the same losses and gradients
bit for bit (tests/test_torch_remat.py).

Saved-bytes-per-MoE-layer model (``layer_saved_bytes_model``; A =
T*top_k*capacity_factor expert-slot rows):

  policy        saved activations / layer             bytes (bf16=2B, fp8=1B)
  none          everything autograd needs             >= full + attn out
  full          attn_out, ffn_in (T,D) bf16;          2(2TD + 2AF*g + AD)
                island h (A, g*F) bf16;
                expert out (A, D) bf16
  fp8_resident  qx (A, D) e4m3 + scales;              (1+4/TILE)(AD + AF)
                qa (A, F) e4m3 + scales
  pair          one bf16 residual per 2 layers        T*D (amortized)
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core import casts, quant
from repro_torch.core.quant import BF16_STAGE_NAMES, FP8_SAVE_NAMES
from repro_torch.obs import trace
from repro_torch.runtime import fault_injection

POLICIES = ("none", "full", "fp8_resident", "pair")
_KEPT_NAMES = {"none": (), "full": BF16_STAGE_NAMES,
               "fp8_resident": FP8_SAVE_NAMES, "pair": ()}


def _normalize(policy) -> str:
    """Accept the legacy bool spelling (config-sweep aliases): True -> the
    default 'full' remat, False -> 'none'."""
    if isinstance(policy, bool):
        return "full" if policy else "none"
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; "
                         f"pick from {POLICIES}")
    return policy


class _Stash:
    """One checkpoint block's kept tensors by name, in forward order.  The
    forward appends (``keep``); each recompute replays them in the same
    order from a fresh cursor."""

    def __init__(self, names):
        self.names = frozenset(names)
        self.tensors: Dict[str, List[torch.Tensor]] = {}
        self.cursor = None                 # None: recording the forward

    def keep(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if name not in self.names:
            return x
        if self.cursor is None:
            self.tensors.setdefault(name, []).append(x.detach())
            return x
        # a leaf that requires grad where x did, so the recompute's ops
        # save what the forward's saved
        t = self._next(name)
        return t.detach().requires_grad_() if x.requires_grad else t

    def replay(self, name: str):
        # a fresh alias, so a Function that returns it sets no history on
        # the kept tensor
        if self.cursor is None or name not in self.names:
            return None
        return self._next(name).detach()

    def _next(self, name: str) -> torch.Tensor:
        i = self.cursor.get(name, 0)
        self.cursor[name] = i + 1
        return self.tensors[name][i]

    def all(self) -> List[torch.Tensor]:
        return [t for ts in self.tensors.values() for t in ts]


class _BlockContext:
    """The context a block's forward (``recompute=None``) or its recompute
    runs in: the stash active; in the recompute the ledger and the stats
    muted, the forward's fault re-armed, and a profiler range named
    ``remat/<policy>/recompute`` open.  Re-enterable (a recompute may run
    more than once)."""

    def __init__(self, stash: _Stash, recompute=None, fault=None):
        self.stash, self.recompute, self.fault = stash, recompute, fault
        self._stack = None

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        if self.recompute is not None:
            self.stash.cursor = {}
            self._stack.enter_context(trace.annotate(
                f"remat/{self.recompute}/recompute"))
            self._stack.enter_context(casts.use(None))
            self._stack.enter_context(quant.stats_muted())
            self._stack.enter_context(fault_injection.activate(self.fault))
        self._stack.enter_context(quant.residency(self.stash))
        return self

    def __exit__(self, *exc):
        stack, self._stack = self._stack, None
        return stack.__exit__(*exc)


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """Static activation-residency plan (hashable; safe to close over)."""
    policy: str = "full"

    def __post_init__(self):
        object.__setattr__(self, "policy", _normalize(self.policy))

    @classmethod
    def from_config(cls, cfg) -> "MemoryPlan":
        return cls(policy=getattr(cfg, "remat_policy", "full"))

    # -- structural knobs ---------------------------------------------------
    @property
    def remat(self) -> bool:
        """Whether any checkpoint wrapper is applied at all."""
        return self.policy != "none"

    @property
    def block_size(self) -> int:
        """Layers per checkpoint block: 2 under 'pair'."""
        return 2 if self.policy == "pair" else 1

    def group_factor(self, n_groups: int) -> int:
        """The reference's scan-driver fold: under 'pair' two pattern
        groups form one checkpointed body when the depth allows.  The
        port's drivers are loops over ``layer_blocks``; kept for the
        reference's interface."""
        return 2 if self.policy == "pair" and n_groups % 2 == 0 else 1

    def layer_blocks(self, n_layers: int) -> Tuple[Tuple[int, ...], ...]:
        """Partition [0, n_layers) into checkpoint blocks in forward order
        (size block_size; a trailing odd layer gets its own block)."""
        bs = self.block_size
        return tuple(tuple(range(i, min(i + bs, n_layers)))
                     for i in range(0, n_layers, bs))

    def blocks_of(self, items: Sequence) -> Tuple[tuple, ...]:
        """layer_blocks applied to an explicit per-layer sequence."""
        return tuple(tuple(items[i] for i in blk)
                     for blk in self.layer_blocks(len(items)))

    # -- the checkpoint --------------------------------------------------
    def wrap(self, f):
        """Wrap a block body (tensors in, tensors out) according to the
        policy; 'none' returns f itself."""
        if self.policy == "none":
            return f

        @functools.wraps(f)
        def block(*args):
            return self.checkpoint(f, *args)[0]
        return block

    def checkpoint(self, f, *args):
        """(f(*args) under the policy's checkpoint, the block's stash).
        This is the only place in the port where ``torch.utils.checkpoint``
        is invoked.  f runs inside the ``remat/<policy>`` range
        (obs/trace.py), as the reference's body does inside its named
        scope.  With autograd off (serving, evaluation) f runs as it is:
        there is no backward to keep anything for."""
        stash = _Stash(_KEPT_NAMES[self.policy])
        if self.policy == "none":
            return f(*args), stash

        def named(*a):
            # the reference's remat/<policy> scope over the block's body:
            # its forward and its recompute both run inside it
            with trace.annotate(f"remat/{self.policy}"):
                return f(*a)
        if not torch.is_grad_enabled():
            return named(*args), stash
        fault = fault_injection.armed()

        def contexts():
            return (_BlockContext(stash),
                    _BlockContext(stash, self.policy, fault))
        # no random draw in a layer's forward: no RNG state to restore
        out = torch.utils.checkpoint.checkpoint(
            named, *args, use_reentrant=False, context_fn=contexts,
            preserve_rng_state=False)
        return out, stash


# ---------------------------------------------------------------------------
# Saved-residual accounting.
# ---------------------------------------------------------------------------
_ONE_BYTE = (torch.float8_e4m3fn, torch.float8_e5m2, torch.uint8, torch.int8)


def classify_residuals(res, residual_elems: int):
    """Split saved tensors into the reference's accounting buckets:
    {'argument', 'fp8', 'scale', 'wide_bf16', 'small'} -> total bytes.
    `res` is a list of (tensor, is_argument); ``residual_elems`` is the
    element count of the residual stream (B*S*D), the width bar of the
    fp8_resident invariant.  1-byte dtypes count as 'fp8'."""
    out = {"argument": 0, "fp8": 0, "scale": 0, "wide_bf16": 0, "small": 0}
    for t, is_arg in res:
        n, nbytes = t.numel(), t.numel() * t.element_size()
        if is_arg:
            out["argument"] += nbytes
        elif t.dtype in _ONE_BYTE:
            out["fp8"] += nbytes
        elif n <= max(residual_elems // 16, 1):
            # per-tile scales / routing metadata / scalars
            out["scale" if t.dtype == torch.float32 else "small"] += nbytes
        elif n > residual_elems and t.is_floating_point() \
                and t.element_size() >= 2:
            out["wide_bf16"] += nbytes
        else:
            out["small"] += nbytes
    return out


def saved_residuals(plan: MemoryPlan, f, *args):
    """The tensors the backward of ``plan.wrap(f)(*args)`` keeps alive:
    what autograd saves outside any checkpoint (every residual under
    'none'), the block's stash, and, under a checkpoint, the block's
    arguments, which it holds for the recompute.  Each (tensor,
    is_argument), one entry a distinct buffer.  f's tensors that require
    grad are the differentiated inputs (``saved_tensors_hooks``)."""
    saved = []

    def pack(t):
        # detached: a node that saves its own output would otherwise hold
        # that output's grad_fn, itself, through the hook (a cycle outside
        # Python's collector)
        saved.append(t.detach())
        return saved[-1]

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _, stash = plan.checkpoint(f, *args)
    arg_leaves = [a for a in _tensor_leaves(args)]
    held = list(arg_leaves) if plan.remat else []
    arg_ptrs = {a.untyped_storage().data_ptr() for a in arg_leaves}
    out, seen = [], set()
    for t in saved + stash.all() + held:
        key = (t.data_ptr(), t.numel() * t.element_size())
        if key in seen:
            continue
        seen.add(key)
        out.append((t, t.untyped_storage().data_ptr() in arg_ptrs))
    return out


def _tensor_leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)


def measure_layer_residuals(cfg, recipe, policy, *, batch: int = 4,
                            seq: int = 128, device="cpu"):
    """Measure and classify the saved residuals of one decoder layer (the
    first MoE layer, or the first layer of a dense arch) under `policy`,
    from random bf16 params (seed 0) and an input of 0.1s, as the
    reference's harness does.  Returns the buckets of
    ``classify_residuals``."""
    # deferred: models/lm.py imports this module at load time
    from repro_torch.models.lm import first_layer, init_params
    params = init_params(cfg, seed=0, device=device)
    for leaf in _tensor_leaves(params):
        leaf.requires_grad_()
    kind, moe_layer, p = first_layer(cfg, params)
    D = cfg.d_model
    x = torch.full((batch, seq, D), 0.1, dtype=torch.bfloat16,
                   device=device, requires_grad=True)
    res = saved_residuals(MemoryPlan(policy),
                          layer_loss(cfg, recipe, kind, moe_layer), p, x)
    return classify_residuals(res, batch * seq * D)


def layer_loss(cfg, recipe, kind, moe_layer):
    """f(p, x): one layer's forward (params p, input x (B, S, D)) to the
    scalar sum(out^2) + aux, the function the accounting differentiates."""
    from repro_torch.models.lm import _sub_layer

    def f(p, x):
        positions = torch.arange(x.shape[1], device=x.device)
        out, aux = _sub_layer(cfg, recipe, kind, moe_layer, p, x, positions)
        loss = out.to(torch.float32).square().sum()
        return loss if aux is None else loss + aux
    return f


def layer_saved_bytes_model(cfg, T: int, policy: str) -> float:
    """Analytic saved-activation bytes per MoE layer under each policy (the
    table above).  T = tokens; excludes the layer-boundary residual stream
    itself (identical across policies)."""
    from repro_torch.core.fp8 import TILE
    policy = _normalize(policy)
    D, F = cfg.d_model, (cfg.d_ff_expert if cfg.moe else cfg.d_ff)
    g = cfg.gate_factor
    A = int(T * cfg.top_k * cfg.capacity_factor) if cfg.moe else T
    if policy == "pair":
        return T * D * 2 / 2          # one bf16 residual per two layers
    if policy == "fp8_resident":
        per_fp8 = 1 + 4.0 / TILE      # e4m3 payload + f32 scale per TILE
        return (A * D + A * F) * per_fp8
    if policy == "full":
        return 2.0 * (T * D           # attn residual-out
                      + T * D         # ffn input (post-ln2)
                      + A * g * F     # the bf16 island h
                      + A * D)        # expert output (combine input)
    # 'none': full's saves plus the attention residuals autograd keeps
    H, hd = cfg.n_heads, cfg.head_dim
    return layer_saved_bytes_model(cfg, T, "full") + 2.0 * T * H * hd
