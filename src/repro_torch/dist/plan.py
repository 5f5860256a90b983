"""DistPlan: the planned data-parallel communication of a train step.

Counterpart of ``repro.dist.plan`` (its ``posthoc`` schedule and flat
layout).  Which leaves ride the FP8 wire, how they bucket into fused
messages, and how the ZeRO-1 shards own the flat gradient space:

- FP8-eligible leaves (floating, >= 2-D, at least ``min_fp8_size``
  elements, not named in SENSITIVE_NAMES) are flattened, padded to TILE
  (128)-element rows and packed in flatten order into buckets of about
  ``bucket_mb`` payload each; a leaf larger than a bucket is a bucket of
  its own.  One bucket is ONE uint8 wire message (``grad_comm.py``).
- A bucket's rows pad to ``shard_multiple``, so every DP size that
  divides it owns an equal shard: a ZeRO-1 checkpoint restores onto
  another DP size.
- Sensitive leaves (norms, biases, the router, embeddings, anything small
  or 1-D) take the bf16 all-reduce (f32 under ``wire='f32'``).

The flatten order is the reference's: ``jax.tree_util`` walks a dict's
keys sorted, so the port walks its nested dicts in sorted key order
(``flatten_with_paths``), and on the same tree the layout is the
reference's slot for slot.

Layer-aligned layout (``layered=True``, the reference's ``:233-292``):
the stacked decoder stacks (``layers`` / ``dense_layers``, stored (L,
...)) bucket PER LAYER, main stack last-layer-first, then the dense
prologue last-first: the order the streaming backward
(``train/train_step.py``) emits each layer's gradients.  A slot then
covers ``leaves[index][layer]``; a sensitive stacked leaf carries its
``stack`` tag and is reduced a layer slice at a time with that layer's
buckets; the non-stacked FP8 leaves pack after them.  This is the layout
``schedule='stream'`` needs (bucket i's quantize and reduce-scatter leave
as soon as its layer's gradients exist); ``posthoc`` with ``layered=True``
is the controlled baseline: the same buckets, only the issue order
differs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.fp8 import TILE

# parameter-tree roots stacked (L, ...) over a decoder stack, run a layer
# at a time: only these can be layer-aligned
STACKED_STACKS = ("layers", "dense_layers")

# leaves that take the bf16 fallback wire whatever their size
SENSITIVE_NAMES = frozenset({
    "embed", "lm_head", "w_router", "conv_w", "q_norm", "k_norm",
})


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """The DP-axis communication plan (the reference's fields).

    axis            mesh axis the reduction runs over
    mode            'none' (the plain step's all-reduce) | 'zero1'
    wire            'fp8' (e4m3 + po2 int8 exponents) | 'bf16' | 'f32':
                    the same bucketed reduce-scatter with a plain payload
    bucket_mb       payload target of one fused message
    shard_multiple  bucket rows pad to this multiple
    min_fp8_size    leaves smaller than this take the bf16 fallback
    policy          optimizer-state encodings (dist.opt_state.StatePolicy)
    schedule        'posthoc' (every bucket reduced after the backward) |
                    'stream' (bucket i's quantize + reduce-scatter issued
                    from inside the backward as soon as its layer's
                    gradients exist; needs the layer-aligned layout)
    layered         the layer-aligned layout; None defaults to
                    (schedule == 'stream')"""
    axis: str = "data"
    mode: str = "zero1"
    wire: str = "fp8"
    bucket_mb: float = 4.0
    shard_multiple: int = 64
    min_fp8_size: int = 2048
    policy: object = None
    schedule: str = "posthoc"
    layered: Optional[bool] = None

    def __post_init__(self):
        if self.mode not in ("none", "zero1"):
            raise ValueError(f"unknown dist mode {self.mode}")
        if self.wire not in ("fp8", "bf16", "f32"):
            raise ValueError(f"unknown wire format {self.wire}")
        if self.schedule not in ("posthoc", "stream"):
            raise ValueError(f"unknown wire schedule {self.schedule}")
        if self.layered is None:
            object.__setattr__(self, "layered", self.schedule == "stream")
        if self.schedule == "stream" and not self.layered:
            raise ValueError(
                "schedule='stream' needs layer-aligned buckets "
                "(layered=True): the streaming backward emits gradients one "
                "layer at a time, so a bucket spanning layers could only be "
                "sent after all of them, the post-hoc wire in disguise")
        if self.policy is None:
            from repro_torch.dist.opt_state import StatePolicy
            object.__setattr__(self, "policy", StatePolicy())

    @property
    def active(self) -> bool:
        return self.mode != "none"


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One FP8-wire leaf's home in the flat gradient space."""
    index: int          # position in the params tree's flatten order
    path: str           # dotted key path
    offset_rows: int    # first TILE-row inside the bucket
    rows: int           # ceil(size / TILE)
    size: int           # true element count (the last row's tail is pad)
    layer: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Bucket:
    rows: int                       # padded: rows % shard_multiple == 0
    slots: Tuple[LeafSlot, ...]
    stack: Optional[str] = None
    layer: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SensitiveSlot:
    """One bf16-fallback leaf; iterates as (index, path)."""
    index: int
    path: str
    stack: Optional[str] = None

    def __iter__(self):
        yield self.index
        yield self.path


@dataclasses.dataclass(frozen=True)
class GradLayout:
    """The static bucketing of a params tree under a DistPlan."""
    buckets: Tuple[Bucket, ...]
    sensitive: Tuple[SensitiveSlot, ...]
    n_leaves: int

    @property
    def fp8_elems(self) -> int:
        return sum(s.size for b in self.buckets for s in b.slots)

    @property
    def wire_rows(self) -> int:
        return sum(b.rows for b in self.buckets)


def path_str(path) -> str:
    """A key path (a tuple of keys, or a dotted string) as dotted text."""
    if isinstance(path, str):
        return path
    return ".".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


def flatten_with_paths(tree, prefix="", sort=True):
    """[(dotted path, leaf)] in jax's flatten order (dict keys sorted), or
    with sort=False in the dicts' insertion order (the order the plain
    step's leaves are walked in)."""
    if isinstance(tree, dict):
        out = []
        for k in (sorted(tree) if sort else tree):
            out += flatten_with_paths(tree[k],
                                      f"{prefix}.{k}" if prefix else str(k),
                                      sort)
        return out
    return [(prefix, tree)]


def tree_leaves(tree):
    return [leaf for _, leaf in flatten_with_paths(tree)]


def _numel(leaf) -> int:
    return math.prod(leaf.shape) if len(leaf.shape) else 1


def _is_floating(leaf) -> bool:
    dt = leaf.dtype
    if isinstance(dt, torch.dtype):
        return dt.is_floating_point
    return getattr(dt, "kind", "") == "f" or "float" in str(dt)


def is_sensitive(path: str, leaf, plan: DistPlan) -> bool:
    name = path.split(".")[-1]
    if name in SENSITIVE_NAMES:
        return True
    if len(leaf.shape) <= 1:
        return True
    if _numel(leaf) < plan.min_fp8_size:
        return True
    return not _is_floating(leaf)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class _LayerSlice:
    """Shape and dtype of one layer's slice of a stacked (L, ...) leaf:
    what ``is_sensitive`` judges (the per-layer size and rank)."""

    def __init__(self, leaf):
        self.shape = tuple(leaf.shape[1:])
        self.dtype = leaf.dtype


def build_layout(params, plan: DistPlan) -> GradLayout:
    """Static: reads only paths, shapes and dtypes."""
    if plan.layered:
        return _build_layout_layered(params, plan)
    flat = flatten_with_paths(params)
    buckets, slots, sensitive = [], [], []
    cur_rows = 0
    target_rows = max(int(plan.bucket_mb * 2 ** 20) // TILE,
                      plan.shard_multiple)

    def close():
        nonlocal cur_rows, slots
        if slots:
            buckets.append(Bucket(rows=_round_up(cur_rows,
                                                 plan.shard_multiple),
                                  slots=tuple(slots)))
        slots, cur_rows = [], 0

    for i, (p, leaf) in enumerate(flat):
        if is_sensitive(p, leaf, plan):
            sensitive.append(SensitiveSlot(i, p))
            continue
        size = _numel(leaf)
        rows = -(-size // TILE)
        if cur_rows and cur_rows + rows > target_rows:
            close()
        slots.append(LeafSlot(index=i, path=p, offset_rows=cur_rows,
                              rows=rows, size=size))
        cur_rows += rows
    close()
    return GradLayout(buckets=tuple(buckets), sensitive=tuple(sensitive),
                      n_leaves=len(flat))


def _build_layout_layered(params, plan: DistPlan) -> GradLayout:
    """One bucket chain per (stack, layer) in the streaming backward's
    order (main stack last-first, then the dense prologue last-first),
    then the non-stacked FP8 leaves; a bucket never spans a layer."""
    flat = flatten_with_paths(params)
    target_rows = max(int(plan.bucket_mb * 2 ** 20) // TILE,
                      plan.shard_multiple)
    buckets, sensitive = [], []
    stacks = {name: [] for name in STACKED_STACKS}
    other = []
    for i, (p, leaf) in enumerate(flat):
        root = p.split(".")[0]
        (stacks[root] if root in stacks else other).append((i, p, leaf))

    def pack(entries, stack=None, layer=None):
        slots, cur = [], 0
        for i, p, size in entries:
            rows = -(-size // TILE)
            if cur and cur + rows > target_rows:
                buckets.append(Bucket(rows=_round_up(cur, plan.shard_multiple),
                                      slots=tuple(slots), stack=stack,
                                      layer=layer))
                slots, cur = [], 0
            slots.append(LeafSlot(index=i, path=p, offset_rows=cur,
                                  rows=rows, size=size, layer=layer))
            cur += rows
        if slots:
            buckets.append(Bucket(rows=_round_up(cur, plan.shard_multiple),
                                  slots=tuple(slots), stack=stack,
                                  layer=layer))

    for name in ("layers", "dense_layers"):
        group = stacks[name]
        eligible = []
        for i, p, leaf in group:
            view = _LayerSlice(leaf)
            if is_sensitive(p, view, plan):
                # reduced one layer slice at a time, with its layer's buckets
                sensitive.append(SensitiveSlot(i, p, stack=name))
            else:
                eligible.append((i, p, _numel(view)))
        if eligible:
            for layer in range(group[0][2].shape[0] - 1, -1, -1):
                pack(eligible, stack=name, layer=layer)
    tail = []
    for i, p, leaf in other:
        if is_sensitive(p, leaf, plan):
            sensitive.append(SensitiveSlot(i, p))
        else:
            tail.append((i, p, _numel(leaf)))
    pack(tail)
    return GradLayout(buckets=tuple(buckets), sensitive=tuple(sensitive),
                      n_leaves=len(flat))


def streaming_fallback_reason(cfg, layout: Optional[GradLayout] = None,
                              grad_accum: int = 1) -> Optional[str]:
    """Why the streaming wire cannot run this configuration (None when it
    can), the reference's probe: the staged backward drives plain
    decoder-only stacks, and every bucket must align to a layer.
    ``grad_accum`` names no blocker: microbatch gradients accumulate
    locally and each bucket is wired once, from the last microbatch's
    backward."""
    if getattr(cfg, "encdec", False) or getattr(cfg, "frontend",
                                                "none") != "none":
        return ("the staged layer program drives plain decoder-only stacks; "
                "encoder-decoder / frontend architectures keep the post-hoc "
                "wire")
    if layout is not None:
        if not layout.buckets:
            return "no FP8-eligible leaves to bucket (nothing to stream)"
        off = [b for b in layout.buckets if b.layer is None]
        if off:
            return (f"{len(off)} bucket(s) hold non-stacked leaves and "
                    f"cannot align to layer boundaries "
                    f"(e.g. {off[0].slots[0].path})")
    return None


# ---------------------------------------------------------------------------
# Flat space <-> tree.
# ---------------------------------------------------------------------------
def bucket_flat_parts(bucket: Bucket, get_leaf,
                      dtype=torch.float32) -> torch.Tensor:
    """A bucket as its (rows, TILE) flat block, zero-padded at each slot's
    row tail and at the bucket's tail.  `get_leaf(slot)` gives each slot's
    tensor; `dtype` None keeps the leaves' own (one dtype), so a bucket of
    one unpadded leaf is a view of it with no copy."""
    first = get_leaf(bucket.slots[0])
    dt = first.dtype if dtype is None else dtype
    if (len(bucket.slots) == 1 and bucket.rows * TILE == first.numel()
            and first.dtype == dt and first.is_contiguous()):
        return first.reshape(bucket.rows, TILE)
    out = torch.zeros((bucket.rows * TILE,), dtype=dt, device=first.device)
    for s in bucket.slots:
        o = s.offset_rows * TILE
        out[o:o + s.size].copy_(get_leaf(s).reshape(-1))
    return out.reshape(bucket.rows, TILE)


def slot_leaf(s: LeafSlot, leaves):
    """A slot's tensor of a flattened leaf list: the leaf, or a layered
    slot's layer slice of the stacked leaf."""
    leaf = leaves[s.index]
    return leaf if s.layer is None else leaf[s.layer]


def bucket_flat(bucket: Bucket, leaves, dtype=torch.float32) -> torch.Tensor:
    """bucket_flat_parts over a flattened leaf list (layered slots take
    their layer slice)."""
    return bucket_flat_parts(bucket, lambda s: slot_leaf(s, leaves), dtype)


def bucket_scatter(bucket: Bucket, flat: torch.Tensor, like_leaves) -> dict:
    """A bucket's (rows, TILE) block cut back into its leaves:
    {index: tensor of the leaf's shape and dtype} for flat slots and
    {(index, layer): the layer slice} for layered ones."""
    v = flat.reshape(-1)
    out = {}
    for s in bucket.slots:
        ref = like_leaves[s.index]
        shape = ref.shape if s.layer is None else ref.shape[1:]
        x = v[s.offset_rows * TILE:s.offset_rows * TILE + s.size]
        key = s.index if s.layer is None else (s.index, s.layer)
        out[key] = x.reshape(shape).to(ref.dtype)
    return out
