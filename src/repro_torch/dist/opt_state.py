"""FP8-split AdamW optimizer state behind QTensor.

Counterpart of ``repro.dist.opt_state`` (its single-device part).  The
policy keeps, for every leaf it applies to:

  m       e4m3 payload + per-row po2 scale (QTensor, 1.03 B a parameter)
  v       bf16, leaf-shaped (2 B a parameter)
  master  f16 payload + per-row po2 scale (QTensor, ~2.03 B a parameter):
          the row scale restores the exponent range f16 lacks, so the
          payload's 10 mantissa bits sit near the row amax

=> ~5.1 B a parameter of state instead of 12.  An encoded leaf is flat
``(rows, 128)``, zero-padded at the tail, with one scale a row.  Small or
1-D leaves (norms, biases, the router below ``min_size``) keep f32.

The scales are the port's exact po2 (``core/fp8.po2_scale``: the exponent
from the bits of amax / fmax), where the reference takes
``ceil(log2(.))``; the two differ only where f32 ``log2`` lands on the
wrong side of a power of two (ROADMAP.md, Queue 3).

ZeRO-1 (the DistPlan step): each bucket's state is flat (rows, TILE),
and a replica holds only the row block it owns, (rows / P, TILE): the
encodings are per row, so slicing rows slices payload and scales alike
and a shard is self-describing.  ``init_dist_state`` builds a replica's
shards, ``flat_bucket_update`` updates one through the same
``ops.adamw_update`` kernel the per-leaf optimizer runs, and
``Zero1Shardings`` gathers the shards into the full logical state for a
checkpoint and cuts a full state back to any DP size that divides
``shard_multiple``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import casts
from repro_torch.core.fp8 import E4M3, E4M3_MAX, TILE, cast_to, po2_scale
from repro_torch.core.quant import QTensor, _dequantize_nocount
from repro_torch.device import CHUNK_ELEMS

# the encodings: plain leaf-shaped tensors, or (rows, TILE) QTensors
PLAIN_KINDS = {"f32": torch.float32, "bf16": torch.bfloat16}
SCALED_KINDS = {"e4m3": E4M3, "f16": torch.float16}


@dataclasses.dataclass(frozen=True)
class StatePolicy:
    """Optimizer-state dtype policy (``AdamWConfig.state_policy``).

    Kinds: 'f32' | 'bf16' (plain tensors, leaf-shaped) and 'e4m3' | 'f16'
    (QTensor: flat (rows, TILE) payload + per-row po2 scale)."""
    m: str = "e4m3"
    v: str = "bf16"
    master: str = "f16"
    min_size: int = 2048

    def applies(self, leaf) -> bool:
        return leaf.ndim >= 2 and leaf.numel() >= self.min_size


def _rows(x: torch.Tensor) -> torch.Tensor:
    """Flatten any tensor to zero-padded (rows, TILE)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % TILE
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, TILE)


def _row_scale(rows: torch.Tensor, fmt_max: float) -> torch.Tensor:
    amax = rows.abs().amax(dim=-1, keepdim=True).to(torch.float32)
    return po2_scale(amax, fmt_max)


def encode(kind: str, x: torch.Tensor):
    """A tensor (any shape, f32 or bf16) -> its encoded state leaf.  Rows
    are independent, so a large leaf is encoded CHUNK_ELEMS at a time (the
    same bits, the temporaries of a chunk)."""
    if kind in PLAIN_KINDS:
        return x.to(PLAIN_KINDS[kind])
    if kind not in SCALED_KINDS:
        raise ValueError(f"unknown state encoding {kind}")
    rows = _rows(x)
    if kind == "e4m3":
        casts.record("fused_quantize", "opt_state", rows.numel())
    step = CHUNK_ELEMS // TILE
    if rows.shape[0] <= step:
        data, scale = _encode_rows(kind, rows)
        return QTensor(data=data, scale=scale, tile=(1, TILE))
    data = torch.empty(rows.shape, dtype=SCALED_KINDS[kind],
                       device=rows.device)
    scale = torch.empty((rows.shape[0], 1), dtype=torch.float32,
                        device=rows.device)
    for r in range(0, rows.shape[0], step):
        data[r:r + step], scale[r:r + step] = _encode_rows(
            kind, rows[r:r + step])
    return QTensor(data=data, scale=scale, tile=(1, TILE))


def _encode_rows(kind: str, rows: torch.Tensor):
    if kind == "e4m3":
        scale = _row_scale(rows, E4M3_MAX)
        return cast_to(rows.to(torch.float32) / scale), scale
    # payload in (-1, 1]: f16's mantissa sits at the row amax; a po2
    # division is exact, so a bf16 row loses nothing representable
    scale = _row_scale(rows, 1.0)
    if rows.dtype == torch.bfloat16:
        return (rows / scale.to(torch.bfloat16)).to(torch.float16), scale
    return (rows.to(torch.float32) / scale).to(torch.float16), scale


def decode(enc, like_shape, size: int) -> torch.Tensor:
    """An encoded state leaf -> f32 tensor of like_shape."""
    if isinstance(enc, QTensor):
        flat = _dequantize_nocount(enc, torch.float32).reshape(-1)
        return flat[:size].reshape(like_shape)
    return enc.to(torch.float32)


def kind_of(enc) -> str:
    """The encoding of a state leaf."""
    if isinstance(enc, QTensor):
        return "e4m3" if enc.data.dtype == E4M3 else "f16"
    return "f32" if enc.dtype == torch.float32 else "bf16"


def encode_like(x32: torch.Tensor, template):
    """Re-encode an updated f32 value into the template's representation."""
    if isinstance(template, QTensor):
        return encode(kind_of(template), x32)
    return x32.to(template.dtype)


def zeros_encoded(kind: str, like: torch.Tensor):
    """Zero state in the target encoding without an f32 temporary."""
    if kind in PLAIN_KINDS:
        return torch.zeros(like.shape, dtype=PLAIN_KINDS[kind],
                           device=like.device)
    n_rows = -(-like.numel() // TILE)
    return QTensor(data=torch.zeros((n_rows, TILE), dtype=SCALED_KINDS[kind],
                                    device=like.device),
                   scale=torch.ones((n_rows, 1), dtype=torch.float32,
                                    device=like.device),
                   tile=(1, TILE))


# ---------------------------------------------------------------------------
# ZeRO-1 flat bucket state.
# ---------------------------------------------------------------------------
def _owned_rows(rows: int, n_dp: int, rank: int) -> slice:
    r = rows // n_dp
    return slice(rank * r, (rank + 1) * r)


def bucket_dtype(bucket, leaves) -> torch.dtype:
    """The dtype a bucket's params flatten in: f32 when any slot's leaf is
    f32 (only the owned shard is widened), else the leaves' (bf16)."""
    if any(leaves[s.index].dtype == torch.float32 for s in bucket.slots):
        return torch.float32
    return leaves[bucket.slots[0].index].dtype


def init_dist_state(opt, params, layout, plan, n_dp: int = 1,
                    rank: int = 0):
    """{'step', 'flat': per bucket {'m', 'v'[, 'master']} over this
    replica's (rows / n_dp, TILE) rows, 'sens': f32 {'m', 'v'[,
    'master']} by leaf path} (the reference's, with the flat state held as
    this replica's shards)."""
    from repro_torch.dist.plan import bucket_flat, flatten_with_paths
    pol = plan.policy
    flat_leaves = flatten_with_paths(params)
    leaves = [leaf.detach() for _, leaf in flat_leaves]
    flat = []
    for b in layout.buckets:
        own = _owned_rows(b.rows, n_dp, rank)
        dev = leaves[b.slots[0].index].device
        like = torch.empty((b.rows // n_dp, TILE), device=dev)
        st = {"m": zeros_encoded(pol.m, like),
              "v": zeros_encoded(pol.v, like)}
        if opt.master_weights:
            base = bucket_flat(b, leaves, bucket_dtype(b, leaves))[own]
            st["master"] = encode(pol.master, base)
        flat.append(st)
    sens_leaves = {p: leaves[i] for i, p in layout.sensitive}

    def f32_zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)

    sens = {"m": {p: f32_zeros(t) for p, t in sens_leaves.items()},
            "v": {p: f32_zeros(t) for p, t in sens_leaves.items()}}
    if opt.master_weights:
        sens["master"] = {p: t.to(torch.float32, copy=True)
                          for p, t in sens_leaves.items()}
    return {"step": 0, "flat": tuple(flat), "sens": sens}


def flat_bucket_update(opt, st, owned_g32, clip, lr, b1c, b2c, p_shard,
                       skip=None, skip_mask: int = 0) -> None:
    """AdamW on one owned ZeRO-1 shard, in place: `owned_g32` (rows/P,
    TILE) the mean-reduced f32 gradient, `p_shard` the owned rows of the
    bucket's params (written with the new values; read as the base
    without master weights).  One ``ops.adamw_update`` launch a
    CHUNK_ELEMS chunk: the kernel on the card, its twin on the CPU."""
    from repro_torch.optim.adamw import update_leaf
    update_leaf(opt, lr, b1c, b2c, p_shard, owned_g32, clip, st["m"],
                st["v"], st.get("master"), skip, skip_mask)


class Zero1Shardings:
    """The ZeRO-1 flat state between replicas and checkpoints.

    ``full(state)`` gathers every bucket's shards over the data group
    into the full (rows, TILE) state (a collective: every replica calls
    it); ``template(state)`` is a full-size tree to restore a checkpoint
    into; ``shard(full, state)`` copies this replica's rows of a full
    state into the live shards; ``barrier()`` holds every replica until
    the first one's write has landed.  Bucket rows pad to the DistPlan's
    shard_multiple, so a full state cut for any n_dp dividing it gives
    equal shards: a checkpoint saved at one DP size restores at another
    bit for bit."""

    def __init__(self, n_dp: int, rank: int, group=None):
        self.n_dp, self.rank, self.group = n_dp, rank, group

    @property
    def writer(self) -> bool:
        """The group's first replica writes the gathered state."""
        return self.rank == 0

    def barrier(self) -> None:
        from repro_torch.dist import comm
        comm.barrier(self.group)

    def _map_flat(self, state, fn):
        out = dict(state)
        out["opt"] = dict(state["opt"])
        out["opt"]["flat"] = tuple({k: fn(enc) for k, enc in st.items()}
                                   for st in state["opt"]["flat"])
        return out

    def full(self, state):
        from repro_torch.dist import comm

        def gather(enc):
            if isinstance(enc, QTensor):
                return QTensor(comm.all_gather(enc.data, self.group),
                               comm.all_gather(enc.scale, self.group),
                               enc.tile)
            return comm.all_gather(enc, self.group)
        return self._map_flat(state, gather)

    def template(self, state):
        n = self.n_dp

        def grow(enc):
            if isinstance(enc, QTensor):
                return QTensor(enc.data.new_empty((enc.data.shape[0] * n,
                                                   *enc.data.shape[1:])),
                               enc.scale.new_empty((enc.scale.shape[0] * n,
                                                    *enc.scale.shape[1:])),
                               enc.tile)
            return enc.new_empty((enc.shape[0] * n, *enc.shape[1:]))
        return self._map_flat(state, grow)

    @torch.no_grad()
    def shard(self, full, state):
        """Copy this replica's rows of `full`'s flat state into `state`'s
        shards in place, and its step.  A ``template(state)`` shares every
        other leaf with `state`, so restoring into it has already written
        them."""
        for st, fst in zip(state["opt"]["flat"], full["opt"]["flat"]):
            for k, enc in st.items():
                fe = fst[k]
                if isinstance(enc, QTensor):
                    own = _owned_rows(fe.data.shape[0], self.n_dp, self.rank)
                    enc.data.copy_(fe.data[own])
                    enc.scale.copy_(fe.scale[own])
                else:
                    enc.copy_(fe[_owned_rows(fe.shape[0], self.n_dp,
                                             self.rank)])
        state["opt"]["step"] = full["opt"]["step"]
        return state


def state_bytes_model(n_params: int, pol: StatePolicy,
                      master_weights: bool = True) -> float:
    """Bytes of optimizer state under the policy (memory accounting)."""
    per = {"f32": 4.0, "bf16": 2.0,
           "e4m3": 1.0 + 4.0 / TILE, "f16": 2.0 + 4.0 / TILE}
    total = per[pol.m] + per[pol.v]
    if master_weights:
        total += per[pol.master]
    return total * n_params
