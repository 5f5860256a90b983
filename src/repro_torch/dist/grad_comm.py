"""The quantized data-parallel gradient wire.

Counterpart of ``repro.dist.grad_comm``.  One bucket is ONE uint8
message: the e4m3 payload rows and their int8 po2 exponents side by side,
(rows, TILE + 1) bytes, so a bucket's reduce-scatter is one collective
and (1 + 1/TILE) bytes a gradient element instead of 2 (bf16) or 4 (f32).

Reduction (mode='zero1'):
  1. every replica quantizes its LOCAL bucket with the agreed po2 scale
     (``scale_sync.agreed_po2_scale``: a MAX of the per-row amax);
  2. the message is reduce-scattered: one all-to-all of its P row blocks;
  3. each replica dequantizes the P received blocks EXACTLY (shared po2
     scales) and sums them in f32, then divides by P (the mean);
  4. the owned f32 shard feeds the ZeRO-1 update directly, never
     re-quantized: the DP axis adds one quantization a replica and no
     double quantization error.

Sensitive leaves take ``reduce_sensitive``: a bf16 all-reduce (f32 under
wire='f32'), the result replicated.  The quantize is plain PyTorch, as
the reference's is XLA (no ``pallas_call``); a fused CUDA wire kernel is
a speed item (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.core import casts
from repro_torch.core.fp8 import E4M3, TILE, cast_to
from repro_torch.device import CHUNK_ELEMS
from repro_torch.dist import comm, scale_sync
from repro_torch.obs.trace import annotate

_E4M3_BYTES = 1
_EXP_BYTES = 1


def pack_bucket(payload: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """(rows, TILE) e4m3 + (rows, 1) int8 -> (rows, TILE + 1) uint8."""
    return torch.cat([payload.contiguous().view(torch.uint8),
                      exp.contiguous().view(torch.uint8)], dim=-1)


def unpack_bucket(msg: torch.Tensor):
    """Inverse of pack_bucket (any leading axes): (payload, exp) copies."""
    payload = msg[..., :TILE].contiguous().view(E4M3)
    exp = msg[..., TILE:].contiguous().view(torch.int8)
    return payload, exp


def _quantize_rows(flat: torch.Tensor, scale: torch.Tensor):
    """flat / scale cast to e4m3, CHUNK_ELEMS at a time (rows are
    independent: the same bits, a chunk's f32 temporaries)."""
    out = torch.empty(flat.shape, dtype=E4M3, device=flat.device)
    step = max(CHUNK_ELEMS // TILE, 1)
    for r in range(0, flat.shape[0], step):
        x = flat[r:r + step].to(torch.float32) / scale[r:r + step]
        out[r:r + step] = cast_to(x)
    return out


def quantize_bucket(flat: torch.Tensor, group):
    """Quantize a (rows, TILE) bucket with the AGREED per-row po2 scale.
    Returns (payload e4m3, exp int8 (rows, 1)), scale-identical across the
    group.  Recorded as a fused cast (part of the wire, not a counted
    Fig.-2 activation cast); the quant stats see it as 'dp_wire'; the wire
    faults (``payload_bitflip``, ``wire_scale``) poison it here."""
    from repro_torch.core import quant
    from repro_torch.runtime import fault_injection
    casts.record("fused_quantize", "dp_wire", flat.numel())
    scale = scale_sync.agreed_po2_scale(flat, group)
    payload = _quantize_rows(flat, scale)
    if quant.stats_armed():
        quant._maybe_record_stats("dp_wire", flat.to(torch.float32) / scale,
                                  payload, 448.0)
    payload = fault_injection.apply("wire_payload", "dp_wire", payload)
    exp = fault_injection.apply("wire_exp", "dp_wire",
                                scale_sync.scale_to_exp_i8(scale))
    return payload, exp


def _dequant_sum(pay: torch.Tensor, exps: torch.Tensor) -> torch.Tensor:
    """(P, r, TILE) e4m3 with (P, r, 1) exponents -> (r, TILE) f32 sum
    over P, each block dequantized exactly, summed in block order."""
    scales = scale_sync.exp_i8_to_scale(exps)
    out = pay[0].to(torch.float32) * scales[0]
    for i in range(1, pay.shape[0]):
        out.add_(pay[i].to(torch.float32) * scales[i])
    return out


def reduce_scatter_bucket(flat: torch.Tensor, group, n_shards: int,
                          wire: str, guard=None):
    """(rows, TILE) local grads -> (rows / n_shards, TILE) owned f32 MEAN;
    this replica owns the row block at its index in the group.  rows must
    divide n_shards (plan.py pads to shard_multiple).

    `guard` (a ``train.guards.GuardPlan``) arms the wire guard: the
    received exponents and payload are checked first
    (``scale_sync.wire_anomaly``, the same on every replica) and a
    poisoned bucket takes the bf16 all-reduce of the LOCAL pre-quantize
    gradient instead, sliced to the owned rows.  Returns (owned, bad)
    when guarded."""
    rows = flat.shape[0]
    if rows % n_shards:
        raise ValueError(f"{rows} bucket rows over {n_shards} shards")
    with annotate(f"wire/rs_bucket_{wire}"):
        return _reduce_scatter_bucket(flat, group, n_shards, wire, guard)


def _owned_slice(t: torch.Tensor, group, n_shards: int) -> torch.Tensor:
    rows_l = t.shape[0] // n_shards
    idx = comm.rank(group)
    return t[idx * rows_l:(idx + 1) * rows_l]


class InFlight:
    """A bucket's reduce-scatter on the wire (``issue_reduce_scatter``):
    its message in flight (an ``async_op`` all-to-all) and the local
    gradient the guard's fallback would send.  ``bad()`` is the wire
    guard's verdict on the received message (a device bool, the same on
    every replica: a collective), ``finish(bad)`` the owned f32 mean,
    through the bf16 fallback where ``bad`` (a host bool) says so."""

    def __init__(self, flat, group, n_shards, wire, pending):
        self.flat, self.group, self.n_shards = flat, group, n_shards
        self.wire, self.pending = wire, pending
        self._msg = None

    def _received(self):
        if self._msg is None:
            self._msg = self.pending.wait()
            self.pending = None
        return self._msg

    def _blocks(self):
        rows = self.flat.shape[0] // self.n_shards
        if self.wire == "fp8":
            return unpack_bucket(self._received().reshape(
                self.n_shards, rows, TILE + _EXP_BYTES))
        return self._received().reshape(self.n_shards, rows, TILE)

    def bad(self, guard) -> torch.Tensor:
        if self.wire != "fp8":
            return torch.zeros((), dtype=torch.bool, device=self.flat.device)
        pay, exps = self._blocks()
        return scale_sync.wire_anomaly(exps, pay, self.group,
                                       guard.wire_exp_limit)

    def finish(self, bad: bool = False) -> torch.Tensor:
        n = self.n_shards
        if bad:
            # the bf16 all-reduce wire, sliced to the owned rows
            g = comm.all_reduce_(self.flat.to(torch.bfloat16), self.group)
            owned = _owned_slice(g, self.group, n).to(torch.float32)
        elif self.wire == "fp8":
            pay, exps = self._blocks()
            owned = _dequant_sum(pay, exps)
        else:
            blocks = self._blocks()
            owned = blocks[0].to(torch.float32)
            for i in range(1, n):
                owned = owned + blocks[i].to(torch.float32)
        self.flat = self._msg = None
        return owned / n


def issue_reduce_scatter(flat: torch.Tensor, group, n_shards: int,
                         wire: str) -> InFlight:
    """Put a (rows, TILE) bucket on the wire and return at once: the
    agreed-scale quantize and the pack (fp8) or the cast (bf16 / f32),
    then the all-to-all with ``async_op``.  The streaming schedule issues
    each bucket inside the backward and finishes them after it."""
    rows = flat.shape[0]
    if rows % n_shards:
        raise ValueError(f"{rows} bucket rows over {n_shards} shards")
    if wire == "fp8":
        payload, exp = quantize_bucket(flat, group)
        msg = pack_bucket(payload, exp)
    else:
        msg = flat.to(torch.bfloat16 if wire == "bf16" else torch.float32)
    return InFlight(flat, group, n_shards, wire,
                    comm.all_to_all(msg, group, async_op=True))


def _reduce_scatter_bucket(flat, group, n_shards, wire, guard):
    inflight = issue_reduce_scatter(flat, group, n_shards, wire)
    if guard is None:
        return inflight.finish()
    bad = inflight.bad(guard)
    return inflight.finish(bool(bad)), bad


def all_gather_shard(shard: torch.Tensor, group) -> torch.Tensor:
    """ZeRO-1's epilogue: the updated (rows / P, TILE) param shards
    gathered back into the (rows, TILE) bucket (in the bucket's param
    dtype: bf16, or f32 for a bucket holding an f32 leaf)."""
    return comm.all_gather(shard, group)


def reduce_sensitive(g: torch.Tensor, group, n_shards: int,
                     wire: str) -> torch.Tensor:
    """A sensitive leaf's reduction: cast to the fallback wire's dtype,
    all-reduce, mean (f32 wire: full precision)."""
    with annotate("wire/sensitive_psum"):
        wdtype = torch.float32 if wire == "f32" else torch.bfloat16
        gw = g.to(wdtype)
        if gw is g:
            gw = gw.clone()
        gw = comm.all_reduce_(gw.contiguous(), group)
        return gw.to(torch.float32) / n_shards


# ---------------------------------------------------------------------------
# Bytes on the wire: what one device puts on the interconnect for the
# gradient reduction, by the standard ring factors (an all-reduce moves
# 2(P-1)/P of its buffer, a reduce-scatter and an all-gather (P-1)/P).
# ---------------------------------------------------------------------------
def wire_grad_bytes(n_elems: int, n_shards: int, wire: str,
                    mode: str = "zero1") -> float:
    P = max(n_shards, 1)
    ring = (P - 1) / P
    rows = -(-n_elems // TILE)
    if mode == "zero1":
        if wire == "fp8":
            payload = rows * TILE * _E4M3_BYTES + rows * _EXP_BYTES
            # amax agreement: ring all-reduce (max) of per-row f32 amax
            agree = 2 * ring * rows * 4
            return ring * payload + agree
        width = 2 if wire == "bf16" else 4
        return ring * rows * TILE * width
    width = 2 if wire == "bf16" else 4
    return 2 * ring * n_elems * width


def wire_param_bytes(n_elems: int, n_shards: int,
                     param_bytes: int = 2) -> float:
    """ZeRO-1's all-gather of the updated params (bf16), any wire."""
    P = max(n_shards, 1)
    return (P - 1) / P * n_elems * param_bytes


def stream_exposed_us(bucket_us, overlap_us) -> float:
    """Exposed DP-wire time of the streaming schedule (the reference's
    model): bucket i's wire time drains against the backward compute
    issued after it; what is still in flight when the compute runs out is
    exposed (the post-hoc schedule exposes sum(bucket_us))."""
    inflight = 0.0
    for b_us, c_us in zip(bucket_us, overlap_us):
        inflight = max(0.0, inflight + float(b_us) - float(c_us))
    return inflight
