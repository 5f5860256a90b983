"""Tile-quantized FP8 tensors (QTensor) and the quantize/dequantize ops.

Counterpart of ``repro.core.quant``'s quantizers: per-tile scales over
128 contiguous elements (paper Eq. 2), po2 by default or linear
(``scale_mode="linear"``, s = amax / 448: the conventional recipe of the
``blockwise`` and ``naive_fp8`` baselines), the same normative tile
convention, the cast-ledger records and the guardrails' quant-stats
collector (below), and the names under which the activation-residency
plan (``train/memory.py``) keeps a tensor (``tag_saveable``,
``tag_qtensor``).

Tile-metadata convention (as in the reference):

  * ``len(tile) == data.ndim``; leading batch/expert axes get explicit 1s.
  * Row-wise tiles are ``(1,) * (ndim - 1) + (TILE,)`` -- ``row_tile``.
  * Weight blocks are ``(1,) * (ndim - 2) + (TILE, TILE)``.
  * ``scale.shape[i] * tile[i] == data.shape[i]`` for every axis.

These are the plain PyTorch quantizers, used for weights, KV pages and
``double_quant_error``.  The activation quantizes on the MoE path run
through the hand-written kernel in ``repro_torch.kernels`` (same
function, same bits).

The FP8 health stats of the numerics guardrails (``train/guards.py``)
are collected here, as in the reference: while a collector is armed
(``collect_stats()``), the entry quantize sites record a (N_SITES, 2) f32
matrix whose row is [saturation fraction, underflow-flush fraction] of
their tensor, max-merged across records.  PyTorch runs eagerly, so the
records are plain tensors on the device and need none of the reference's
threading through scans and shard_maps; the sites record outside the
autograd Functions (``core/linear.dense_mlp``, ``core/moe.moe_block``),
plain reductions that run only while armed.  The ``dp_wire`` row is the
DP wire's bucket quantize (``dist/grad_comm.quantize_bucket``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.core import casts
from repro_torch.core.fp8 import (E4M3, E4M3_MAX, TILE, cast_to,
                                  linear_scale, po2_scale)
from repro_torch.device import CHUNK_ELEMS


@dataclasses.dataclass(frozen=True)
class QTensor:
    data: torch.Tensor            # e4m3 payload
    scale: torch.Tensor           # f32 po2 or linear scales, one per tile
    tile: Tuple[int, ...]

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    def to(self, device) -> "QTensor":
        return QTensor(self.data.to(device), self.scale.to(device), self.tile)


def row_tile(ndim: int) -> Tuple[int, ...]:
    return (1,) * (ndim - 1) + (TILE,)


def _scale_shape(shape, tile):
    if len(shape) != len(tile):
        raise ValueError(f"tile {tile} does not match shape {shape}")
    for s, t in zip(shape, tile):
        if s % t:
            raise ValueError(f"shape {tuple(shape)} not divisible by tile {tile}")
    return tuple(s // t for s, t in zip(shape, tile))


def _split_shape(shape, tile):
    """(n0, n1, ...) -> interleaved (n0/t0, t0, ...) with 1s for the scale."""
    xs, ss = [], []
    for n, t in zip(shape, tile):
        if t == 1:
            xs.append(n)
            ss.append(n)
        else:
            xs.extend((n // t, t))
            ss.extend((n // t, 1))
    return tuple(xs), tuple(ss)


def _tiled_op(x, scale, tile, op):
    """x <op> per-tile scale by reshape-broadcast (no upsampled copy)."""
    xs, ss = _split_shape(x.shape, tile)
    return op(x.reshape(xs), scale.reshape(ss)).reshape(x.shape)


def _tile_amax(x: torch.Tensor, tile) -> torch.Tensor:
    """amax over each tile, computed in the input dtype (max is exact in any
    float format) and widened to f32 at the reduced size."""
    _scale_shape(x.shape, tile)
    xs, _ = _split_shape(x.shape, tile)
    red, i = [], 0
    for n, t in zip(x.shape, tile):
        if t == 1:
            i += 1
        else:
            red.append(i + 1)
            i += 2
    y = x.reshape(xs).abs()
    return y.amax(dim=tuple(red)).to(torch.float32) if red else \
        y.to(torch.float32)


def compute_scale(x: torch.Tensor, tile, scale_mode: str = "po2"
                  ) -> torch.Tensor:
    if scale_mode == "po2":
        return po2_scale(_tile_amax(x, tile))
    if scale_mode == "linear":
        return linear_scale(_tile_amax(x, tile))
    raise ValueError(f"scale_mode {scale_mode!r}: 'po2' or 'linear'")


def quantize_fields(x: torch.Tensor, tile, scale_mode: str = "po2"):
    """(payload e4m3, scales) of x under `tile`, without a ledger record.
    With po2 scales a bf16 input is divided in bf16: division by a power
    of two is exact there, and bf16 -> e4m3 rounds as f32 -> e4m3 (same
    bits as the f32 route at half the temporary bytes).  A linear scale
    divides the f32-widened input, as the reference does (quant.py:342-349):
    the bf16 shortcut is exact only for po2.  Tiles never span the leading
    axis when tile[0] == 1, so a tensor larger than CHUNK_ELEMS (the
    (E, K, N) expert weights) is quantized a slice of experts at a time,
    with the same bits and temporaries of a slice, not of the whole leaf."""
    if x.ndim >= 3 and tile[0] == 1 and x.numel() > CHUNK_ELEMS:
        step = max(1, CHUNK_ELEMS // (x.numel() // x.shape[0]))
        data = torch.empty(x.shape, dtype=E4M3, device=x.device)
        scale = torch.empty(_scale_shape(x.shape, tile), dtype=torch.float32,
                            device=x.device)
        for i in range(0, x.shape[0], step):
            data[i:i + step], scale[i:i + step] = _quantize_fields(
                x[i:i + step], tile, scale_mode)
        return data, scale
    return _quantize_fields(x, tile, scale_mode)


def _quantize_fields(x: torch.Tensor, tile, scale_mode: str):
    scale = compute_scale(x, tile, scale_mode)
    if x.dtype == torch.bfloat16 and scale_mode == "po2":
        xf = _tiled_op(x, scale.to(torch.bfloat16), tile, torch.div)
    else:
        xf = _tiled_op(x.to(torch.float32), scale, tile, torch.div)
    return cast_to(xf), scale


def quantize(x: torch.Tensor, tile, scale_mode: str = "po2", tag: str = "q",
             kind: str = "quantize") -> QTensor:
    """Quantize a dense tensor to per-tile fp8; counted on the CastLedger."""
    casts.record(kind, tag, x.numel())
    data, scale = quantize_fields(x, tile, scale_mode)
    return QTensor(data=data, scale=scale, tile=tuple(tile))


def quantize_rowwise(x: torch.Tensor, scale_mode="po2", tag="q_row",
                     kind="quantize") -> QTensor:
    """1 x TILE tiles along the last axis (Fprop/Dgrad activation layout)."""
    return quantize(x, row_tile(x.ndim), scale_mode, tag=tag, kind=kind)


def quantize_colwise(x: torch.Tensor, scale_mode="po2",
                     tag="q_col") -> QTensor:
    """TILE x 1 tiles along the second-to-last axis (Wgrad layout,
    untransposed)."""
    return quantize(x, (1,) * (x.ndim - 2) + (TILE, 1), scale_mode, tag=tag)


def quantize_blockwise(w: torch.Tensor, scale_mode="po2",
                       tag="q_wblk") -> QTensor:
    """TILE x TILE blocks over the last two axes (weight layout)."""
    return quantize(w, (1,) * (w.ndim - 2) + (TILE, TILE), scale_mode,
                    tag=tag)


def dequantize(q: QTensor, dtype=torch.bfloat16, tag: str = "dq",
               kind: str = "dequantize") -> torch.Tensor:
    casts.record(kind, tag, q.data.numel())
    return _dequantize_nocount(q, dtype)


def _dequantize_nocount(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    if dtype == torch.bfloat16:
        # e4m3 -> bf16 is exact, and x * po2 is exact in bf16
        return _tiled_op(q.data.to(torch.bfloat16),
                         q.scale.to(torch.bfloat16), q.tile, torch.mul)
    return _tiled_op(q.data.to(torch.float32), q.scale, q.tile,
                     torch.mul).to(dtype)


# ---------------------------------------------------------------------------
# Names for the activation-residency plan (train/memory.py).  A policy
# keeps the tensors tagged with its names across the forward/backward
# boundary: 'full' the BF16 stage boundaries, 'fp8_resident' only the
# QTensor stage outputs.  The reference names them for jax.checkpoint's
# save_only_these_names; the port's plan keeps them in a per-block stash
# (the tags' producers run eagerly, so a tensor is kept as it was made:
# no precision pin is needed for a kept and a recomputed tensor to agree).
# In the block's recompute the tag hands back the kept tensor, and
# ``kept`` / ``kept_qtensor`` let a producer skip its work altogether.
# ---------------------------------------------------------------------------
FP8_SAVE_NAMES = ("fp8_qx_data", "fp8_qx_scale",      # dispatched FFN input
                  "fp8_qa_data", "fp8_qa_scale")      # post-activation GEMM2 in
BF16_STAGE_NAMES = ("stage_attn_out",                 # attn residual-out
                    "stage_ffn_in",                   # post-ln2 FFN input
                    "stage_ffn_h",                    # the bf16 island h
                    "stage_expert_out")               # expert out (combine in)

# the active checkpoint block's stash (train/memory.py), None outside one
_RESIDENCY: contextvars.ContextVar = contextvars.ContextVar("residency",
                                                           default=None)


def tag_saveable(x, name: str):
    """Name a tensor for the residency policies (None passes).  Outside a
    plan's block, or where the block's policy does not keep `name`, x
    itself; in the block's forward x is kept; in its recompute the kept
    tensor comes back in x's place (the same bits)."""
    st = _RESIDENCY.get()
    if x is None or st is None:
        return x
    return st.keep(name, x)


def tag_qtensor(q: "QTensor", name: str) -> "QTensor":
    """Tag a QTensor's payload and scales as '<name>_data' / '<name>_scale'
    (the e4m3 payload is kept as it is: 1 byte an element)."""
    if _RESIDENCY.get() is None:
        return q
    return QTensor(tag_saveable(q.data, f"{name}_data"),
                   tag_saveable(q.scale, f"{name}_scale"), q.tile)


@contextlib.contextmanager
def residency(stash):
    """Make `stash` (train/memory.py) the active block's for the block."""
    tok = _RESIDENCY.set(stash)
    try:
        yield stash
    finally:
        _RESIDENCY.reset(tok)


def kept(name: str):
    """In a block's recompute, the next tensor its forward kept under
    `name` (the producer then skips its work); None otherwise."""
    st = _RESIDENCY.get()
    return None if st is None else st.replay(name)


def kept_qtensor(name: str, tile) -> Optional["QTensor"]:
    """``kept`` for a QTensor tagged by ``tag_qtensor``."""
    data = kept(f"{name}_data")
    if data is None:
        return None
    return QTensor(data, kept(f"{name}_scale"), tile)


# ---------------------------------------------------------------------------
# FP8 health stats for the numerics guardrails (train/guards.py).
# ---------------------------------------------------------------------------
STATS_LEN = 2                      # [sat_frac, flush_frac], max-merged
# Instrumented quantize sites, one row of the collected matrix each.
STAT_SITES = ("q_entry_mlp",       # dense-MLP / shared-expert entry quantize
              "q_entry_moe",       # MoE dispatch entry quantize
              "dp_wire")           # DP gradient-wire bucket quantize
N_SITES = len(STAT_SITES)
_SITE_ROW = {t: i for i, t in enumerate(STAT_SITES)}
STATS_TAGS = frozenset(_SITE_ROW)

_QSTATS: contextvars.ContextVar[Optional["QuantStatsCollector"]] = \
    contextvars.ContextVar("quant_stats", default=None)


class QuantStatsCollector:
    def __init__(self):
        self.vals: List[torch.Tensor] = []


def stats_armed() -> bool:
    return _QSTATS.get() is not None


def zero_stats(device="cpu") -> torch.Tensor:
    return torch.zeros((N_SITES, STATS_LEN), dtype=torch.float32,
                       device=device)


def site_maxima(stats: torch.Tensor) -> torch.Tensor:
    """(N_SITES, STATS_LEN) -> (STATS_LEN,) max over sites: the scalar
    [sat_frac, flush_frac] pair the guard thresholds compare against."""
    return stats.to(torch.float32).amax(dim=0)


def record_stat_pair(tag: str, sat_frac, flush_frac) -> None:
    col = _QSTATS.get()
    if col is not None:
        pair = torch.stack([torch.as_tensor(sat_frac, dtype=torch.float32),
                            torch.as_tensor(flush_frac,
                                            dtype=torch.float32)])
        row = zero_stats(pair.device)
        row[_SITE_ROW[tag]] = pair
        col.vals.append(row)


def drain_stats(device="cpu") -> torch.Tensor:
    """Max-merge and clear the collected stats (zeros if none)."""
    col = _QSTATS.get()
    if col is None or not col.vals:
        return zero_stats(device)
    out = col.vals[0]
    for v in col.vals[1:]:
        out = torch.maximum(out, v)
    col.vals.clear()
    return out


@contextlib.contextmanager
def collect_stats():
    col = QuantStatsCollector()
    tok = _QSTATS.set(col)
    try:
        yield col
    finally:
        _QSTATS.reset(tok)


@contextlib.contextmanager
def stats_muted():
    """No site records inside the block (a checkpoint block's recompute:
    its forward recorded already)."""
    tok = _QSTATS.set(None)
    try:
        yield
    finally:
        _QSTATS.reset(tok)


def _maybe_record_stats(tag: str, xf, data, fmax: float) -> None:
    """sat = pre-clip overflow fraction; flush = nonzero inputs whose fp8
    encoding flushed to zero.  `xf` is the already-scaled tensor, `data`
    its fp8 payload."""
    if _QSTATS.get() is None or tag not in STATS_TAGS:
        return
    xa = xf.to(torch.float32).abs()
    # a mean as XLA computes jnp.mean here: the count times the f32
    # reciprocal of the size (torch's CPU mean divides instead)
    inv = 1.0 / xa.numel()
    sat = (xa > fmax).to(torch.float32).sum() * inv
    flush = ((data.to(torch.float32) == 0) & (xa > 0)).to(
        torch.float32).sum() * inv
    record_stat_pair(tag, sat, flush)


@torch.no_grad()
def record_entry_stats(tag: str, x: torch.Tensor,
                       q: Optional[QTensor] = None,
                       scale_mode: str = "po2") -> None:
    """Record sat/flush for a forward entry quantize from its call site.
    With `q` laid out as x (quantize_entry's return) its payload and
    scales are reused; without (the MoE dispatch returns a permuted,
    padded QTensor) the row-wise scales and payload are recomputed, only
    while a collector is armed."""
    if _QSTATS.get() is None or tag not in STATS_TAGS:
        return
    tile = row_tile(x.ndim)
    scale = compute_scale(x, tile, scale_mode) if q is None else q.scale
    xf = _tiled_op(x.to(torch.float32), scale, tile, torch.div)
    data = q.data if q is not None else cast_to(xf)
    _maybe_record_stats(tag, xf, data, E4M3_MAX)
