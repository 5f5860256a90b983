"""Casting-free KV page migration: the wire codec for prefill/decode
disaggregation.

Counterpart of ``repro.serve.transfer``.  The paged KV pool stores e4m3
payloads and per-row po2 scales, so a page is already the cheapest wire
format, and moving it is a pure bitcast.  For each page batch the codec
packs, for every (stack, k/v) pool in the reference's order (sorted
stacks, then k, then v):

  * the payload bytes verbatim (a uint8 view; a bf16 pool's two bytes a
    value follow each other, little-endian, as the reference's ``_u8``
    lays them out), then
  * the f32 po2 scales as int8 exponents through the ``dist/scale_sync``
    bit codec (shift and bias on the f32 bit pattern),

into one host uint8 message: header, then payload.  For the same pools
and meta the message is the reference's byte for byte.  The receiver
writes the bytes back through uint8 views into its own pool in place, so
a migrated page is bit for bit the donor's page.

``assert_casting_free`` proves that no quantize and no dequantize rides
the migration: it runs the codec's gather and scatter under a
``TorchDispatchMode`` that sees every aten op, and fails on any op that
touches a floating-point or float8 tensor and is not pure data movement
(the port's counterpart of the reference's jaxpr walk).

Page batches are padded to a power-of-two bucket with the scratch page
(never read back), as the reference's are.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist.scale_sync import (exp_i8_to_scale_bits,
                                         scale_to_exp_i8_bits)
from repro_torch.serve.paged_kv import SCRATCH_PAGE

_MAGIC = 0x4B56_5747          # "KVWG": KV wire, guarded by a header check
_VERSION = 1

# aten ops that may touch floating-point tensors inside the codec: pure
# data movement.  Numeric work (the abs / amax / div of a quantize, the
# widening of a dequantize) is absent, so the check is structural.
_DATA_MOVEMENT = frozenset({
    "index", "index_put_", "_index_put_impl_", "view", "_unsafe_view",
    "slice", "select", "cat", "copy_", "clone", "expand", "reshape",
    "alias", "detach", "lift_fresh", "_to_copy",
})


def _is_float(dt: torch.dtype) -> bool:
    return dt.is_floating_point or dt.is_complex


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class _OpLog(TorchDispatchMode):
    """Records (op name without its overload, dtypes of its tensor
    arguments, dtypes of its results) for every aten op run under it."""

    def __init__(self):
        super().__init__()
        self.ops: List[Tuple[str, tuple, tuple]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        self.ops.append((name,
                         tuple(t.dtype for t in _tensors((args, kwargs))),
                         tuple(t.dtype for t in _tensors(out))))
        return out


def check_casting_free(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` and raise AssertionError if any aten op
    it ran did numeric work on a floating-point (or float8) tensor.  Floats
    may only flow through data movement; ``_to_copy`` only keeps its dtype
    (a device move); integer arithmetic is free.  Returns fn's result."""
    with _OpLog() as log:
        out = fn(*args, **kwargs)
    for name, ins, outs in log.ops:
        dts = ins + outs
        if not any(_is_float(d) for d in dts):
            continue
        assert name in _DATA_MOVEMENT, \
            f"codec is not casting-free: `{name}` on {dts}"
        if name == "_to_copy":
            assert len(set(dts)) == 1, \
                f"codec is not casting-free: `{name}` casts {dts}"
    return out


def _bucket(n: int) -> int:
    """Next power-of-two page-batch bucket (0 stays 0)."""
    return 1 << max(0, n - 1).bit_length() if n else 0


@dataclasses.dataclass(frozen=True)
class TransferMeta:
    """Per-migration header fields (int32 words on the wire).  The prompt
    tokens are the radix identity: the receiver re-shares the shipped pages
    by inserting the prompt's full-block prefix into its own tree."""
    rid: int
    n_pages: int                  # real page count (<= the padded bucket)
    page_size: int
    bytes_per_page: int           # geometry fingerprint (fleet must agree)
    pos: int                      # tokens prefilled (== len(prompt))
    max_new_tokens: int
    temperature: float            # rides the wire as raw f32 bits
    prompt: Tuple[int, ...]
    generated: Tuple[int, ...]    # tokens sampled so far (the prefill token)

    _N_HEAD = 11                  # header words before the token arrays

    def to_bytes(self) -> np.ndarray:
        tbits = int(np.float32(self.temperature).view(np.int32))
        head = np.array([_MAGIC, _VERSION, self.rid, self.n_pages,
                         self.page_size, self.bytes_per_page, self.pos,
                         self.max_new_tokens, tbits,
                         len(self.prompt), len(self.generated)], np.int32)
        words = np.concatenate([head,
                                np.asarray(self.prompt, np.int32),
                                np.asarray(self.generated, np.int32)])
        return words.view(np.uint8)

    @classmethod
    def from_bytes(cls, msg: np.ndarray) -> Tuple["TransferMeta", int]:
        """Parse a packed message's header; returns (meta, payload offset)."""
        nh = cls._N_HEAD
        head = msg[:nh * 4].view(np.int32)
        if int(head[0]) != _MAGIC or int(head[1]) != _VERSION:
            raise ValueError("not a KV transfer message (bad magic/version)")
        n_prompt, n_gen = int(head[9]), int(head[10])
        off = (nh + n_prompt + n_gen) * 4
        words = msg[nh * 4:off].view(np.int32)
        return cls(rid=int(head[2]), n_pages=int(head[3]),
                   page_size=int(head[4]), bytes_per_page=int(head[5]),
                   pos=int(head[6]), max_new_tokens=int(head[7]),
                   temperature=float(np.int32(int(head[8])).view(np.float32)),
                   prompt=tuple(int(t) for t in words[:n_prompt]),
                   generated=tuple(int(t) for t in words[n_prompt:])), off


class KVTransferCodec:
    """Bitcast pack / unpack of KV pages for one pool geometry.

    Built from a pools tree (donor and receiver must share geometry: the
    ``bytes_per_page`` fingerprint in the header is checked on unpack).
    The device work is a gather of the selected pages of every (stack,
    k/v) pool into one uint8 vector and a scatter of received bytes into
    the receiver's pages, both on the pools' own device and float-op free
    (``assert_casting_free``).
    """

    def __init__(self, pools):
        self.parts: List[Tuple[str, str, bool, torch.dtype, int, int, int,
                               int]] = []
        for stack in sorted(pools):
            for kv in ("k", "v"):
                p = pools[stack][kv]
                L, _, ps, KV, hd = p["data"].shape
                self.parts.append((stack, kv, "scale" in p, p["data"].dtype,
                                   L, ps, KV, hd))
        if not self.parts:
            raise ValueError("empty pools")
        self.page_size = self.parts[-1][5]
        self.device = pools[self.parts[0][0]]["k"]["data"].device
        self.bytes_per_page = sum(
            L * ps * KV * (hd * dt.itemsize + (1 if has_scale else 0))
            for (_, _, has_scale, dt, L, ps, KV, hd) in self.parts)

    # -- device work (pure bitcast + data movement) ------------------------
    def _gather(self, pools, ids: torch.Tensor) -> torch.Tensor:
        out = []
        for (stack, kv, has_scale, _, _, _, _, _) in self.parts:
            p = pools[stack][kv]
            out.append(p["data"][:, ids].view(torch.uint8).reshape(-1))
            if has_scale:
                exp = scale_to_exp_i8_bits(p["scale"][:, ids])
                out.append(exp.view(torch.uint8).reshape(-1))
        return torch.cat(out)

    def _scatter(self, pools, payload: torch.Tensor, ids: torch.Tensor):
        """Writes `payload` into pages `ids` of `pools` in place (PyTorch
        has no donation; the reference donates) and returns the pools."""
        n = ids.shape[0]
        off = 0
        for (stack, kv, has_scale, dt, L, ps, KV, hd) in self.parts:
            p = pools[stack][kv]
            nb = L * n * ps * KV * hd * dt.itemsize
            p["data"].view(torch.uint8)[:, ids] = payload[off:off + nb] \
                .view(L, n, ps, KV, hd * dt.itemsize)
            off += nb
            if has_scale:
                nbs = L * n * ps * KV
                exp = payload[off:off + nbs].view(torch.int8) \
                    .view(L, n, ps, KV, 1)
                off += nbs
                p["scale"][:, ids] = exp_i8_to_scale_bits(exp)
        return pools

    # -- host API ----------------------------------------------------------
    def bytes_for(self, n_pages: int) -> int:
        """Wire payload bytes for an n-page batch (bucket-padded, as
        shipped; the transfer-bytes budget meters this)."""
        return _bucket(n_pages) * self.bytes_per_page

    def _pad_ids(self, page_ids: Sequence[int]) -> torch.Tensor:
        b = _bucket(len(page_ids))
        ids = list(page_ids) + [SCRATCH_PAGE] * (b - len(page_ids))
        return torch.tensor(ids, dtype=torch.int64, device=self.device)

    def pack(self, pools, page_ids: Sequence[int],
             meta: TransferMeta) -> np.ndarray:
        """One host uint8 message: header + bucket-padded page payload
        (padding gathers the scratch page; the receiver's padding writes
        land in its own scratch page and are never read)."""
        header = meta.to_bytes()
        if not page_ids:
            return np.asarray(header)
        payload = self._gather(pools, self._pad_ids(page_ids))
        return np.concatenate([header, payload.cpu().numpy()])

    def unpack(self, msg: np.ndarray) -> Tuple[TransferMeta, np.ndarray]:
        meta, off = TransferMeta.from_bytes(msg)
        if meta.bytes_per_page != self.bytes_per_page:
            raise ValueError(
                f"pool geometry mismatch: message bytes/page "
                f"{meta.bytes_per_page} != local {self.bytes_per_page}")
        return meta, msg[off:]

    def scatter(self, pools, payload: np.ndarray, dst_ids: Sequence[int]):
        """Write a received payload into `dst_ids` (real pages; padding up
        to the bucket is scratch-directed).  Returns the pools, updated in
        place."""
        if not len(dst_ids):
            return pools
        data = torch.from_numpy(np.ascontiguousarray(payload)).to(self.device)
        return self._scatter(pools, data, self._pad_ids(dst_ids))

    # -- the zero-requantization proof -------------------------------------
    def assert_casting_free(self, pools, n: int = 2) -> None:
        """Run the gather and the scatter of an n-page batch under the op
        log and assert that neither does floating-point work: migration
        cannot quantize, dequantize or cast, by construction.  The scatter
        writes its scratch-page ids only, so the pools' live pages keep
        their bytes."""
        ids = torch.zeros((_bucket(n),), dtype=torch.int64,
                          device=self.device)
        payload = check_casting_free(self._gather, pools, ids)
        check_casting_free(self._scatter, pools, payload, ids)
