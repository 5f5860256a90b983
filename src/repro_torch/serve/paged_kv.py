"""Paged KV cache: fixed-size pages, a host-side refcounted free-list
allocator, and FP8-e4m3 page payloads with per-(token, head) po2 scales
(bf16 fallback).

Counterpart of ``repro.serve.paged_kv``.  Layout (shared across layers):

  pool["data"]  : (L, n_pages, page_size, KV, hd)   e4m3 or bf16 payload
  pool["scale"] : (L, n_pages, page_size, KV, 1)    f32 po2 scales (fp8 only)

Page 0 is the scratch page: writes for inactive slots and padded prefill
rows land there and are never read back (attention masks by position).
Payload pages move as uint8 views, so NaN encodings are kept as data.
Writes update the pool tensors in place.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import torch

from repro_torch.core.fp8 import E4M3
from repro_torch.core.quant import QTensor, _dequantize_nocount, quantize

SCRATCH_PAGE = 0


class PageAllocator:
    """Refcounted free-list over page ids [1, n_pages); page 0 is scratch.

    `alloc` hands pages out at refcount 1; `incref` adds an owner; `decref`
    returns a page to the free list when its count reaches 0.  `free` is
    the single-owner spelling of `decref`."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is scratch)")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free = deque(range(1, n_pages))
        self._refs: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages at refcount 1, or None -- never partial."""
        if n > len(self._free):
            return None
        out = [self._free.popleft() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def incref(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"incref of unallocated page {p}")
            self._refs[p] += 1

    def decref(self, pages: List[int]) -> List[int]:
        freed = []
        for p in pages:
            c = self._refs.get(p)
            if c is None:
                raise ValueError(f"double free / foreign page {p}")
            if c == 1:
                del self._refs[p]
                self._free.append(p)
                freed.append(p)
            else:
                self._refs[p] = c - 1
        return freed

    def free(self, pages: List[int]) -> None:
        self.decref(pages)


def init_pool(n_layers: int, n_pages: int, page_size: int, n_kv: int,
              head_dim: int, fp8: bool = True, device="cuda"):
    """One K or V pool for an n_layers-deep stack."""
    shape = (n_layers, n_pages, page_size, n_kv, head_dim)
    if fp8:
        return {"data": torch.zeros(shape, dtype=E4M3, device=device),
                "scale": torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                                    device=device)}
    return {"data": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def init_paged_cache(cfg, n_pages: int, page_size: int, fp8_kv: bool = True,
                     device="cuda"):
    """Paged pools for an attention-only decoder: ``main_attn`` over the
    main stack's layers and, with a dense prologue, ``dense_attn`` over
    its layers (one page id addresses the same rows in both)."""
    from repro_torch.models.lm import _paged_stacks
    _, nd = _paged_stacks(cfg)

    def stack(n):
        return {kv: init_pool(n, n_pages, page_size, cfg.n_kv, cfg.head_dim,
                              fp8_kv, device) for kv in ("k", "v")}

    pools = {"main_attn": stack(cfg.n_layers - nd)}
    if nd:
        pools["dense_attn"] = stack(nd)
    return pools


def pool_nbytes(pools) -> int:
    return sum(t.numel() * t.element_size()
               for stack in pools.values() for kv in stack.values()
               for t in kv.values())


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == E4M3 else t


def page_write_rows(pool_l, rows, page_idx, slot_idx) -> None:
    """Scatter token rows (N, KV, hd) into ONE layer's pool slice in place;
    one po2 scale per (token, head), a ``fused_quantize`` (folded into the
    cache write, not a counted Fig.-2 cast)."""
    if "scale" in pool_l:
        q = quantize(rows, (1,) * (rows.ndim - 1) + (rows.shape[-1],),
                     tag="q_kv_page", kind="fused_quantize")
        _bytes(pool_l["data"])[page_idx, slot_idx] = _bytes(q.data)
        pool_l["scale"][page_idx, slot_idx] = q.scale
    else:
        pool_l["data"][page_idx, slot_idx] = rows.to(pool_l["data"].dtype)


def copy_page(pools, src: int, dst: int) -> None:
    """Copy one page's rows (payload + scales, every layer) src -> dst."""
    for stack in pools.values():
        for kv in stack.values():
            for t in kv.values():
                _bytes(t)[:, dst] = _bytes(t)[:, src]


def page_read(pool_l, page_tables, dtype=torch.bfloat16):
    """Gather a request-batch view (B, max_pages * page_size, KV, hd) from
    ONE layer's pool slice; rows beyond each request's length are garbage
    and must be masked by position."""
    raw = _bytes(pool_l["data"])[page_tables]        # (B, np, ps, KV, hd)
    B, npg, ps, KV, hd = raw.shape
    data = raw.view(pool_l["data"].dtype).reshape(B, npg * ps, KV, hd)
    if "scale" in pool_l:
        scale = pool_l["scale"][page_tables].reshape(B, npg * ps, KV, 1)
        return _dequantize_nocount(QTensor(data, scale, (1, 1, 1, hd)), dtype)
    return data.to(dtype)
