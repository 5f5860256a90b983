"""Continuous-batching FP8 serving engine (the ``mixed`` role).

Counterpart of ``repro.serve.engine``: a request queue feeding interleaved
prefill and decode over W8-resident FP8 expert weights (serve/w8.py;
fp8_flow only: the bf16 recipe serves bf16 weights) and a paged FP8-e4m3
KV cache with po2 scales (serve/paged_kv.py).  blockwise and naive_fp8
raise, as the reference cannot decode them (``core.moe``).

One tick = [prefill one admitted request's prompt chunk, padded to a
bucket] + [decode every resident request one token over the full
``max_batch`` slot array behind an ``active`` mask] + [sample].  PyTorch
runs eagerly, so there is no compiled step; the shapes stay the
reference's all the same (bucketed prompts, full-batch decode), which is
what a later CUDA-graph capture needs.

Scheduling is FCFS with decode priority and a reserved-token budget
(serve/scheduler.py); pages come from a host-side free list with
youngest-first eviction under pressure (restart semantics).  The prefix
cache, prefill/decode disaggregation and telemetry are later slices: their
settings raise here.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.moe import check_decode_recipe
from repro_torch.core.recipes import Recipe
from repro_torch.device import resolve_device
from repro_torch.models.lm import paged_decode_step, paged_prefill
from repro_torch.serve.paged_kv import (PageAllocator, init_paged_cache,
                                        pool_nbytes)
from repro_torch.serve.scheduler import Request, RequestState, Scheduler
from repro_torch.weights import params_to


class TraceResults(dict):
    """run()'s return value: rid -> per-request result dict, plus
    `.stats` (run-level aggregate counters)."""
    stats: dict

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.stats = {}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (the reference's fields and defaults)."""
    max_batch: int = 8                 # resident-request slots
    page_size: int = 16                # tokens per KV page
    n_pages: int = 256                 # pool pages (page 0 is scratch)
    max_pages_per_req: int = 16        # page-table width
    token_budget: int = 2048           # sum(prompt+max_new) over residents
    prefill_buckets: Sequence[int] = (16, 32, 64, 128)
    prefill_chunk: Optional[int] = None  # max prompt tokens per tick
    fp8_kv: bool = True                # e4m3 pages w/ po2 scales, else bf16
    w8_weights: bool = False           # pre-quantize expert weights
    prefix_cache: bool = False         # not ported yet: raises
    top_k: int = 0                     # 0 -> full-vocab sampling
    eos_id: Optional[int] = None
    seed: int = 0
    role: str = "mixed"                # only "mixed" is ported

    def __post_init__(self):
        if self.prefix_cache:
            raise NotImplementedError(
                "prefix_cache is not ported yet (ROADMAP.md, Queue 1)")
        if self.role != "mixed":
            raise NotImplementedError(
                f"role {self.role!r}: disaggregation is not ported yet "
                "(ROADMAP.md, Queue 1)")

    @property
    def max_len(self) -> int:
        return self.max_pages_per_req * self.page_size


def sample_tokens(logits, temps, top_k: int, generator=None):
    """logits (N, V); temps (N,) -- greedy where temp <= 0, else
    temperature + (optional) top-k categorical through `generator`."""
    greedy = logits.argmax(dim=-1)
    sampled_rows = temps > 0
    if not bool(sampled_rows.any()):
        return greedy
    lf = logits.to(torch.float32) / torch.clamp(temps, min=1e-6)[:, None]
    if top_k:
        kth = torch.topk(lf, top_k, dim=-1).values[:, -1:]
        lf = torch.where(lf < kth, -1e30, lf)
    probs = torch.softmax(lf, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(sampled_rows, sampled, greedy)


class ServeEngine:
    """Continuous-batching serving over paged FP8 KV + W8-resident weights.

        eng = ServeEngine(cfg, recipe, params, ServeConfig(...), device="cuda")
        results = eng.run([Request(prompt=[...], max_new_tokens=8), ...])
    """

    def __init__(self, cfg: ArchConfig, recipe: Recipe, params,
                 ecfg: ServeConfig = ServeConfig(), device="cuda"):
        check_decode_recipe(recipe)
        self.device = resolve_device(device)
        self.cfg, self.recipe, self.ecfg = cfg, recipe, ecfg
        if ecfg.prefill_chunk is not None and (
                ecfg.prefill_chunk < 1
                or ecfg.prefill_chunk > max(ecfg.prefill_buckets)):
            raise ValueError(
                f"prefill_chunk {ecfg.prefill_chunk} must be in "
                f"[1, {max(ecfg.prefill_buckets)}] (largest bucket)")
        params = params_to(params, self.device)
        if ecfg.w8_weights and recipe.name == "fp8_flow":
            from repro_torch.serve.w8 import quantize_params_for_serving
            params = quantize_params_for_serving(params)
        self.params = params
        self.pools = init_paged_cache(cfg, ecfg.n_pages, ecfg.page_size,
                                      fp8_kv=ecfg.fp8_kv, device=self.device)
        self.alloc = PageAllocator(ecfg.n_pages, ecfg.page_size)
        self.sched = Scheduler(ecfg.max_batch, ecfg.token_budget)
        self.gen = torch.Generator(device=self.device).manual_seed(ecfg.seed)
        self._tick_count = 0
        self.max_concurrent = 0
        self.total_decoded = 0
        self.n_rejected = 0
        self.n_prefill_chunks = 0

    # -- queue -------------------------------------------------------------
    def _reject(self, req: Request, msg: str):
        self.n_rejected += 1
        raise ValueError(msg)

    def submit(self, req: Request) -> None:
        ecfg = self.ecfg
        P = len(req.prompt)
        if P < 1 or req.max_new_tokens < 1:
            self._reject(req, "empty prompt / zero max_new_tokens")
        if ecfg.prefill_chunk is None and P > max(ecfg.prefill_buckets):
            self._reject(req, f"prompt {P} exceeds the largest prefill "
                         f"bucket {max(ecfg.prefill_buckets)} "
                         f"(set prefill_chunk to slice long prompts)")
        if P + req.max_new_tokens > ecfg.max_len:
            self._reject(req, f"request needs {P + req.max_new_tokens} "
                         f"tokens > max_len {ecfg.max_len}")
        if req.reserved_tokens > ecfg.token_budget:
            self._reject(req, "request alone exceeds the token budget")
        if self.alloc.pages_for(P + req.max_new_tokens) > ecfg.n_pages - 1:
            self._reject(req, "request alone exceeds the KV pool")
        self.sched.submit(req)

    # -- one tick ----------------------------------------------------------
    def _grow_pages(self, st: RequestState) -> bool:
        """Ensure st's page table covers its next write; evicts YOUNGER
        residents under pressure (st self-evicts when it is the youngest).
        False if st got unseated."""
        need = st.next_pos // self.ecfg.page_size + 1
        while len(st.pages) < need:
            got = self.alloc.alloc(1)
            if got is not None:
                st.pages.extend(got)
                continue
            ev = self.sched.evict_youngest(self.alloc, requester=st)
            if ev is None:
                raise RuntimeError("page pressure with no resident to evict")
            if ev is st:
                return False
        return st.slot in self.sched.active

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @torch.inference_mode()
    def tick(self, now: float, results: Dict[int, dict]) -> bool:
        """One engine tick; returns True if any work ran."""
        ecfg, sched = self.ecfg, self.sched
        for slot in sorted(sched.active):
            st = sched.active.get(slot)
            if st is not None and st.prefilled:
                self._grow_pages(st)
        decode_slots = [s for s in sorted(sched.active)
                        if sched.active[s].prefilled]

        pf = sched.mid_prefill()
        if pf is None:
            pf = sched.try_admit(self.alloc, now)
        if pf is None and not decode_slots:
            return False

        out = {}
        chunk = 0
        final_chunk = False
        if pf is not None:
            P = len(pf.req.prompt)
            chunk = P - pf.prefill_pos
            if ecfg.prefill_chunk:
                chunk = min(chunk, ecfg.prefill_chunk)
            final_chunk = pf.prefill_pos + chunk >= P
            bucket = min(b for b in ecfg.prefill_buckets if b >= chunk)
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :chunk] = pf.req.prompt[pf.prefill_pos:
                                              pf.prefill_pos + chunk]
            ptrow = np.zeros((ecfg.max_pages_per_req,), np.int64)
            ptrow[:len(pf.pages)] = pf.pages
            lg = paged_prefill(self.cfg, self.recipe, self.params, self.pools,
                               self._tensor(ptrow), self._tensor(tokens),
                               chunk, start=pf.prefill_pos,
                               history=pf.prefill_pos > 0)
            temp = torch.full((1,), float(pf.req.temperature),
                              device=self.device)
            out["prefill_tok"] = sample_tokens(lg[:, -1, :], temp,
                                               ecfg.top_k, self.gen)[0]
        if decode_slots:
            B, mp = ecfg.max_batch, ecfg.max_pages_per_req
            pt = np.zeros((B, mp), np.int64)
            pos = np.zeros((B,), np.int64)
            active = np.zeros((B,), bool)
            last = np.zeros((B,), np.int64)
            temps = np.zeros((B,), np.float32)
            for s in decode_slots:
                st = sched.active[s]
                pt[s, :len(st.pages)] = st.pages
                pos[s] = st.next_pos
                active[s] = True
                last[s] = st.generated[-1]
                temps[s] = st.req.temperature
            lg = paged_decode_step(self.cfg, self.recipe, self.params,
                                   self.pools, self._tensor(pt),
                                   self._tensor(last[:, None]),
                                   self._tensor(pos), self._tensor(active))
            out["decode_toks"] = sample_tokens(lg[:, -1, :],
                                               self._tensor(temps),
                                               ecfg.top_k, self.gen)
        out = {k: v.tolist() for k, v in out.items()}   # one host sync
        self._tick_count += 1
        self.max_concurrent = max(self.max_concurrent,
                                  len(decode_slots) + (pf is not None))

        if pf is not None:
            self.n_prefill_chunks += 1
            pf.prefill_pos += chunk
            if final_chunk:
                # only the last chunk's logits are the prompt's final position
                self._emit(pf, int(out["prefill_tok"]), now, results)
        for s in decode_slots:
            st = sched.active.get(s)
            if st is not None:
                self._emit(st, int(out["decode_toks"][s]), now, results)
        return True

    def _emit(self, st: RequestState, tok: int, now: float,
              results: Dict[int, dict]) -> None:
        st.generated.append(tok)
        st.prefilled = True
        self.total_decoded += 1
        if st.first_token_time is None:
            st.first_token_time = now
        st.last_token_time = now
        if st.done(self.ecfg.eos_id):
            self.sched.finish(st.slot, self.alloc, now)
            results[st.req.rid] = {
                "tokens": list(st.generated),
                "arrival": st.req.arrival_time,
                "admit": st.admit_time,
                "first_token": st.first_token_time,
                "finish": now,
                "n_evictions": st.n_evictions,
                "cached_tokens": st.cached_tokens,
            }

    # -- driver ------------------------------------------------------------
    def run(self, requests: Sequence[Request],
            realtime: bool = True) -> Dict[int, dict]:
        """Drive a trace to completion.  With realtime=True arrivals are
        honored against the wall clock; otherwise every request is enqueued
        immediately (closed-loop saturation)."""
        pending = deque(sorted(requests, key=lambda r: r.arrival_time))
        results = TraceResults()
        t0 = time.perf_counter()
        idle_spins = 0
        while pending or not self.sched.idle():
            now = time.perf_counter() - t0
            while pending and (not realtime
                               or pending[0].arrival_time <= now):
                self.submit(pending.popleft())
            if self.tick(now, results):
                idle_spins = 0
                continue
            if pending:
                time.sleep(max(0.0, min(0.002,
                                        pending[0].arrival_time - now)))
                continue
            idle_spins += 1
            if idle_spins > 1000:
                raise RuntimeError(
                    "scheduler deadlock: waiting requests can never be "
                    "admitted (check token_budget / n_pages)")
        results.stats = self.stats()
        return results

    def stats(self) -> Dict[str, int]:
        s = self.sched.stats()
        return {"ticks": self._tick_count, "admitted": s["admitted"],
                "evicted": s["evicted"], "finished": s["finished"],
                "rejected": self.n_rejected,
                "prefill_chunks": self.n_prefill_chunks,
                "decode_tokens": self.total_decoded,
                "max_concurrent": self.max_concurrent,
                "role": self.ecfg.role}

    def kv_bytes(self) -> int:
        return pool_nbytes(self.pools)
