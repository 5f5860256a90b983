"""Continuous-batching FP8 serving engine.

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
(serve/scheduler.py); pages come from a host-side refcounted free list
with youngest-first eviction under pressure (restart semantics).

``prefix_cache=True`` puts the radix prefix cache (serve/prefix_cache.py)
over the pool: a request whose page-aligned prompt prefix is cached
shares those pages and starts its prefill after them; a whole-prompt hit
copies its boundary page (``paged_kv.copy_page``, on the device) before
it writes the recomputed last row.  ``role`` splits serving into tiers:
a ``prefill`` replica parks each finished prefill in ``handoff`` for the
router (serve/router.py) to migrate its KV pages, bit for bit, to a
``decode`` replica (serve/transfer.py), which admits nothing itself.
Telemetry reads host state only, so it adds no host sync to a tick.

Across ranks (a ``plan`` on a mesh of more than one rank, or of one rank
with its groups): every rank runs the same scheduler, allocator, prefix
cache and role on the same requests, and its pool holds the same bytes
as every other rank's.  Its weights are the serving cut of the world-1
tree (``launch.sharding.serving_cut``, before the W8 quantize): its
experts (EP) or every expert's F-slice (TP); every other leaf whole.
Every rank runs every row; each MoE stage cuts the rows as the
reference does and gathers its output back (``models.lm._moe_stage``),
so every rank samples every row from the same logits with the same
generator, and the world-1 engine's draws are kept at any temperature.
Once a tick the sampled tokens are compared across the world (one int32
all-gather, counted): a rank that sampled differently raises on every
rank.  Telemetry sinks write on the world's rank 0 only.  With
``realtime`` arrivals the ranks admit what every rank's clock has seen
arrive (one int32 all-reduce a loop while requests are pending).
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
from repro_torch.dist import comm
from repro_torch.launch.sharding import serving_cut
from repro_torch.models.lm import (NO_PLAN, paged_decode_step,
                                   paged_prefill)
from repro_torch.obs.metrics import po2_buckets
from repro_torch.obs.sink import null_telemetry, on_rank
from repro_torch.serve.paged_kv import (PageAllocator, copy_page,
                                        init_paged_cache, pool_nbytes)
from repro_torch.serve.scheduler import Request, RequestState, Scheduler
from repro_torch.weights import params_to

# latency histogram edges: 2^-4 .. 2^14 ms covers sub-ms decode ticks
# through multi-second saturated TTFTs
_LAT_BUCKETS = po2_buckets(-4, 14)


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
    prefix_cache: bool = False         # radix prefix cache over the pool
    top_k: int = 0                     # 0 -> full-vocab sampling
    eos_id: Optional[int] = None
    seed: int = 0
    role: str = "mixed"                # "mixed", "prefill" (parks finished
                                       # prefills for migration) or
                                       # "decode" (adopts migrated requests)

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


def arrivals_due(pending, now: float, realtime: bool, group,
                 device) -> int:
    """How many of the `pending` requests (sorted by arrival) to submit
    now: all of them closed-loop; with `realtime` those whose arrival
    time has passed, agreed as the least over `group`'s ranks (every
    rank then submits the same requests)."""
    if not realtime:
        return len(pending)
    n = 0
    while n < len(pending) and pending[n].arrival_time <= now:
        n += 1
    if group is None or not pending:
        return n
    return -int(comm.agree_max_int(torch.tensor(-n, device=device), group))


class ServeEngine:
    """Continuous-batching serving over paged FP8 KV + W8-resident weights.

        eng = ServeEngine(cfg, recipe, params, ServeConfig(...), device="cuda")
        results = eng.run([Request(prompt=[...], max_new_tokens=8), ...])

    `plan` (``models.lm.ParallelPlan``, in its serving layout): its
    ``moe_overlap`` (a ``core.moe.DispatchPlan``) runs the MoE layers of
    the prefill and decode steps through the chunked blocks (None keeps
    the monolithic ones); its mesh runs them over the model group (EP:
    the prefill's all-to-alls and the decode combine's all-reduce; TP
    experts, ``moe_mode='tp'``: ``moe_block_tp``'s combine) and cuts the
    batch over the pod x data group; `params` is the world-1 tree (or
    this rank's serving cut of it).  Every rank of the mesh runs an
    engine on the same requests (module docstring).
    """

    def __init__(self, cfg: ArchConfig, recipe: Recipe, params,
                 ecfg: ServeConfig = ServeConfig(), device="cuda",
                 telemetry=None, plan=None):
        check_decode_recipe(recipe)
        self.device = resolve_device(device)
        self.cfg, self.recipe, self.ecfg = cfg, recipe, ecfg
        self.plan = (NO_PLAN if plan is None else plan).for_serving()
        # the group the ranks' sampled tokens are compared over
        self.agree_group = None if self.plan.mesh is None \
            else self.plan.mesh.world_group
        self.tel = on_rank(telemetry if telemetry is not None
                           else null_telemetry(), self.plan.mesh)
        if ecfg.role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"unknown role {ecfg.role!r}")
        if ecfg.prefill_chunk is not None and (
                ecfg.prefill_chunk < 1
                or ecfg.prefill_chunk > max(ecfg.prefill_buckets)):
            raise ValueError(
                f"prefill_chunk {ecfg.prefill_chunk} must be in "
                f"[1, {max(ecfg.prefill_buckets)}] (largest bucket)")
        params = params_to(serving_cut(params, cfg, self.plan), self.device)
        if ecfg.w8_weights and recipe.name == "fp8_flow":
            from repro_torch.serve.w8 import quantize_params_for_serving
            params = quantize_params_for_serving(params)
        self.params = params
        self.pools = init_paged_cache(cfg, ecfg.n_pages, ecfg.page_size,
                                      fp8_kv=ecfg.fp8_kv, device=self.device)
        self.alloc = PageAllocator(ecfg.n_pages, ecfg.page_size)
        self.prefix_cache = None
        release_hook = None
        if ecfg.prefix_cache:
            from repro_torch.serve.prefix_cache import PrefixCache
            self.prefix_cache = PrefixCache(ecfg.page_size, telemetry=self.tel)
            # the scheduler's one release point decrefs, so pages the cache
            # holds outlive the request that wrote them
            release_hook = lambda st, pages, alloc: alloc.decref(pages)
        self.sched = Scheduler(ecfg.max_batch, ecfg.token_budget,
                               release_hook=release_hook)
        self.gen = torch.Generator(device=self.device).manual_seed(ecfg.seed)
        self._tick_count = 0
        self.max_concurrent = 0
        self.total_decoded = 0
        self.n_rejected = 0
        self.n_prefill_chunks = 0
        self.n_migrated_out = 0
        # prefill tier: finished prefills parked (slot, pages and budget
        # held) until the router migrates their KV and the receiver acks
        self.handoff: deque = deque()
        self._codec = None

    @property
    def codec(self):
        """KV page transfer codec for this engine's pool geometry (made on
        first use: only a disaggregated fleet needs it)."""
        if self._codec is None:
            from repro_torch.serve.transfer import KVTransferCodec
            self._codec = KVTransferCodec(self.pools)
        return self._codec

    # -- queue -------------------------------------------------------------
    def _reject(self, req: Request, msg: str):
        """A request that can never be served is counted and refused."""
        self.n_rejected += 1
        self.tel.counter("serve_rejected_total").inc()
        self.tel.record("request_rejected", rid=req.rid, reason=msg)
        raise ValueError(msg)

    def submit(self, req: Request) -> None:
        ecfg = self.ecfg
        if ecfg.role == "decode":
            self._reject(req, "decode-tier replica does not admit requests "
                         "(route to the prefill tier; KV arrives via adopt)")
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
    def _alloc_pages(self, n: int):
        """Pool allocation with the prefix cache as the first pressure
        valve: LRU unreferenced radix leaves go before any resident."""
        if self.prefix_cache is not None:
            return self.prefix_cache.alloc_pages(self.alloc, n)
        return self.alloc.alloc(n)

    def _grow_pages(self, st: RequestState) -> bool:
        """Ensure st's page table covers its next write; evicts YOUNGER
        residents under pressure (st self-evicts when it is the youngest).
        False if st got unseated."""
        need = st.next_pos // self.ecfg.page_size + 1
        while len(st.pages) < need:
            got = self._alloc_pages(1)
            if got is not None:
                st.pages.extend(got)
                continue
            ev = self.sched.evict_youngest(self.alloc, requester=st)
            if ev is None:
                raise RuntimeError("page pressure with no resident to evict")
            self.tel.counter("serve_evicted_total").inc()
            self.tel.record("request_evicted", rid=ev.req.rid,
                            by=st.req.rid, n_evictions=ev.n_evictions)
            if ev is st:
                return False
        return st.slot in self.sched.active

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @torch.inference_mode()
    def tick(self, now: float, results: Dict[int, dict]) -> bool:
        """One engine tick; returns True if any work ran."""
        ecfg, sched = self.ecfg, self.sched
        # parked states (prefill tier, awaiting migration) keep their KV
        # frozen: they leave the decode set
        for slot in sorted(sched.active):
            st = sched.active.get(slot)
            if st is not None and st.prefilled and not st.parked:
                self._grow_pages(st)
        decode_slots = [s for s in sorted(sched.active)
                        if sched.active[s].prefilled
                        and not sched.active[s].parked]

        # a decode-tier replica never prefills: its requests arrive
        # prefilled through commit_adopt
        pf = sched.mid_prefill() if ecfg.role != "decode" else None
        if pf is None and ecfg.role != "decode":
            pf = sched.try_admit(self.alloc, now,
                                 prefix_cache=self.prefix_cache)
            if pf is not None and pf.cached_tokens:
                self.tel.record("prefix_hit", rid=pf.req.rid,
                                cached_tokens=pf.cached_tokens,
                                shared_pages=pf.n_shared_pages,
                                cow=pf.cow_page is not None)
        if pf is not None and pf.cow_page is not None:
            # whole-prompt hit: the recomputed last row writes a private
            # copy of the boundary page; the shared original stays as it is
            src, dst = pf.cow_page
            pf.cow_page = None
            copy_page(self.pools, src, dst)
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
                               history=pf.prefill_pos > 0, plan=self.plan)
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
                                   self._tensor(pos), self._tensor(active),
                                   plan=self.plan)
            out["decode_toks"] = sample_tokens(lg[:, -1, :],
                                               self._tensor(temps),
                                               ecfg.top_k, self.gen)
        out = self._agreed(out)                        # one host sync
        self._tick_count += 1
        self.max_concurrent = max(self.max_concurrent,
                                  len(decode_slots) + (pf is not None))
        tel = self.tel
        tel.counter("serve_ticks_total").inc()
        tel.counter("serve_decode_tokens_total").inc(len(decode_slots))
        if pf is not None:
            tel.counter("serve_prefill_chunks_total").inc()
        used = (ecfg.n_pages - 1) - self.alloc.free_pages
        tel.gauge("kv_used_pages").set(used)
        tel.histogram("kv_used_pages_hist",
                      edges=po2_buckets(0, 20)).observe(used)
        if tel.enabled:
            tel.record("serve_tick", tick=self._tick_count - 1,
                       n_decode=len(decode_slots),
                       bucket=bucket if pf is not None else None,
                       chunk=int(chunk), kv_used_pages=used,
                       n_waiting=len(sched.waiting),
                       reserved_tokens=sched.reserved_tokens)

        if pf is not None:
            self.n_prefill_chunks += 1
            pf.prefill_pos += chunk
            if final_chunk:
                if self.prefix_cache is not None:
                    # every full prompt page is written and stable (decode
                    # rows land beyond them): publish the prefix
                    self.prefix_cache.insert(pf.req.prompt, pf.pages,
                                             self.alloc)
                # only the last chunk's logits are the prompt's final position
                self._emit(pf, int(out["prefill_tok"]), now, results)
                if ecfg.role == "prefill" and sched.active.get(pf.slot) is pf:
                    # prefill tier: park (slot, pages and budget stay held)
                    # and queue for migration to a decode replica
                    pf.parked = True
                    self.handoff.append(pf)
                    tel.gauge("handoff_queue_depth").set(len(self.handoff))
        for s in decode_slots:
            st = sched.active.get(s)
            if st is not None:
                self._emit(st, int(out["decode_toks"][s]), now, results)
        return True

    def _agreed(self, out: dict) -> dict:
        """The tick's sampled tokens on the host, compared across the
        world's ranks (one int32 all-gather): a rank whose tokens differ
        from rank 0's raises, on every rank."""
        keys = list(out)
        flat = torch.cat([out[k].reshape(-1) for k in keys]).to(torch.int32)
        if self.agree_group is None:
            rows = [flat.tolist()]
        else:
            rows = comm.all_gather(flat[None], self.agree_group).tolist()
        bad = [r for r, row in enumerate(rows) if row != rows[0]]
        if bad:
            raise RuntimeError(
                f"tick {self._tick_count}: ranks {bad} sampled other tokens "
                f"than rank 0 ({[rows[r] for r in bad]} against {rows[0]})")
        got, i = {}, 0
        for k in keys:
            n = out[k].numel()
            got[k] = rows[0][i] if out[k].ndim == 0 else rows[0][i:i + n]
            i += n
        return got

    def _emit(self, st: RequestState, tok: int, now: float,
              results: Dict[int, dict]) -> None:
        st.generated.append(tok)
        st.prefilled = True
        self.total_decoded += 1
        if st.first_token_time is None:
            st.first_token_time = now
            self.tel.histogram("serve_ttft_ms", edges=_LAT_BUCKETS).observe(
                (now - st.req.arrival_time) * 1e3)
        elif st.last_token_time is not None:
            self.tel.histogram("serve_tbt_ms", edges=_LAT_BUCKETS).observe(
                (now - st.last_token_time) * 1e3)
        st.last_token_time = now
        if st.done(self.ecfg.eos_id):
            self.sched.finish(st.slot, self.alloc, now)
            self.tel.counter("serve_finished_total").inc()
            n_tok = len(st.generated)
            self.tel.record(
                "request_done", rid=st.req.rid, n_tokens=n_tok,
                ttft_ms=(st.first_token_time - st.req.arrival_time) * 1e3,
                tbt_ms_mean=((now - st.first_token_time) * 1e3
                             / max(n_tok - 1, 1)),
                wait_ms=(st.admit_time - st.req.arrival_time) * 1e3,
                n_evictions=st.n_evictions, cached_tokens=st.cached_tokens)
            results[st.req.rid] = {
                "tokens": list(st.generated),
                "arrival": st.req.arrival_time,
                "admit": st.admit_time,
                "first_token": st.first_token_time,
                "finish": now,
                "n_evictions": st.n_evictions,
                "cached_tokens": st.cached_tokens,
            }

    # -- disaggregation: casting-free KV migration -------------------------
    # Two-phase protocol, driven by the router:
    #   1. receiver.reserve_for_adopt(meta): pin the prompt pages it already
    #      caches (incref) first, then reserve fresh pages; all or nothing.
    #   2. donor.pack_handoff(st, skip): pack only the pages the receiver
    #      lacks; receiver.commit_adopt scatters them into its pool and
    #      installs the RequestState in its decode batch.
    #   3. donor.release_parked(st): only after the receiver's ack, the
    #      pages leave through the release funnel (cached pages stay).
    def pack_handoff(self, st: RequestState, skip_pages: int = 0):
        """Donor: one uint8 wire message carrying ``st.pages[skip_pages:]``
        (the receiver holds bit-identical copies of the first `skip_pages`:
        po2 pages are content-addressable) and the request's resume
        metadata."""
        from repro_torch.serve.transfer import TransferMeta
        ship = st.pages[skip_pages:]
        meta = TransferMeta(rid=st.req.rid, n_pages=len(ship),
                            page_size=self.ecfg.page_size,
                            bytes_per_page=self.codec.bytes_per_page,
                            pos=st.prefill_pos,
                            max_new_tokens=st.req.max_new_tokens,
                            temperature=st.req.temperature,
                            prompt=tuple(st.req.prompt),
                            generated=tuple(st.generated))
        return self.codec.pack(self.pools, ship, meta)

    def reserve_for_adopt(self, req):
        """Receiver phase 1: (shared, fresh) page lists covering the
        migrating prompt, or None if a slot, the token budget or the pool
        cannot take it now (the donor keeps it parked; the router retries).
        `req` has .prompt and .max_new_tokens (a Request or a
        TransferMeta).  Cached blocks are pinned by incref before the fresh
        tail allocates: the tail's allocation may evict cache leaves."""
        sched, ecfg = self.sched, self.ecfg
        if not sched._free_slots:
            return None
        P = len(req.prompt)
        n_total = self.alloc.pages_for(P)
        shared = (self.prefix_cache.match_pages(req.prompt)
                  if self.prefix_cache is not None else [])[:n_total]
        cached = len(shared) * ecfg.page_size
        if sched.reserved_tokens + P + req.max_new_tokens - cached \
                > sched.token_budget:
            return None
        self.alloc.incref(shared)
        n_fresh = n_total - len(shared)
        fresh = (self._alloc_pages(n_fresh) or None) if n_fresh else []
        if fresh is None:
            self.alloc.decref(shared)
            return None
        return shared, fresh

    def abort_adopt(self, shared, fresh) -> None:
        """Receiver: roll phase 1 back (decref the pins, free the fresh
        pages)."""
        self.alloc.decref(list(shared) + list(fresh))

    def commit_adopt(self, meta, payload, shared, fresh, now: float,
                     timing: Optional[dict] = None) -> RequestState:
        """Receiver phase 2: write the shipped page bytes into the fresh
        pages (a bitcast: they land bit for bit the donor's), rebuild the
        RequestState at the request's `pos`, install it in the decode
        batch, and publish the prompt prefix in the local radix tree so
        later migrations and admissions of the same tenant share these
        pages."""
        if fresh:
            self.codec.scatter(self.pools, payload, fresh)
        timing = timing or {}
        req = Request(prompt=list(meta.prompt),
                      max_new_tokens=meta.max_new_tokens,
                      arrival_time=timing.get("arrival", now),
                      temperature=meta.temperature, rid=meta.rid)
        st = RequestState(req=req, slot=-1, pages=list(shared) + list(fresh),
                          admit_seq=-1, admit_time=timing.get("admit", now),
                          generated=list(meta.generated),
                          first_token_time=timing.get("first"),
                          last_token_time=timing.get("last"),
                          prefilled=True, prefill_pos=meta.pos,
                          cached_tokens=len(shared) * self.ecfg.page_size,
                          n_shared_pages=len(shared))
        self.sched.adopt(st)
        if self.prefix_cache is not None:
            self.prefix_cache.insert(meta.prompt, st.pages, self.alloc)
        return st

    def release_parked(self, st: RequestState) -> None:
        """Donor phase 3 (after the ack): the parked request's slot, budget
        and pages leave through the scheduler's funnel; with a prefix cache
        the prompt pages stay for later local hits."""
        st.parked = False
        self.sched.release(st, self.alloc)
        self.n_migrated_out += 1

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
            for _ in range(arrivals_due(pending, now, realtime,
                                        self.agree_group, self.device)):
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
        self.tel.record("serve_summary", **results.stats)
        self.tel.flush()
        return results

    def stats(self) -> Dict[str, int]:
        """Run-level counters (also run()'s TraceResults.stats)."""
        s = self.sched.stats()
        out = {"ticks": self._tick_count, "admitted": s["admitted"],
               "evicted": s["evicted"], "finished": s["finished"],
               "rejected": self.n_rejected,
               "prefill_chunks": self.n_prefill_chunks,
               "decode_tokens": self.total_decoded,
               "max_concurrent": self.max_concurrent,
               "adopted": s["adopted"],
               "migrated_out": self.n_migrated_out,
               "role": self.ecfg.role}
        if self.prefix_cache is not None:
            out.update(self.prefix_cache.stats())
        return out

    def kv_bytes(self) -> int:
        return pool_nbytes(self.pools)
