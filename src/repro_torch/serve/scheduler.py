"""Request scheduler for the continuous-batching serving engine.

A copy of ``repro.serve.scheduler`` (the port imports nothing of the JAX
package); the prefix-cache hooks stay, unused until that slice.

Policy (LightLLM/vLLM-style, sized for the paper's FP8-resident decode):

  * FCFS admission — only the HEAD of the waiting queue is ever considered,
    so an admissible request can never be overtaken (no starvation).
  * Decode priority — one admission per engine tick (the jitted step carries
    a single bucketed prefill); resident requests keep decoding every tick
    and the prefill rides along in the same jitted step.
  * Reserved-token budget — a request is admitted only while
    sum(prompt_len + max_new_tokens) over resident requests stays within
    ``token_budget``; the reservation covers the worst-case length, so the
    invariant holds for the request's whole lifetime.
  * Eviction — when the paged-KV allocator cannot extend a growing request,
    the YOUNGEST resident request is evicted (restart semantics: its pages
    are freed, generated tokens are discarded, and it re-queues at the front
    of the waiting line, which preserves FCFS order).
  * Chunked prefill — long prompts prefill in bounded token slices
    (``ServeConfig.prefill_chunk``), one slice per tick, so resident decodes
    are never starved behind a long monolithic prefill.  The in-flight
    continuation has strict priority over new admissions (it was admitted
    first — FCFS), so at most one request is ever mid-prefill.

The scheduler is pure host-side bookkeeping: it never touches the device.
The engine owns the device arrays and the page allocator and consults the
scheduler for admission/eviction decisions.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Dict, List, Optional

from repro_torch.serve.paged_kv import PageAllocator

_rid_counter = itertools.count()


@dataclasses.dataclass
class Request:
    """One serving request (token ids in, sampling knobs, arrival time)."""
    prompt: List[int]
    max_new_tokens: int
    arrival_time: float = 0.0
    temperature: float = 0.0            # <= 0 -> greedy
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))

    @property
    def reserved_tokens(self) -> int:
        return len(self.prompt) + self.max_new_tokens


@dataclasses.dataclass
class RequestState:
    """Lifecycle bookkeeping for an admitted request."""
    req: Request
    slot: int
    pages: List[int]
    admit_seq: int
    admit_time: float
    generated: List[int] = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None   # TBT accounting (obs/)
    finish_time: Optional[float] = None
    prefilled: bool = False
    prefill_pos: int = 0           # tokens prefilled so far (chunked prefill:
                                   # advances one bounded slice per tick;
                                   # == len(prompt) once prefill is complete.
                                   # A prefix-cache hit starts this at the
                                   # matched length, so the tail rides the
                                   # SAME continuation machinery)
    n_evictions: int = 0
    cached_tokens: int = 0         # prompt tokens served from shared prefix
                                   # pages — their prefill is skipped and
                                   # they are discounted from the budget
    n_shared_pages: int = 0        # leading pages of `pages` held via incref
                                   # (read-only; the request must not write)
    cow_page: Optional[tuple] = None  # (src, dst): boundary page to copy
                                   # before this request's first chunk runs
    parked: bool = False           # prefill-tier disaggregation: prefill is
                                   # complete and the request sits in the
                                   # handoff queue awaiting KV migration; it
                                   # keeps its slot/pages/budget (the KV must
                                   # survive until the receiver acks) but is
                                   # excluded from decode and from eviction

    @property
    def next_pos(self) -> int:
        """Position the next fed token's KV row is written at.  Prefill
        fills rows [0, prompt); the first decode feeds the prefill-sampled
        token and writes row `prompt`; each later decode advances by one."""
        return len(self.req.prompt) + max(len(self.generated) - 1, 0)

    def done(self, eos_id: Optional[int]) -> bool:
        if len(self.generated) >= self.req.max_new_tokens:
            return True
        return bool(self.generated) and eos_id is not None \
            and self.generated[-1] == eos_id


class Scheduler:
    """FCFS + decode-priority + reserved-token-budget admission control.

    `release_hook` is the single exit point for a resident's pages: every
    path that returns pages (finish, eviction) funnels through it, so a
    prefix cache can intercept releases (decref shared pages, keep cached
    ones alive) without forking the scheduler.  The default hook is the
    allocator's own single-owner free.
    """

    def __init__(self, max_batch: int, token_budget: int, release_hook=None):
        self.max_batch = max_batch
        self.token_budget = token_budget
        self.release_hook = release_hook   # callable(state, pages, allocator)
        self.waiting: deque = deque()
        self.active: Dict[int, RequestState] = {}      # slot -> state
        self._free_slots = list(range(max_batch - 1, -1, -1))
        self._admit_seq = itertools.count()
        self.n_finished = 0
        self.n_evictions = 0
        self.n_admitted = 0
        self.n_adopted = 0                             # disagg: migrated in
        self.cached_prompt_tokens = 0                  # prefix-cache skips
        self._eviction_counts: Dict[int, int] = {}     # rid -> times evicted

    # -- introspection -----------------------------------------------------
    @property
    def reserved_tokens(self) -> int:
        """Worst-case token reservation over residents.  Tokens served from
        shared prefix pages are discounted: their KV rows already exist (and
        are pinned by the request's refs for its whole lifetime), so only
        un-cached pages count against the budget."""
        return sum(st.req.reserved_tokens - st.cached_tokens
                   for st in self.active.values())

    @property
    def n_active(self) -> int:
        return len(self.active)

    def idle(self) -> bool:
        return not self.waiting and not self.active

    def stats(self) -> Dict[str, int]:
        """Aggregate scheduler counters (the engine folds these into its
        run-level stats and the obs registry)."""
        return {"admitted": self.n_admitted, "evicted": self.n_evictions,
                "finished": self.n_finished, "waiting": len(self.waiting),
                "active": self.n_active, "adopted": self.n_adopted}

    def mid_prefill(self) -> Optional[RequestState]:
        """The resident whose chunked prefill is still in flight, if any.
        At most one exists: the engine blocks new admissions while a
        continuation is pending (FCFS — it was admitted first)."""
        for slot in sorted(self.active):
            st = self.active[slot]
            if st.prefill_pos < len(st.req.prompt):
                return st
        return None

    # -- queue -------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    # -- admission ---------------------------------------------------------
    def try_admit(self, allocator: PageAllocator, now: float,
                  prefix_cache=None) -> Optional[RequestState]:
        """Admit the queue head if a slot, the token budget, and prompt pages
        all allow it.  Returns the new RequestState (pages allocated,
        prefill still pending) or None.  Strictly FCFS: if the head does not
        fit, nothing behind it is considered.

        With a prefix cache, the head's prompt is first matched against the
        radix tree: matched pages are shared (incref, zero prefill compute),
        only the un-cached tail reserves budget and allocates fresh pages,
        and `prefill_pos` starts at the matched length so the tail rides the
        chunked-prefill continuation path.  A whole-prompt hit keeps its
        last cached page as copy-on-write (`cow_page`) — the engine copies
        it before the final-token chunk writes into it."""
        if not self.waiting or not self._free_slots:
            return None
        req = self.waiting[0]
        match = prefix_cache.lookup(req.prompt) if prefix_cache is not None \
            else None
        cached_tokens = match.tokens if match else 0
        if self.reserved_tokens + req.reserved_tokens - cached_tokens \
                > self.token_budget:
            return None
        n_total = allocator.pages_for(len(req.prompt))
        shared = list(match.pages[:-1] if match.cow else match.pages) \
            if match else []
        # pin the matched pages BEFORE allocating the tail: the tail alloc
        # may evict cache leaves, and a bare cache ref would make the match
        # itself a victim
        allocator.incref(shared)
        n_fresh = n_total - len(shared)
        fresh = (prefix_cache.alloc_pages(allocator, n_fresh)
                 if prefix_cache is not None else allocator.alloc(n_fresh)) \
            if n_fresh else []
        if fresh is None:
            allocator.decref(shared)
            return None
        self.waiting.popleft()
        slot = self._free_slots.pop()
        st = RequestState(req=req, slot=slot, pages=shared + fresh,
                          admit_seq=next(self._admit_seq), admit_time=now,
                          n_evictions=self._eviction_counts.get(req.rid, 0),
                          cached_tokens=cached_tokens,
                          n_shared_pages=len(shared),
                          prefill_pos=cached_tokens)
        if match and match.cow:
            st.cow_page = (match.pages[-1], fresh[0])
        self.active[slot] = st
        self.n_admitted += 1
        self.cached_prompt_tokens += cached_tokens
        if prefix_cache is not None:
            prefix_cache.record_admitted(match)
        return st

    # -- eviction / completion --------------------------------------------
    def evict_youngest(self, allocator: PageAllocator,
                       requester: Optional[RequestState] = None
                       ) -> Optional[RequestState]:
        """Free the youngest resident request (restart semantics) to relieve
        page pressure; it re-queues at the FRONT of the waiting line (it was
        admitted before anything still waiting, so FCFS order is preserved).

        Seniority rule: only residents STRICTLY YOUNGER than ``requester``
        are victims; if the requester is itself the youngest, IT is evicted.
        The oldest resident is therefore never unseated, which guarantees
        forward progress (no evict-each-other livelock between two growing
        requests).  ``requester=None`` evicts the globally youngest.
        Parked residents (disaggregation handoff: prefill done, awaiting KV
        migration) are never victims — losing their KV before the receiver
        copies it would orphan the handoff.  Returns the evicted state, or
        None if nothing is resident."""
        live = [st for st in self.active.values() if not st.parked]
        if requester is None:
            victims = live
        else:
            victims = [st for st in live
                       if st.admit_seq > requester.admit_seq] or [requester]
        if not victims:
            return None
        st = max(victims, key=lambda s: s.admit_seq)
        self._release(st, allocator)
        st.generated.clear()           # restart: KV + tokens are recomputed
        st.prefilled = False
        st.prefill_pos = 0             # chunked-prefill progress is discarded
        st.cached_tokens = 0           # re-admission re-matches the cache
        st.n_shared_pages = 0
        st.cow_page = None
        st.n_evictions += 1
        self.n_evictions += 1
        self._eviction_counts[st.req.rid] = st.n_evictions
        self.waiting.appendleft(st.req)
        return st

    def finish(self, slot: int, allocator: PageAllocator,
               now: float) -> RequestState:
        st = self.active[slot]
        st.finish_time = now
        self._release(st, allocator)
        self.n_finished += 1
        return st

    # -- disaggregation (prefill/decode handoff) ---------------------------
    def adopt(self, st: RequestState) -> None:
        """Install a migrated RequestState (pages already reserved/written by
        the engine's adopt path) into a free slot on the DECODE tier.  The
        state arrives with prefill complete; it joins the masked decode batch
        on the next tick.  Budget accounting is the same worst-case
        reservation as try_admit — the router only migrates when it fits."""
        if not self._free_slots:
            raise RuntimeError("adopt with no free slot (router must check)")
        st.slot = self._free_slots.pop()
        st.admit_seq = next(self._admit_seq)
        st.parked = False
        self.active[st.slot] = st
        self.n_adopted += 1

    def release(self, st: RequestState, allocator: PageAllocator) -> None:
        """Public release for the donor side of a migration: after the
        receiver acks, the parked state's pages leave through the SAME
        release funnel as finish/evict (so the prefix cache sees the decref
        and cached pages stay shareable for future local hits)."""
        self._release(st, allocator)

    def _release(self, st: RequestState, allocator: PageAllocator) -> None:
        """The ONLY place a resident's pages leave the scheduler — both
        finish() and evict_youngest() funnel here, so `release_hook` sees
        every release (the prefix cache decrefs instead of freeing)."""
        pages, st.pages = st.pages, []
        if self.release_hook is not None:
            self.release_hook(st, pages, allocator)
        else:
            allocator.free(pages)
        del self.active[st.slot]
        self._free_slots.append(st.slot)
