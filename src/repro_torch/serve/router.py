"""Prefix-aware multi-replica router: one front door over N ServeEngines.

Counterpart of ``repro.serve.router``: host logic only, so the port keeps
the reference's code as it is.  Every replica of a fleet may sit on the
same device (the launcher puts them all on ``--device``).

One engine instance is not a production service.  The router owns the
global request queue and, per arriving request, scores every replica
flexlb-style (rtp-llm's ``KvCacheManager`` + load-balance scoring):

    score = w_prefix * cached_prefix_overlap - w_load * load

  * **overlap** — the fraction of the request's prompt already resident in
    that replica's radix prefix cache (``PrefixCache.match_tokens``, a pure
    peek: no LRU touch, no hit accounting).  Routing a request to the
    replica that already holds its prefix turns the prefill into a cache
    hit: the prompt is quantized once per FLEET, not once per replica.
  * **load** — the mean of the replica's reserved-token-budget fill and its
    KV-pool page occupancy, so a cold replica absorbs new tenants instead
    of piling every popular prefix onto one engine.

Ties (e.g. a fleet of cold replicas) break toward the least-loaded replica,
then round-robin, so unprefixed traffic still spreads.

The run loop interleaves `engine.tick` across replicas in one thread — the
same cooperative loop ServeEngine.run uses, generalized to N engines — and
merges per-request results/stats into one TraceResults.  Every routing
decision lands in telemetry (`route` records + per-replica counters) so the
reporter can show placement quality next to hit rates.

Across ranks, every engine of a fleet shares one plan and mesh (as
``repro/launch/serve.py:97-108`` builds them) and every rank runs the
same fleet on the same requests: the routing, the drain order and the
migrations are host decisions on state that is the same on every rank
(the scores read the schedulers and the radix trees, and the donor order
follows the ticks), so they are the same on every rank; each engine
compares its sampled tokens across the world every tick, and realtime
arrivals are agreed as the engine's are (``engine.arrivals_due``).  A
page migration runs on each rank from its own pool, which holds the same
bytes as every other rank's.  Telemetry writes on rank 0 only.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.sink import null_telemetry, on_rank
from repro_torch.serve.engine import ServeEngine, TraceResults, arrivals_due
from repro_torch.serve.scheduler import Request


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    w_prefix: float = 1.0       # weight of cached-prefix overlap
    w_load: float = 1.0         # weight of the load penalty
    min_overlap: float = 0.0    # overlap below this scores as 0 (ignore
                                # trivial matches when balancing load)


class ReplicaRouter:
    """Score-and-dispatch over N ServeEngine replicas."""

    def __init__(self, engines: Sequence[ServeEngine],
                 rcfg: RouterConfig = RouterConfig(), telemetry=None):
        if not engines:
            raise ValueError("router needs at least one replica")
        self.engines = list(engines)
        meshes = [getattr(getattr(e, "plan", None), "mesh", None)
                  for e in self.engines]
        if any(m != meshes[0] for m in meshes):
            raise ValueError("a fleet's engines share one plan's mesh")
        self.rcfg = rcfg
        self.tel = on_rank(telemetry if telemetry is not None
                           else null_telemetry(), meshes[0])
        self.n_routed = 0
        self._rr = 0                      # round-robin tie-break cursor
        self.route_counts = [0] * len(self.engines)

    # -- scoring -----------------------------------------------------------
    def overlap(self, idx: int, req: Request) -> float:
        eng = self.engines[idx]
        if eng.prefix_cache is None or not req.prompt:
            return 0.0
        ov = eng.prefix_cache.match_tokens(req.prompt) / len(req.prompt)
        return ov if ov >= self.rcfg.min_overlap else 0.0

    def load(self, idx: int) -> float:
        eng = self.engines[idx]
        budget_fill = eng.sched.reserved_tokens / max(eng.ecfg.token_budget,
                                                      1)
        pool = max(eng.ecfg.n_pages - 1, 1)
        page_fill = (pool - eng.alloc.free_pages) / pool
        return 0.5 * (budget_fill + page_fill)

    def score(self, idx: int, req: Request) -> float:
        return self.rcfg.w_prefix * self.overlap(idx, req) \
            - self.rcfg.w_load * self.load(idx)

    # -- dispatch ----------------------------------------------------------
    def _candidates(self) -> List[int]:
        """Replica indices eligible for NEW requests (a disaggregated fleet
        restricts this to the prefill tier)."""
        return list(range(len(self.engines)))

    def route(self, req: Request) -> int:
        """Pick a replica for `req` (argmax score; ties toward the least
        loaded, then round-robin) and submit it there."""
        scored = [(self.score(i, req), -self.load(i), i)
                  for i in self._candidates()]
        best = max(s for s, _, _ in scored)
        tied = [t for t in scored if t[0] >= best - 1e-12]
        if len(tied) > 1:
            best_load = max(l for _, l, _ in tied)
            tied = [t for t in tied if t[1] >= best_load - 1e-12]
        idx = tied[(self._rr % len(tied))][2] if len(tied) > 1 else tied[0][2]
        if len(tied) > 1:
            self._rr += 1
        ov = self.overlap(idx, req)
        self.engines[idx].submit(req)
        self.n_routed += 1
        self.route_counts[idx] += 1
        self.tel.counter("router_decisions",
                         labels={"replica": str(idx)}).inc()
        if self.tel.enabled:
            self.tel.record("route", rid=req.rid, replica=idx,
                            overlap=round(ov, 4),
                            load=round(self.load(idx), 4),
                            prompt_tokens=len(req.prompt))
        return idx

    # -- run loop ----------------------------------------------------------
    def _busy(self) -> bool:
        return not all(e.sched.idle() for e in self.engines)

    def _drain(self, now: float, results: Dict[int, dict]) -> bool:
        """Router-level work between engine ticks (the disaggregated fleet
        migrates parked prefills and requeues decode-tier evictions here).
        Returns True iff anything progressed."""
        return False

    def run(self, requests: Sequence[Request],
            realtime: bool = True) -> Dict[int, dict]:
        """Drive a trace across the fleet: route each request at its
        arrival, interleave one tick per replica, merge results."""
        pending = deque(sorted(requests, key=lambda r: r.arrival_time))
        results = TraceResults()
        t0 = time.perf_counter()
        idle_spins = 0
        while pending or self._busy():
            now = time.perf_counter() - t0
            lead = self.engines[0]
            for _ in range(arrivals_due(pending, now, realtime,
                                        getattr(lead, "agree_group", None),
                                        getattr(lead, "device", None))):
                self.route(pending.popleft())
            progressed = any([e.tick(now, results) for e in self.engines])
            # Drain runs every loop and counts as progress: on a SATURATED
            # fleet every engine's tick can return False (all at budget, no
            # admissible head) while the handoff queue is nonempty — the old
            # guard credited only engine ticks, so a fleet that was one
            # migration away from unblocking tripped the deadlock error.
            # Migration frees donor budget / fills decode slots, so crediting
            # it keeps the idle counter honest.
            if self._drain(now, results):
                progressed = True
            if progressed:
                idle_spins = 0
                continue
            if pending:
                time.sleep(max(0.0, min(0.002,
                                        pending[0].arrival_time - now)))
                continue
            idle_spins += 1
            if idle_spins > 1000:
                raise RuntimeError(
                    "router deadlock: waiting requests can never be "
                    "admitted on any replica (check token_budget / n_pages)")
        results.stats = self.stats()
        self.tel.record("router_summary", **{
            k: v for k, v in results.stats.items()
            if not isinstance(v, (list, dict))})
        self.tel.flush()
        return results

    def stats(self) -> Dict[str, object]:
        """Fleet aggregate + per-replica breakdown."""
        agg: Dict[str, object] = {"replicas": len(self.engines),
                                  "routed": self.n_routed,
                                  "route_counts": list(self.route_counts)}
        per = [e.stats() for e in self.engines]
        for key in ("ticks", "admitted", "evicted", "finished", "rejected",
                    "prefill_chunks", "decode_tokens", "prefix_hits",
                    "prefix_lookups", "prefix_hit_tokens", "cache_evictions",
                    "shared_pages", "cache_evicted_pages",
                    "adopted", "migrated_out"):
            vals = [p[key] for p in per if key in p]
            if vals:
                agg[key] = sum(vals)
        agg["per_replica"] = per
        return agg


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """Knobs for the disaggregated (prefill/decode) fleet."""
    transfer_budget_bytes: int = 1 << 20   # wire bytes per drain cycle; at
                                           # least one migration always goes
                                           # through (no starvation), the
                                           # budget shapes burst smoothness


class DisaggRouter(ReplicaRouter):
    """Two-tier fleet: prefill replicas (admission + chunked prefill only)
    feed decode replicas through a casting-free KV-page migration queue.

    Why disaggregate: in a mixed engine a long prompt's prefill chunks ride
    every tick alongside resident decodes, so decode time-between-tokens
    inherits the chunk's compute (the interference the chunked-prefill work
    bounded but could not remove).  Splitting tiers makes decode ticks pure
    decode — TBT no longer sees prefill compute at all — at the price of one
    page-granular KV migration per request, which the FP8 pool makes cheap
    (~1 B/elem) and EXACT (pure bitcast, provably zero re-quantization:
    `KVTransferCodec.assert_casting_free`).

    Handoff protocol per request (router-orchestrated, two-phase):

      1. a prefill replica finishes the last chunk, emits the first token,
         and PARKS the request (pages/slot/budget held) in its handoff queue;
      2. the drain step picks the longest-waiting parked request, scores the
         decode tier (prefix overlap − load, same weights as routing),
         reserves pages on the winner — blocks already in the receiver's
         radix cache are SHARED (incref), not shipped: po2 pages are
         content-addressable, the local copy is bit-identical — and ships
         the rest as one uint8 message under ``transfer_budget_bytes``;
      3. the receiver scatters the bytes into its pool, adopts the request
         into its decode batch at the request's `pos`, re-publishes the
         prompt prefix into its own radix tree (so the NEXT migration of
         this tenant dedupes), and acks; only then does the donor release
         the parked pages through its cache-aware funnel.

    Decode-tier evictions (pool pressure) restart through the prefill tier:
    the drain requeues them with the router, preserving restart semantics.
    """

    def __init__(self, prefill_engines: Sequence[ServeEngine],
                 decode_engines: Sequence[ServeEngine],
                 rcfg: RouterConfig = RouterConfig(),
                 dcfg: DisaggConfig = DisaggConfig(), telemetry=None):
        for e in prefill_engines:
            if e.ecfg.role != "prefill":
                raise ValueError("prefill tier engine has role "
                                 f"{e.ecfg.role!r} (want 'prefill')")
        for e in decode_engines:
            if e.ecfg.role != "decode":
                raise ValueError("decode tier engine has role "
                                 f"{e.ecfg.role!r} (want 'decode')")
        if not decode_engines:
            raise ValueError("disaggregated fleet needs a decode tier")
        super().__init__(list(prefill_engines) + list(decode_engines),
                         rcfg, telemetry)
        self.prefill_engines = list(prefill_engines)
        self.decode_engines = list(decode_engines)
        self.dcfg = dcfg
        self.n_migrations = 0
        self.kv_transfer_bytes = 0
        self.deduped_pages = 0
        self.shipped_pages = 0
        self.requeued_evictions = 0
        self.budget_deferrals = 0
        self.reserve_failures = 0

    def _candidates(self) -> List[int]:
        # new requests only ever land on the prefill tier
        return list(range(len(self.prefill_engines)))

    # -- receiver choice ---------------------------------------------------
    def _recv_score(self, eng: ServeEngine, req: Request) -> float:
        ov = 0.0
        if eng.prefix_cache is not None and req.prompt:
            ov = eng.prefix_cache.match_tokens(req.prompt) / len(req.prompt)
            if ov < self.rcfg.min_overlap:
                ov = 0.0
        i = self.engines.index(eng)
        return self.rcfg.w_prefix * ov - self.rcfg.w_load * self.load(i)

    # -- the drain: migrations + eviction requeues -------------------------
    def _drain(self, now: float, results: Dict[int, dict]) -> bool:
        progressed = False
        # decode-tier evictions restart via the prefill tier (a decode
        # replica never admits, so anything in its waiting queue would
        # starve there)
        for eng in self.decode_engines:
            while eng.sched.waiting:
                req = eng.sched.waiting.popleft()
                self.route(req)
                self.requeued_evictions += 1
                progressed = True

        budget = self.dcfg.transfer_budget_bytes
        spent = 0
        migrated = 0
        while True:
            donors = [e for e in self.prefill_engines if e.handoff]
            if not donors:
                break
            # FIFO across the tier: longest-parked request first
            donor = min(donors,
                        key=lambda e: (e.handoff[0].first_token_time or 0.0,
                                       e.handoff[0].admit_seq))
            st = donor.handoff[0]
            recvs = sorted(self.decode_engines,
                           key=lambda e: self._recv_score(e, st.req),
                           reverse=True)
            res = recv = None
            for cand in recvs:
                res = cand.reserve_for_adopt(st.req)
                if res is not None:
                    recv = cand
                    break
            if res is None:
                self.reserve_failures += 1
                break              # decode tier full right now; retry later
            shared, fresh = res
            cost = donor.codec.bytes_for(len(fresh))
            if migrated > 0 and spent + cost > budget:
                # budget exhausted this cycle — but the FIRST migration of a
                # cycle always goes through, so a single page batch larger
                # than the budget cannot starve forever
                recv.abort_adopt(shared, fresh)
                self.budget_deferrals += 1
                break
            t_mig = time.perf_counter()
            msg = donor.pack_handoff(st, skip_pages=len(shared))
            meta, payload = recv.codec.unpack(msg)
            timing = {"arrival": st.req.arrival_time,
                      "admit": st.admit_time,
                      "first": st.first_token_time,
                      "last": st.last_token_time}
            recv.commit_adopt(meta, payload, shared, fresh, now,
                              timing=timing)
            donor.handoff.popleft()
            donor.release_parked(st)           # the receiver ack
            mig_ms = (time.perf_counter() - t_mig) * 1e3
            spent += cost
            migrated += 1
            self.n_migrations += 1
            self.kv_transfer_bytes += cost
            self.deduped_pages += len(shared)
            self.shipped_pages += len(fresh)
            self.tel.counter("kv_transfer_bytes").inc(cost)
            self.tel.counter("migrations_total").inc()
            self.tel.histogram("migration_ms").observe(mig_ms)
            if self.tel.enabled:
                self.tel.record(
                    "migration", rid=st.req.rid,
                    donor=self.engines.index(donor),
                    receiver=self.engines.index(recv),
                    shipped_pages=len(fresh), deduped_pages=len(shared),
                    bytes=cost, ms=round(mig_ms, 3),
                    queue_ms=round((now - (st.first_token_time or now))
                                   * 1e3, 3))
            progressed = True
        depth = sum(len(e.handoff) for e in self.prefill_engines)
        self.tel.gauge("handoff_queue_depth").set(depth)
        return progressed

    # -- reporting ---------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        agg = super().stats()
        agg["disagg"] = {
            "prefill_replicas": len(self.prefill_engines),
            "decode_replicas": len(self.decode_engines),
            "migrations": self.n_migrations,
            "kv_transfer_bytes": self.kv_transfer_bytes,
            "shipped_pages": self.shipped_pages,
            "deduped_pages": self.deduped_pages,
            "requeued_evictions": self.requeued_evictions,
            "budget_deferrals": self.budget_deferrals,
            "reserve_failures": self.reserve_failures,
            "transfer_budget_bytes": self.dcfg.transfer_budget_bytes,
        }
        return agg

    def run(self, requests: Sequence[Request],
            realtime: bool = True) -> Dict[int, dict]:
        results = super().run(requests, realtime)
        self.tel.record("disagg_summary", **results.stats["disagg"])
        self.tel.flush()
        return results
