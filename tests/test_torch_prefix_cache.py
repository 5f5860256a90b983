"""The port's radix prefix cache, allocator introspection, cache-aware
scheduler and replica router against the reference's, and the port's
engine with the cache on against itself with the cache off.

The host modules (PageAllocator + PrefixCache + Scheduler) run one seeded
script of admissions, completions with inserts, evictions, lookups and
pool-pressure allocations in both packages side by side and must agree
at every step.  The engine runs the reference test's shared-prefix trace
(tests/test_prefix_cache.py) on qwen3_moe_235b reduced() with the cache
on and off: the same tokens bit for bit, the same hit thresholds, and the
copy-on-write copy leaves the shared page's bytes as they were.  The
trace geometry of chip_smoke's phase 30 runs here too: the hit count the
card must reproduce, and cache evictions under its small pool."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.paged_kv import PageAllocator as JPageAllocator
from repro.serve.prefix_cache import PrefixCache as JPrefixCache
from repro.serve.router import ReplicaRouter as JReplicaRouter
from repro.serve.router import RouterConfig as JRouterConfig
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch.configs import get_arch
from repro_torch.core.recipes import get_recipe
from repro_torch.models.lm import init_params
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.paged_kv import PageAllocator
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.router import ReplicaRouter, RouterConfig
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.transfer import KVTransferCodec

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# Lockstep: the port's host modules against the reference's.
# ---------------------------------------------------------------------------
class _Side:
    """One package's allocator + cache + cache-aware scheduler."""

    def __init__(self, alloc_cls, cache_cls, sched_cls, req_cls, ps,
                 n_pages):
        self.alloc = alloc_cls(n_pages, ps)
        self.cache = cache_cls(ps)
        self.sched = sched_cls(3, 64, release_hook=lambda st, p, a:
                               a.decref(p))
        self.req_cls = req_cls
        self.held = []                  # pages taken by pressure allocations

    def view(self):
        """Everything the two sides must agree on after a step."""
        a = self.alloc
        return dict(
            refs=[a.refcount(p) for p in range(a.n_pages)],
            free=a.free_pages, live=a.live_pages, shared=a.shared_pages,
            stats=self.cache.stats(), sched=self.sched.stats(),
            reserved=self.sched.reserved_tokens,
            waiting=[list(r.prompt) for r in self.sched.waiting],
            active={s: (list(st.pages), st.prefill_pos, st.cached_tokens,
                        st.n_shared_pages, st.cow_page, st.prefilled)
                    for s, st in self.sched.active.items()})


def _lockstep_script(rng, n_steps, ps):
    """The operations of one seeded run: prompts over three tenant
    prefixes (page-aligned and not), repeats of earlier prompts and fresh
    ones."""
    tenants = [[int(t) for t in rng.integers(1, 500, ps * k)]
               for k in (2, 3, 1)]
    sent = []
    for _ in range(n_steps):
        op = int(rng.integers(0, 6))
        kind = int(rng.integers(0, 4))
        if kind == 0 and sent:
            prompt = list(sent[int(rng.integers(len(sent)))])
        elif kind == 1:
            prompt = [int(t) for t in rng.integers(1, 500,
                                                   int(rng.integers(2, 14)))]
        else:
            t = tenants[int(rng.integers(len(tenants)))]
            cut = int(rng.integers(ps, len(t) + 1))
            prompt = t[:cut] + [int(x) for x in rng.integers(
                1, 500, int(rng.integers(0, 7)))]
        sent.append(prompt)
        yield op, prompt, int(rng.integers(1, 5)), int(rng.integers(0, 99))


def _step(side, op, prompt, n, pick):
    """Apply one operation; returns what the step observed."""
    sched, alloc, cache = side.sched, side.alloc, side.cache
    slots = sorted(sched.active)
    if op == 0:                                   # submit + admit
        sched.submit(side.req_cls(prompt=prompt, max_new_tokens=n))
        st = sched.try_admit(alloc, now=0.0, prefix_cache=cache)
        seen = None if st is None else (st.slot, list(st.pages),
                                        st.cow_page, st.cached_tokens)
        if st is not None:
            st.cow_page = None                    # the engine copies it
        return seen
    if op == 1 and slots:                         # prefill done + insert
        st = sched.active[slots[pick % len(slots)]]
        st.prefill_pos = len(st.req.prompt)
        st.prefilled = True
        return cache.insert(st.req.prompt, st.pages, alloc)
    if op == 2 and slots:                         # finish
        return sched.finish(slots[pick % len(slots)], alloc, now=1.0).slot
    if op == 3:                                   # evict the youngest
        ev = sched.evict_youngest(alloc)
        return None if ev is None else ev.slot
    if op == 4:                                   # queries
        m = cache.lookup(prompt)
        return (cache.match_tokens(prompt), list(cache.match_pages(prompt)),
                None if m is None else (list(m.pages), m.tokens, m.cow))
    if side.held and pick % 2:                    # pool pressure
        return alloc.decref([side.held.pop(pick % len(side.held))])
    got = cache.alloc_pages(alloc, n)
    side.held.extend(got or [])
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_modules_agree_with_the_reference_in_lockstep(seed):
    ps, n_pages = 4, 20
    port = _Side(PageAllocator, PrefixCache, Scheduler, Request, ps, n_pages)
    ref = _Side(JPageAllocator, JPrefixCache, JScheduler, JRequest, ps,
                n_pages)
    ops_seen = set()
    for i, (op, prompt, n, pick) in enumerate(
            _lockstep_script(np.random.default_rng(seed), 400, ps)):
        got = _step(port, op, prompt, n, pick)
        want = _step(ref, op, prompt, n, pick)
        assert got == want, (i, op)
        assert port.view() == ref.view(), (i, op)
        port.cache.check_invariants(port.alloc)
        ref.cache.check_invariants(ref.alloc)
        ops_seen.add(op)
    s = port.cache.stats()
    assert ops_seen == set(range(6))
    assert s["prefix_hits"] > 0 and s["cache_evictions"] > 0
    assert port.sched.stats()["evicted"] > 0


# ---------------------------------------------------------------------------
# The router: the reference's fake-engine scoring case in both packages.
# ---------------------------------------------------------------------------
def _fake_engine(cfg_cls, alloc_cls, cache_cls, ps=4, n_pages=64,
                 budget=256):
    class Sched:
        reserved_tokens = 0

    class Eng:
        def __init__(self):
            self.ecfg = cfg_cls(page_size=ps, n_pages=n_pages,
                                token_budget=budget, prefix_cache=True)
            self.alloc = alloc_cls(n_pages, ps)
            self.prefix_cache = cache_cls(ps)
            self.sched = Sched()
            self.submitted = []

        def submit(self, req):
            self.submitted.append(req)
    return Eng()


def _route_case(cfg_cls, alloc_cls, cache_cls, router_cls, rcfg_cls,
                req_cls):
    """tests/test_prefix_cache.py::test_router_prefers_prefix_overlap_then_
    load, returning every pick and the route counts."""
    def fake():
        return _fake_engine(cfg_cls, alloc_cls, cache_cls)
    e0, e1 = fake(), fake()
    prefix = list(range(700, 716))
    pages = e1.alloc.alloc(e1.alloc.pages_for(len(prefix)))
    e1.prefix_cache.insert(prefix, pages, e1.alloc)
    e1.alloc.decref(pages)
    router = router_cls([e0, e1], rcfg_cls())
    picks = [router.route(req_cls(prompt=prefix + [1, 2], max_new_tokens=4))]
    e1.sched.reserved_tokens = e1.ecfg.token_budget
    for p in range(1, e1.ecfg.n_pages):
        if e1.alloc.refcount(p) == 0:
            e1.alloc.alloc(1)
    heavy = router_cls([e0, e1], rcfg_cls(w_prefix=0.2, w_load=2.0))
    picks.append(heavy.route(req_cls(prompt=prefix + [3], max_new_tokens=4)))
    rr = router_cls([fake(), fake()], rcfg_cls())
    picks += [rr.route(req_cls(prompt=[9, 9, 9], max_new_tokens=2))
              for _ in range(4)]
    return picks, [router.route_counts, heavy.route_counts, rr.route_counts]


def test_router_scores_as_the_reference():
    port = _route_case(ServeConfig, PageAllocator, PrefixCache,
                       ReplicaRouter, RouterConfig, Request)
    ref = _route_case(JServeConfig, JPageAllocator, JPrefixCache,
                      JReplicaRouter, JRouterConfig, JRequest)
    assert port == ref
    picks, counts = port
    assert picks[:2] == [1, 0] and set(picks[2:]) == {0, 1}
    assert sum(counts[2]) == 4


# ---------------------------------------------------------------------------
# The engine: cache on == cache off, bit for bit.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qwen3():
    cfg = get_arch("qwen3_moe_235b").reduced()
    return cfg, init_params(cfg, seed=0, device="cpu")


def _ref_trace(vocab):
    """The prompts of tests/test_prefix_cache.py::test_engine_bitwise_
    identical_cache_on_vs_off."""
    rng = np.random.default_rng(11)
    prefix = [int(t) for t in rng.integers(1, vocab, 8)]
    prompts = [prefix + [int(t) for t in rng.integers(1, vocab, k)]
               for k in (3, 4, 2, 1)]
    prompts.append(list(prompts[0]))              # whole-prompt hit -> CoW
    prompts.append(prefix[:4] + [7, 8, 9])        # mid-edge divergence
    return prompts


def _serve(cfg, params, prompts, **kw):
    ecfg = ServeConfig(**{**dict(
        max_batch=3, page_size=4, n_pages=32, max_pages_per_req=8,
        token_budget=128, prefill_buckets=(16,), prefill_chunk=4,
        fp8_kv=True, w8_weights=True), **kw})
    eng = ServeEngine(cfg, get_recipe("fp8_flow"), params, ecfg,
                      device="cpu")
    reqs = [Request(prompt=list(p), max_new_tokens=4) for p in prompts]
    res = eng.run(reqs, realtime=False)
    return eng, [res[q.rid]["tokens"] for q in reqs]


def test_engine_bitwise_identical_cache_on_vs_off(qwen3):
    """The reference test's trace and thresholds; every live page is the
    cache's at refcount 1 afterwards, and the cache-off engine returns
    every page."""
    cfg, params = qwen3
    prompts = _ref_trace(cfg.vocab)
    eng_off, toks_off = _serve(cfg, params, prompts)
    eng_on, toks_on = _serve(cfg, params, prompts, prefix_cache=True)
    assert toks_on == toks_off
    s = eng_on.stats()
    assert s["prefix_hits"] >= 3 and s["prefix_hit_tokens"] >= 20
    assert s["prefix_lookups"] == len(prompts)
    eng_on.prefix_cache.check_invariants(eng_on.alloc)
    assert eng_on.alloc.live_pages == eng_on.prefix_cache.n_cached_pages
    assert all(eng_on.alloc.refcount(p) == 1
               for n in eng_on.prefix_cache._iter_nodes() for p in n.pages)
    assert eng_off.alloc.free_pages == 31


def _watch_copies(monkeypatch):
    """Wrap the engine's copy_page: each copy must leave dst equal to src
    and src as it was; returns the list of (src page, its bytes then, a
    reader of a page's bytes now)."""
    copies = []
    real_copy_page = engine_mod.copy_page

    def copy_page(pools, src, dst):
        codec = KVTransferCodec(pools)

        def page(p):
            return codec._gather(pools, codec._pad_ids([p])).clone()
        before = page(src)
        real_copy_page(pools, src, dst)
        assert torch.equal(page(dst), before)
        assert torch.equal(page(src), before)
        copies.append((src, before, page))
    monkeypatch.setattr(engine_mod, "copy_page", copy_page)
    return copies


def test_chip_smoke_prefix_trace_geometry(qwen3, monkeypatch):
    """chip_smoke phase 30's trace and engine settings at reduced() width:
    the hit count the card must reproduce (PREFIX_HITS), the same tokens
    with the cache off, on, and on under PRESSURE_PAGES, where the cache
    gives up leaves.  The trace's whole-prompt repeat copies its boundary
    page once (copy-on-write): the copy equals the shared page, which keeps
    its bytes to the end of the run."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    cfg, params = qwen3
    runs = {}
    copies = _watch_copies(monkeypatch)
    for name, kw in (("off", {}), ("on", dict(prefix_cache=True)),
                     ("pressure", dict(prefix_cache=True,
                                       n_pages=chip_smoke.PRESSURE_PAGES))):
        eng = ServeEngine(cfg, get_recipe("fp8_flow"), params, ServeConfig(
            **{**chip_smoke.PREFIX_ECFG, **kw}), device="cpu")
        reqs = chip_smoke.prefix_trace(cfg.vocab)
        res = eng.run(reqs, realtime=False)
        runs[name] = ([res[q.rid]["tokens"] for q in reqs], res.stats)
        if name == "on":
            assert len(copies) == 1
            src, before, page = copies[0]
            assert eng.alloc.refcount(src) == 1          # still cached
            assert torch.equal(page(src), before)
        elif name == "off":
            assert not copies
    assert runs["on"][0] == runs["off"][0] == runs["pressure"][0]
    on = runs["on"][1]
    assert on["prefix_lookups"] == 16
    assert on["prefix_hits"] == chip_smoke.PREFIX_HITS
    assert on["prefill_chunks"] < runs["off"][1]["prefill_chunks"]
    assert runs["pressure"][1]["cache_evictions"] > 0
