"""The port's casting-free KV migration wire and its disaggregated fleet
against the reference's (serve/transfer.py, serve/router.py, the engine's
roles and migration API, dist/scale_sync.py's exponent codecs).

The wire: the int8 exponent codecs equal the frexp forms and the
reference's over every exponent a po2 scale can have; the header round
trips; the port's message for the same pools and meta is the reference's
byte for byte (e4m3 pools of raw random bytes, NaN encodings included,
and bf16 pools); scatter then gather is bitwise; the codec runs no float
op (and the check fails a textbook quantize and dequantize).  The fleet:
a 1 prefill + 1 decode port fleet on qwen15_05b reduced() serves the
port's cache-on mixed engine's tokens bit for bit, and its fleet stats
and first tokens equal one reference DisaggRouter run of the same trace.
The launcher runs the fleet with telemetry, and the port's reporter reads
its JSONL."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.recipes import get_recipe as jget_recipe
from repro.dist import scale_sync as jss
from repro.models.lm import ParallelPlan
from repro.models.lm import init_params as jinit_params
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.router import DisaggRouter as JDisaggRouter
from repro.serve.scheduler import Request as JRequest
from repro.serve.transfer import KVTransferCodec as JKVTransferCodec
from repro.serve.transfer import TransferMeta as JTransferMeta
from repro_torch.configs import get_arch
from repro_torch.core.recipes import get_recipe
from repro_torch.dist import scale_sync as ss
from repro_torch.launch import serve as launch_serve
from repro_torch.obs import report
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.router import (DisaggConfig, DisaggRouter,
                                      ReplicaRouter)
from repro_torch.serve.scheduler import Request
from repro_torch.serve.transfer import (KVTransferCodec, TransferMeta,
                                        check_casting_free)
from repro_torch.weights import params_from_numpy, pools_from_numpy
from tests.conftest import make_mesh11


# ---------------------------------------------------------------------------
# The exponent codecs.
# ---------------------------------------------------------------------------
def test_exponent_bit_codecs_match_frexp_and_the_reference():
    """Every exponent po2_scale can give (|e| <= 126): the bit forms equal
    the frexp / ldexp forms bit for bit, and each equals the reference's."""
    e_np = np.arange(-126, 127, dtype=np.int8)
    exps = torch.from_numpy(e_np)
    scales = ss.exp_i8_to_scale(exps)
    ref_scales = np.asarray(jss.exp_i8_to_scale(jnp.asarray(e_np)))
    assert np.array_equal(scales.view(torch.int32).numpy(),
                          ref_scales.view(np.int32))
    assert torch.equal(ss.exp_i8_to_scale_bits(exps).view(torch.int32),
                       scales.view(torch.int32))
    assert torch.equal(ss.scale_to_exp_i8_bits(scales), exps)
    assert torch.equal(ss.scale_to_exp_i8(scales), exps)
    assert np.array_equal(
        np.asarray(jss.scale_to_exp_i8_bits(jnp.asarray(ref_scales))), e_np)


# ---------------------------------------------------------------------------
# The header.
# ---------------------------------------------------------------------------
def _meta(cls, **kw):
    return cls(**{**dict(rid=42, n_pages=3, page_size=4, bytes_per_page=1040,
                         pos=11, max_new_tokens=9,
                         temperature=float(np.float32(0.7)),
                         prompt=tuple(range(5, 16)), generated=(99,)), **kw})


def test_transfer_meta_round_trips_as_the_reference_writes_it():
    meta = _meta(TransferMeta)
    msg = meta.to_bytes()
    assert np.array_equal(msg, _meta(JTransferMeta).to_bytes())
    got, off = TransferMeta.from_bytes(msg)
    assert got == meta and off == len(msg)
    assert np.float32(got.temperature) == np.float32(0.7)
    empty = _meta(TransferMeta, n_pages=0, bytes_per_page=8, pos=2,
                  temperature=0.0, prompt=(1, 2), generated=())
    assert TransferMeta.from_bytes(empty.to_bytes())[0] == empty
    bad = msg.copy()
    bad[0] ^= 0xFF                          # corrupt the magic
    with pytest.raises(ValueError, match="magic"):
        TransferMeta.from_bytes(bad)


# ---------------------------------------------------------------------------
# The codec against the reference's.
# ---------------------------------------------------------------------------
def _np_pools(seed, fp8, n_pages=8, L=2, ps=4, KV=2, hd=6):
    """Two-stack pools of numpy leaves in the paged layout: e4m3 payloads
    of raw random bytes (0x7F / 0xFF NaN encodings among them) with po2
    scales, or bf16 payloads."""
    import ml_dtypes
    rng = np.random.default_rng(seed)
    shape = (L, n_pages, ps, KV, hd)

    def one():
        if fp8:
            raw = rng.integers(0, 256, shape, dtype=np.uint8)
            exp = rng.integers(-30, 31, shape[:-1] + (1,)).astype(np.int32)
            return {"data": raw.view(ml_dtypes.float8_e4m3fn),
                    "scale": ((exp + 127) << 23).view(np.float32)}
        return {"data": rng.standard_normal(shape).astype(
            ml_dtypes.bfloat16)}
    return {"attn": {"k": one(), "v": one()},
            "alt": {"k": one(), "v": one()}}


def _jpools(pools):
    return jax.tree.map(jnp.asarray, pools)


@pytest.mark.parametrize("fp8", [True, False], ids=["fp8", "bf16"])
def test_pack_is_the_references_message_byte_for_byte(fp8):
    np_pools = _np_pools(0 if fp8 else 1, fp8)
    if fp8:
        raw = np_pools["attn"]["k"]["data"].view(np.uint8)
        assert ((raw == 0x7F) | (raw == 0xFF)).any()
    pools, jpools = pools_from_numpy(np_pools, "cpu"), _jpools(np_pools)
    codec, jcodec = KVTransferCodec(pools), JKVTransferCodec(jpools)
    assert codec.bytes_per_page == jcodec.bytes_per_page == 2 * 2 * (
        2 * 4 * 2) * (6 * (1 if fp8 else 2) + (1 if fp8 else 0))
    assert [codec.bytes_for(n) for n in range(6)] == \
        [jcodec.bytes_for(n) for n in range(6)]
    for ids in ([2, 5, 1], [7], [3, 4, 6, 1, 2]):
        kw = dict(rid=7, n_pages=len(ids), page_size=4,
                  bytes_per_page=codec.bytes_per_page, pos=12,
                  max_new_tokens=4, temperature=0.0,
                  prompt=tuple(range(12)), generated=(3,))
        msg = codec.pack(pools, ids, TransferMeta(**kw))
        assert msg.dtype == np.uint8
        assert np.array_equal(msg, jcodec.pack(jpools, ids,
                                               JTransferMeta(**kw)))


@pytest.mark.parametrize("fp8", [True, False], ids=["fp8", "bf16"])
def test_scatter_to_other_pages_then_gather_is_bitwise(fp8):
    pools = pools_from_numpy(_np_pools(2 if fp8 else 3, fp8), "cpu")
    codec = KVTransferCodec(pools)
    meta = TransferMeta(rid=7, n_pages=3, page_size=4,
                        bytes_per_page=codec.bytes_per_page, pos=12,
                        max_new_tokens=4, temperature=0.0,
                        prompt=tuple(range(12)), generated=(3,))
    src, dst = [2, 5, 1], [6, 3, 7]
    got, payload = codec.unpack(codec.pack(pools, src, meta))
    assert got == meta and len(payload) == codec.bytes_for(3)
    blank = {s: {kv: {k: torch.zeros_like(t) for k, t in p.items()}
                 for kv, p in st.items()} for s, st in pools.items()}
    assert codec.scatter(blank, payload, dst) is blank     # in place
    for s, d in zip(src, dst):
        a = codec._gather(pools, codec._pad_ids([s]))
        b = codec._gather(blank, codec._pad_ids([d]))
        assert torch.equal(a, b), f"page {s} -> {d}"
    other = KVTransferCodec(pools_from_numpy(
        _np_pools(4, fp8, hd=4), "cpu"))
    with pytest.raises(ValueError, match="geometry"):
        other.unpack(codec.pack(pools, src, meta))


def test_pools_from_numpy_refuses_another_layout():
    np_pools = _np_pools(0, True)
    del np_pools["alt"]["v"]
    with pytest.raises(ValueError, match="k and v"):
        pools_from_numpy(np_pools, "cpu")
    np_pools = _np_pools(0, True)
    np_pools["attn"]["k"]["scale"] = np_pools["attn"]["k"]["scale"][..., 0]
    with pytest.raises(ValueError, match="scale"):
        pools_from_numpy(np_pools, "cpu")


# ---------------------------------------------------------------------------
# The structural zero-requantization proof.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fp8", [True, False], ids=["fp8", "bf16"])
def test_codec_is_casting_free(fp8):
    pools = pools_from_numpy(_np_pools(5, fp8), "cpu")
    before = {(s, kv, k): t.clone() for s, st in pools.items()
              for kv, p in st.items() for k, t in p.items()}
    KVTransferCodec(pools).assert_casting_free(pools, n=3)
    for (s, kv, k), t in before.items():     # the check wrote scratch only
        assert torch.equal(pools[s][kv][k].view(torch.uint8),
                           t.view(torch.uint8))


def test_casting_free_rejects_a_quantizer_and_a_dequantizer():
    """Negative controls: a textbook quantize (amax -> scale -> divide ->
    e4m3 cast) and a dequantize (widen -> multiply) fail the check."""
    def quantize(x):
        s = x.abs().amax() / 448.0
        return (x / s).to(torch.float8_e4m3fn)

    def dequantize(q, s):
        return q.to(torch.float32) * s
    x = torch.linspace(-3, 3, 8)
    with pytest.raises(AssertionError, match="casting-free"):
        check_casting_free(quantize, x)
    with pytest.raises(AssertionError, match="casting-free"):
        check_casting_free(dequantize, quantize(x), torch.tensor(2.0))
    assert torch.equal(check_casting_free(torch.cat, [x, x]),
                       torch.cat([x, x]))


# ---------------------------------------------------------------------------
# The router's drain-progress and deadlock guards (tests/test_transfer.py).
# ---------------------------------------------------------------------------
class _ParkedEngine:
    """Ticks never progress, but the engine is not idle until the router's
    drain retires its `work` (parked requests only migration retires)."""
    def __init__(self, work):
        self.work = work
        self.sched = self

    def idle(self):
        return self.work == 0

    def tick(self, now, results):
        return False

    def stats(self):
        return {}


class _MigratingRouter(ReplicaRouter):
    def _drain(self, now, results):
        for e in self.engines:
            if e.work:
                e.work -= 1
                return True
        return False


def test_saturated_fleet_progresses_via_drain():
    engines = [_ParkedEngine(work=1200), _ParkedEngine(work=1200)]
    _MigratingRouter(engines).run([], realtime=False)
    assert all(e.work == 0 for e in engines)


def test_genuinely_stuck_fleet_still_raises():
    with pytest.raises(RuntimeError, match="deadlock"):
        ReplicaRouter([_ParkedEngine(work=1)]).run([], realtime=False)


# ---------------------------------------------------------------------------
# The fleet: 1 prefill + 1 decode == the mixed engine, stats == reference.
# ---------------------------------------------------------------------------
KW = dict(max_batch=3, page_size=4, n_pages=32, max_pages_per_req=8,
          token_budget=128, prefill_buckets=(16,), prefill_chunk=4,
          fp8_kv=True, w8_weights=True, prefix_cache=True, seed=0)


def _prompts(vocab):
    """tests/test_transfer.py::test_disagg_fleet_bitwise_identical_and_
    reshares_pages's shared-prefix trace."""
    rng = np.random.default_rng(5)
    prefix = [int(t) for t in rng.integers(1, vocab, 8)]  # two full pages
    return [prefix + [int(t) for t in rng.integers(1, vocab, k)]
            for k in (3, 4, 2, 1, 5)]


@pytest.fixture(scope="module")
def fleets():
    """One reference DisaggRouter run, and the port's mixed engine and
    fleet on the same params (carried across bit for bit) and trace."""
    jcfg = jget_arch("qwen15_05b").reduced()
    cfg = get_arch("qwen15_05b").reduced()
    jparams = jinit_params(jcfg, jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompts = _prompts(cfg.vocab)
    plan = ParallelPlan(mesh=make_mesh11(), dp_axes=("data",))
    jeng = [JServeEngine(jcfg, jget_recipe("fp8_flow"), plan, jparams,
                         JServeConfig(role=role, **KW))
            for role in ("prefill", "decode")]
    jrouter = JDisaggRouter(jeng[:1], jeng[1:])
    jreqs = [JRequest(prompt=list(p), max_new_tokens=4) for p in prompts]
    jres = jrouter.run(jreqs, realtime=False)

    def reqs():
        return [Request(prompt=list(p), max_new_tokens=4) for p in prompts]
    recipe = get_recipe("fp8_flow")
    single = ServeEngine(cfg, recipe, params, ServeConfig(**KW), device="cpu")
    r1 = reqs()
    res1 = single.run(r1, realtime=False)
    pe, de = (ServeEngine(cfg, recipe, params, ServeConfig(role=role, **KW),
                          device="cpu") for role in ("prefill", "decode"))
    router = DisaggRouter([pe], [de])
    r2 = reqs()
    res2 = router.run(r2, realtime=False)
    return dict(
        ref_stats=jrouter.stats(),
        ref_tokens=[jres[q.rid]["tokens"] for q in jreqs],
        mixed_tokens=[res1[q.rid]["tokens"] for q in r1], single=single,
        cfg=cfg, params=params,
        tokens=[res2[q.rid]["tokens"] for q in r2], stats=router.stats(),
        pe=pe, de=de, reqs=r2)


def test_fleet_serves_the_mixed_engines_tokens_bitwise(fleets):
    """Every request migrates, the receiver dedupes the shared prefix,
    migrated pages are byte-equal on both tiers, no tier leaks a page."""
    f = fleets
    assert f["tokens"] == f["mixed_tokens"]
    d = f["stats"]["disagg"]
    assert d["migrations"] == len(f["reqs"]) and d["deduped_pages"] > 0
    pe, de = f["pe"], f["de"]
    compared = 0
    for q in f["reqs"]:
        for s, t in zip(pe.prefix_cache.match_pages(q.prompt),
                        de.prefix_cache.match_pages(q.prompt)):
            assert torch.equal(pe.codec._gather(pe.pools,
                                                pe.codec._pad_ids([s])),
                               de.codec._gather(de.pools,
                                                de.codec._pad_ids([t])))
            compared += 1
    assert compared > 0
    with pytest.raises(ValueError, match="decode-tier"):
        de.submit(Request(prompt=[1, 2, 3], max_new_tokens=1))
    for eng in (pe, de, f["single"]):
        assert eng.sched.idle()
        assert eng.alloc.live_pages == eng.prefix_cache.n_cached_pages
        eng.prefix_cache.check_invariants(eng.alloc)


def test_fleet_stats_and_first_tokens_equal_the_reference_fleet(fleets):
    f = fleets
    keys = ("migrations", "kv_transfer_bytes", "shipped_pages",
            "deduped_pages", "requeued_evictions", "budget_deferrals",
            "reserve_failures")
    assert {k: f["stats"]["disagg"][k] for k in keys} == \
        {k: f["ref_stats"]["disagg"][k] for k in keys}
    fleet_keys = ("ticks", "admitted", "finished", "prefill_chunks",
                  "decode_tokens", "prefix_hits", "prefix_lookups",
                  "prefix_hit_tokens", "shared_pages", "cache_evictions",
                  "adopted", "migrated_out", "route_counts")
    assert {k: f["stats"][k] for k in fleet_keys} == \
        {k: f["ref_stats"][k] for k in fleet_keys}
    assert [t[0] for t in f["tokens"]] == [t[0] for t in f["ref_tokens"]]


def test_launcher_serves_a_fleet_with_telemetry_on_cpu(tmp_path, capsys):
    """--prefix-cache --disagg --obs-jsonl --obs-prom on the CPU; the
    port's reporter renders the serve and disagg sections of the JSONL."""
    jsonl, prom = tmp_path / "serve.jsonl", tmp_path / "serve.prom"
    launch_serve.main(["--arch", "qwen15_05b", "--reduced", "--device",
                       "cpu", "--requests", "6", "--max-new", "4",
                       "--prefix-cache", "--disagg", "--obs-jsonl",
                       str(jsonl), "--obs-prom", str(prom)])
    out = capsys.readouterr().out
    assert "disagg: migrations=6" in out and "prefix cache: hits=" in out
    recs = report.load_records([str(jsonl)])
    kinds = {r["kind"] for r in recs}
    assert {"serve_tick", "request_done", "migration", "route",
            "router_summary", "disagg_summary", "registry"} <= kinds
    assert "serve_ttft_ms" in prom.read_text()
    assert report.main([str(jsonl)]) == 0
    text = capsys.readouterr().out
    assert "== serve:" in text and "== disaggregation: 6 KV migrations" \
        in text


def test_reporter_prints_the_engines_role():
    """The engine's serve_summary carries its role (a string), which the
    reference's reporter cannot print; the port's prints it."""
    lines = []
    report.render([{"t": 0.0, "kind": "serve_summary", "ticks": 3,
                    "role": "mixed"}], out=lines.append)
    assert any("role=mixed" in line and "ticks=3" in line for line in lines)


def test_fleet_defers_migrations_past_the_transfer_budget(fleets):
    """A budget of one page keeps at most one migration a drain cycle;
    the tokens stay the mixed engine's.  The decode tier's token budget
    is cut so that one finish makes room for two migrations at once."""
    prompts = [q.prompt for q in fleets["reqs"]]
    cfg, params = fleets["cfg"], fleets["params"]
    recipe = get_recipe("fp8_flow")
    pe = ServeEngine(cfg, recipe, params, ServeConfig(role="prefill", **KW),
                     device="cpu")
    de = ServeEngine(cfg, recipe, params, ServeConfig(
        role="decode", **{**KW, "token_budget": 24}), device="cpu")
    router = DisaggRouter([pe], [de], dcfg=DisaggConfig(
        transfer_budget_bytes=pe.codec.bytes_for(1)))
    reqs = [Request(prompt=list(p), max_new_tokens=4) for p in prompts]
    res = router.run(reqs, realtime=False)
    assert [res[q.rid]["tokens"] for q in reqs] == fleets["mixed_tokens"]
    assert router.stats()["disagg"]["budget_deferrals"] > 0
