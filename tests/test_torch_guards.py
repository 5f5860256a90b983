"""The numerics guardrails (``train/guards.py``) and the quant-stats
collector (``core/quant.py``) against the reference on the CPU.

``evaluate`` gives the reference's flags bit for bit and its grad-norm EMA
to f32 rounding (rtol 1e-6: XLA may contract the EMA's multiply-add) over
scripted loss / norm / stats sequences; ``GuardPolicy`` the reference's
event list for the same flag stream; the stats matrix of both entry sites
the reference's exactly on the same inputs.  A skipped step leaves every
parameter and state byte as it was (the update kernel's twin writes
nothing); arming the guard changes neither the cast ledger nor the
losses."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.train import guards as jguards
from repro_torch.configs import get_arch
from repro_torch.core import casts
from repro_torch.core import quant
from repro_torch.core.recipes import get_recipe
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.dist.opt_state import StatePolicy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import fault_injection as fi
from repro_torch.train import guards
from repro_torch.train.loop import run as run_loop
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.weights import tensor_from_numpy

NAN, INF = float("nan"), float("inf")
# (loss, gnorm, sat_frac, flush_frac) a step
SCRIPTS = {
    "healthy_then_faults": [(2.0, 1.0, 0, 0)] * 3 + [
        (NAN, INF, 0, 0), (2.0, 10.0, 0, 0), (2.0, 1.1, 0.2, 0.9),
        (INF, 0.9, 0, 0), (1.9, NAN, 0, 0), (1.8, 0.95, 0.01, 0.4)],
    "warmup_then_spikes": [(3.0 - 0.1 * i, 1.0 + 0.05 * i, 0, 0.01 * i)
                           for i in range(12)] + [
        (1.5, 8.0, 0, 0), (1.5, 4.3, 0, 0), (1.5, 4.7, 0, 0.6),
        (1.4, 0.1, 0.06, 0)],
    "ragged": [(float(x), float(g), float(s), float(f)) for x, g, s, f in
               np.random.default_rng(3).uniform(0, 6, size=(30, 4))
               * [1, 1, 0.02, 0.2]],
}


@pytest.mark.parametrize("script", list(SCRIPTS))
@pytest.mark.parametrize("warmup", [2, 10])
def test_evaluate_matches_the_reference(script, warmup):
    plan = guards.GuardPlan(spike_warmup=warmup)
    jplan = jguards.GuardPlan(spike_warmup=warmup)
    g, jg = guards.init_guard_state(), jguards.init_guard_state()
    for loss, gnorm, sat, flush in SCRIPTS[script]:
        f32 = np.float32
        jflags, jg, jm = jguards.evaluate(
            jplan, jg, loss=jnp.float32(loss), gnorm=jnp.float32(gnorm),
            sat_frac=jnp.float32(sat), flush_frac=jnp.float32(flush))
        flags, g, gm = guards.evaluate(
            plan, g, loss=torch.tensor(f32(loss)),
            gnorm=torch.tensor(f32(gnorm)), sat_frac=torch.tensor(f32(sat)),
            flush_frac=torch.tensor(f32(flush)))
        assert flags.dtype == torch.int32
        assert int(flags) == int(jflags) == int(gm["guard_flags"])
        assert int(g["steps"]) == int(jg["steps"])
        np.testing.assert_allclose(float(g["gnorm_ema"]),
                                   float(jg["gnorm_ema"]), rtol=1e-6)


def test_wire_bit_and_flag_names():
    g = guards.init_guard_state()
    flags, _, _ = guards.evaluate(guards.GuardPlan(), g, loss=1.0, gnorm=1.0,
                                  wire_bad=torch.tensor(True))
    assert int(flags) == guards.WIRE_SCALE
    for f in (0, 1, 6, 63):
        assert guards.flag_names(f) == jguards.flag_names(f)
    assert guards.HARD_FLAGS == jguards.HARD_FLAGS


FLAG_STREAMS = {
    "ladder": [0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 8, 0, 3, 0],
    "soft_and_hard": [8, 16, 0, 4, 4, 0, 32, 1, 0, 0],
    "give_up": [1] * 30,
}


@pytest.mark.parametrize("stream", list(FLAG_STREAMS))
@pytest.mark.parametrize("rollback_ok", [True, False])
def test_policy_events_match_the_reference(stream, rollback_ok):
    kw = dict(rollback_after=2, demote_after=4, demote_steps=5,
              give_up_after=12)
    pol, jpol = guards.GuardPolicy(**kw), jguards.GuardPolicy(**kw)
    quiet = lambda *a: None  # noqa: E731
    for step, flags in enumerate(FLAG_STREAMS[stream]):
        try:
            jv = jpol.observe(step, flags, quiet, can_rollback=rollback_ok)
        except jguards.GuardGiveUp:
            with pytest.raises(guards.GuardGiveUp):
                pol.observe(step, flags, quiet, can_rollback=rollback_ok)
            break
        v = pol.observe(step, flags, quiet, can_rollback=rollback_ok)
        assert (v.skip, v.rollback, v.demote) == \
            (jv.skip, jv.rollback, jv.demote)
        assert pol.demoted(step + 1) == jpol.demoted(step + 1)
    assert pol.events == jpol.events
    assert pol.events


# ---------------------------------------------------------------------------
# The quant-stats matrix of the two entry sites.
# ---------------------------------------------------------------------------
def _entry_input(seed):
    """Rows over a wide range: some tiny values flush to zero under their
    row's scale, one row is all zero."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(2, 24, 256)) * np.exp(r.normal(size=(2, 24, 256))
                                               * 3.0)
    x[0, 3] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("site", ["q_entry_mlp", "q_entry_moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_entry_stats_match_the_reference(site, dtype):
    xn = _entry_input(site == "q_entry_moe").astype(
        {"float32": np.float32, "bfloat16": jnp.bfloat16}[dtype])
    xj = jnp.asarray(xn)
    xt = tensor_from_numpy(np.asarray(xn), device="cpu")
    if site == "q_entry_moe":
        xj, xt = xj.reshape(-1, 256), xt.reshape(-1, 256)
    with jquant.collect_stats():
        q = jquant.quantize_rowwise(xj) if site == "q_entry_mlp" else None
        jquant.record_entry_stats(site, xj, q)
        jsv = np.asarray(jquant.drain_stats())
    with quant.collect_stats():
        assert quant.stats_armed()
        q = quant.quantize_rowwise(xt) if site == "q_entry_mlp" else None
        quant.record_entry_stats(site, xt, q)
        sv = quant.drain_stats()
    assert not quant.stats_armed()
    assert sv.shape == (quant.N_SITES, quant.STATS_LEN)
    assert np.array_equal(sv.numpy(), jsv)
    assert sv.numpy()[quant.STAT_SITES.index(site), 1] > 0    # flushes
    assert np.array_equal(quant.site_maxima(sv).numpy(),
                          np.asarray(jquant.site_maxima(jsv)))
    assert quant.STAT_SITES == jquant.STAT_SITES


def test_stats_record_nothing_unarmed():
    x = torch.randn(8, 256)
    quant.record_entry_stats("q_entry_moe", x)
    with quant.collect_stats():
        assert torch.equal(quant.drain_stats(), quant.zero_stats())


# ---------------------------------------------------------------------------
# The guarded train step: skip leaves every byte; the guard is free.
# ---------------------------------------------------------------------------
def _build(guard=None, policy=None, recipe="fp8_flow"):
    cfg = get_arch("qwen15_05b").reduced()
    opt = AdamWConfig(lr=3e-3, state_policy=policy)
    state = init_train_state(cfg, opt, seed=0, device="cpu", guard=guard)
    step = make_train_step(cfg, get_recipe(recipe), opt, total_steps=200,
                           warmup_steps=5, guard=guard)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    return state, step, data


def _tree_bytes(tree):
    from repro_torch.checkpoint.checkpointing import _flatten, _to_host
    return [(p, _to_host(x)[0].tobytes()) for p, x in _flatten(tree)]


@pytest.mark.parametrize("policy", [None, StatePolicy(min_size=4096)])
def test_skipped_step_leaves_every_byte(policy):
    guard = guards.GuardPlan()
    state, step, data = _build(guard, policy)
    state, m = step(state, make_batch(data, 0, device="cpu"))
    assert int(m["guard_flags"]) == 0
    before = _tree_bytes(state)
    with fi.activate(fi.Fault("nan_activation", 1, "q_entry")):
        state, m = step(state, make_batch(data, 1, device="cpu"))
    assert int(m["guard_flags"]) & (guards.NONFINITE_LOSS
                                    | guards.NONFINITE_GRAD)
    # every byte but the host step counter, which the loop winds back
    # (the guard's EMA and healthy-step count did not move either)
    after = _tree_bytes(state)
    assert len(after) == len(before)
    assert [pb for pb in after if pb[0] != "/opt/step"] == \
        [pb for pb in before if pb[0] != "/opt/step"]
    # through the loop: the step counter wound back, the guard state kept
    state, step, data = _build(guard, policy)
    plan = fi.FaultPlan((fi.Fault("nan_activation", 1, "q_entry"),))
    snaps = []

    def spy(st, batch):
        snaps.append(_tree_bytes(st))
        return step(st, batch)

    pol = guards.GuardPolicy()
    state, hist = run_loop(plan.wrap(spy), state, data, n_steps=3,
                           guard_policy=pol, fault_plan=plan,
                           log_fn=lambda *a: None)
    assert [e["event"] for e in pol.events] == ["skip", "recovered"]
    assert snaps[2] == snaps[1]               # step 1 changed no byte
    assert state["opt"]["step"] == 2
    assert not np.isfinite(hist[1]["loss"]) and np.isfinite(hist[2]["loss"])


SOFT_SKIP = guards.HARD_FLAGS | guards.FP8_SAT


@pytest.mark.parametrize("widen", ["both", "neither", "plan", "policy"])
def test_widened_skip_set_agrees_on_host_and_device(widen):
    """A saturation bar that every step crosses (FP8_SAT each step).  Where
    the plan and the policy both skip on it, the device writes nothing and
    the host winds the step back, every step; where neither does, both
    keep the update; a mask widened on one side only is refused."""
    plan = guards.GuardPlan(sat_frac_limit=-1.0, skip_flags=(
        SOFT_SKIP if widen in ("both", "plan") else guards.HARD_FLAGS))
    pol = guards.GuardPolicy(give_up_after=100, skip_flags=(
        SOFT_SKIP if widen in ("both", "policy") else guards.HARD_FLAGS))
    state, step, data = _build(plan)
    stepper = fi.FaultPlan(()).wrap(step)
    quiet = lambda *a: None  # noqa: E731
    if widen in ("plan", "policy"):
        with pytest.raises(ValueError, match="skip_flags"):
            run_loop(stepper, state, data, n_steps=1, guard_policy=pol,
                     log_fn=quiet)
        return
    before, params_before = _tree_bytes(state), _tree_bytes(state["params"])
    state, hist = run_loop(stepper, state, data, n_steps=2,
                           guard_policy=pol, log_fn=quiet)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert [e["flags"] for e in pol.events] == [guards.FP8_SAT] * 2
    if widen == "both":
        assert [e["event"] for e in pol.events] == ["skip", "skip"]
        assert state["opt"]["step"] == 0
        assert _tree_bytes(state) == before
    else:
        assert [e["event"] for e in pol.events] == ["soft_anomaly"] * 2
        assert state["opt"]["step"] == 2
        assert _tree_bytes(state["params"]) != params_before


def test_guard_leaves_cast_ledger_and_losses_unchanged():
    runs = []
    for guard in (None, guards.GuardPlan()):
        state, step, data = _build(guard)
        losses, ledgers = [], []
        for i in range(3):
            with casts.ledger() as led:
                state, m = step(state, make_batch(data, i, device="cpu"))
            losses.append(float(m["loss"]))
            ledgers.append(sorted(led.by_tag().items()))
        runs.append((losses, ledgers, m))
    assert runs[0][0] == runs[1][0]
    assert runs[0][1] == runs[1][1]
    assert "guard_flags" not in runs[0][2]
    assert "quant_site_stats" in runs[1][2]
    assert runs[1][2]["quant_site_stats"].shape == (quant.N_SITES, 2)
