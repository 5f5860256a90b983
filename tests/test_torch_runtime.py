"""The training runtime on the CPU: checkpoints, restart, elastic rewind,
the fault ladder against the reference's ``loop.run``, gradient
accumulation against the reference's, and ``Recipe(save_h=True)``.

Checkpoints round-trip bit for bit (QTensor payloads and scales too) and
are restored into the live tensors in place; a restart resumes with the
uninterrupted run's losses (the same bits on the CPU).  Under the same
FaultPlan the port's loop gives the reference loop's guard events, step
for step and flag for flag (reduced qwen15_05b, fp8_flow with a bf16
fallback): skip, rollback, demote and re-promote, or skip and give-up.
grad_accum=2 (bf16 recipe, see RECIPE_ACCUM): the loss within rtol 1e-4
and every gradient leaf at cosine >= 0.999 against the reference's (the
bar of the port's other gradient tests), and the f32 sums exactly the
mean of the port's own two microbatch gradients.  save_h=True gives the
same bits as recomputing h."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import functools
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.recipes import get_recipe as jget_recipe
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.models.lm import ParallelPlan
from repro.models.lm import forward as jforward
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.runtime import fault_injection as jfi
from repro.train import guards as jguards
from repro.train.loop import run as jrun_loop
from repro.train.train_step import _local_grads as j_local_grads
from repro.train.train_step import init_train_state as jinit_train_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.checkpoint import checkpointing
from repro_torch.configs import get_arch
from repro_torch.core.quant import QTensor
from repro_torch.core.recipes import get_recipe
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.dist.opt_state import StatePolicy
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.runtime import fault_injection as fi
from repro_torch.runtime.fault_tolerance import ElasticTrainer
from repro_torch.train import guards
from repro_torch.train.loop import run as run_loop
from repro_torch.train.train_step import (_local_grads, init_train_state,
                                          make_train_step)
from repro_torch.weights import params_from_numpy
from tests.conftest import make_mesh11

QUIET = dict(log_every=1000, log_fn=lambda *a: None)


def _build(recipe="fp8_flow", guard=None, policy=None, seed=0, params=None):
    cfg = get_arch("qwen15_05b").reduced()
    opt = AdamWConfig(lr=3e-3, state_policy=policy)
    state = init_train_state(cfg, opt, seed=seed, device="cpu", guard=guard,
                             params=params)
    step = make_train_step(cfg, get_recipe(recipe), opt, total_steps=200,
                           warmup_steps=5, guard=guard)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    return state, step, data


def _snapshot(tree):
    return [(p, checkpointing._to_host(x)[0].tobytes(), x if not
             torch.is_tensor(x) else None)
            for p, x in checkpointing._flatten(tree)]


# ---------------------------------------------------------------------------
# Checkpoints.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", [None, StatePolicy(min_size=4096)])
@pytest.mark.parametrize("async_", [False, True])
def test_checkpoint_round_trip_bitwise(tmp_path, policy, async_):
    state, step, data = _build(guard=guards.GuardPlan(), policy=policy)
    state, _ = step(state, make_batch(data, 0, device="cpu"))
    if policy is not None:
        assert isinstance(state["opt"]["m"]["layers"]["wq"], QTensor)
    want = _snapshot(state)
    h = checkpointing.save(str(tmp_path), 1, state, async_=async_)
    # the next step overwrites the state in place while the writer runs
    state, _ = step(state, make_batch(data, 1, device="cpu"))
    if h is not None:
        h.join()
    assert _snapshot(state) != want
    live = tree_leaves(state["params"])
    restored, s = checkpointing.restore(str(tmp_path), state)
    assert s == 1 and restored["opt"]["step"] == 1
    assert _snapshot(restored) == want
    assert all(a is b for a, b in zip(tree_leaves(restored["params"]), live))


def _tiny():
    return {"a": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": {"c": torch.ones((4, 4), dtype=torch.bfloat16)},
            "q": QTensor(torch.full((2, 128), 0.5).to(torch.float8_e4m3fn),
                         torch.ones((2, 1)), (1, 128)), "n": 7}


def test_checkpoint_complete_marker_and_gc(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        checkpointing.save(d, s, _tiny(), max_keep=2)
    assert checkpointing.completed_steps(d) == [4, 5]
    os.makedirs(os.path.join(d, "step_9"))          # torn: no marker
    assert checkpointing.latest_step(d) == 5
    with pytest.raises(checkpointing.CheckpointCorruptError, match="COMPLETE"):
        checkpointing.restore(d, _tiny(), step=9)
    with pytest.raises(ValueError, match="tree"):
        checkpointing.restore(d, {"a": torch.zeros(8, 8)})


@pytest.mark.parametrize("fault", ["ckpt_corrupt", "ckpt_truncate"])
def test_checkpoint_detects_a_damaged_shard(tmp_path, fault):
    d = str(tmp_path)
    checkpointing.save(d, 3, _tiny())
    assert fi.apply_disk_fault(fi.Fault(fault, 0), d) == 3
    match = "fingerprint" if fault == "ckpt_corrupt" else "unreadable"
    tree = _tiny()
    tree["a"].zero_()
    with pytest.raises(checkpointing.CheckpointCorruptError, match=match):
        checkpointing.restore(d, tree)
    assert float(tree["a"].sum()) == 0.0     # nothing copied in


def test_async_save_failure_reraises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    h = checkpointing.save(str(blocker), 1, _tiny(), async_=True)
    with pytest.raises(OSError):
        h.join()


# ---------------------------------------------------------------------------
# Restart, elastic rewind.
# ---------------------------------------------------------------------------
def test_restart_resumes_with_the_uninterrupted_losses(tmp_path):
    d1, d2 = str(tmp_path / "run"), str(tmp_path / "crashed")
    state, step, data = _build(policy=StatePolicy(min_size=4096))
    _, full = run_loop(step, state, data, n_steps=6, ckpt_dir=d1,
                       ckpt_every=2, **QUIET)
    assert checkpointing.completed_steps(d1) == [2, 4]
    # a run that crashed during step 3: its directory holds step 2 only
    os.makedirs(d2)
    shutil.copytree(os.path.join(d1, "step_2"), os.path.join(d2, "step_2"))
    state, step, data = _build(policy=StatePolicy(min_size=4096), seed=1)
    msgs = []
    _, hist = run_loop(step, state, data, n_steps=6, ckpt_dir=d2,
                       ckpt_every=2, log_fn=msgs.append, log_every=1000)
    assert "[loop] restored checkpoint step=2" in msgs
    assert [h["step"] for h in hist] == [3, 4, 5]
    assert [h["loss"] for h in hist] == [h["loss"] for h in full[3:]]


def test_disk_fault_restart_rolls_past_corrupt(tmp_path):
    d = str(tmp_path)
    state, step, data = _build()
    plan = fi.FaultPlan((fi.Fault("ckpt_corrupt", 5),))
    run_loop(step, state, data, n_steps=6, ckpt_dir=d, ckpt_every=2,
             fault_plan=plan, **QUIET)
    msgs = []
    state, step, data = _build(seed=1)
    _, hist = run_loop(step, state, data, n_steps=7, ckpt_dir=d,
                       ckpt_every=100, log_every=1000, log_fn=msgs.append)
    assert any("step_4 failed integrity check" in m for m in msgs)
    assert hist[0]["step"] == 3


def test_host_failure_rewinds_to_the_checkpoint(tmp_path):
    state, step, data = _build()
    elastic = ElasticTrainer(n_data_shards=4, timeout=3600.0)
    plan = fi.FaultPlan((fi.Fault("host_failure", 4, "2"),))

    def beats(step, el):
        for h in list(el.monitor.hosts):
            el.monitor.beat(h, 0.1)

    _, hist = run_loop(step, state, data, n_steps=7, ckpt_dir=str(tmp_path),
                       ckpt_every=2, elastic=elastic, fail_injector=beats,
                       fault_plan=plan, **QUIET)
    assert elastic.generation == 1 and elastic.n_data_shards == 3
    steps = [h["step"] for h in hist]
    assert steps.count(3) == 2 and steps.count(4) == 2
    assert sorted(set(steps)) == list(range(7))
    assert np.isfinite(hist[-1]["loss"])


# ---------------------------------------------------------------------------
# The fault ladder: the reference loop's events under the same FaultPlan.
# ---------------------------------------------------------------------------
# nan_activation at steps 4 and 5: a skip, a rollback to step 3's
# checkpoint, the replayed fault a demotion (or, with no checkpoint and a
# budget of two, a give-up); both ladders share the reference's four
# compiled steps (clean, each fault, the bf16 fallback)
FAULTS = tuple(("nan_activation", s, "q_entry") for s in (4, 5))


@functools.cache
def _reference_steps():
    """The reference's jitted reduced qwen15_05b fp8_flow step behind one
    FaultStepper (its per-fault jit cache kept across ladders), its bf16
    fallback and the initial state (tests/test_guards.py's setup)."""
    jcfg = jget_arch("qwen15_05b").reduced()
    mesh = make_mesh11()
    plan = ParallelPlan(mesh=mesh, dp_axes=("data",))
    jopt = JAdamWConfig(lr=3e-3)
    guard = jguards.GuardPlan()
    raw = jmake_train_step(jcfg, jget_recipe("fp8_flow"), plan, jopt,
                           total_steps=200, warmup_steps=5, guard=guard)
    raw_bf16 = jmake_train_step(jcfg, jget_recipe("bf16"), plan, jopt,
                                total_steps=200, warmup_steps=5, guard=guard)
    state = jinit_train_state(jcfg, jopt, jax.random.key(0), guard=guard)
    fplan = jfi.FaultPlan(tuple(jfi.Fault(*f) for f in FAULTS))
    data = JDataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=2)
    return mesh, fplan, fplan.wrap(raw), jax.jit(raw_bf16), state, data


def _reference_events(n_steps, policy_kw, ckpt_dir=None, ckpt_every=3):
    mesh, fplan, stepper, fallback, state, data = _reference_steps()
    pol = jguards.GuardPolicy(**policy_kw)
    raised = False
    with mesh:
        try:
            jrun_loop(stepper, state, data, n_steps=n_steps,
                      ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                      guard_policy=pol, fault_plan=fplan,
                      fallback_step=fallback, **QUIET)
        except jguards.GuardGiveUp:
            raised = True
    return pol.events, raised, jax.tree.map(np.asarray, state["params"])


def _port_events(n_steps, policy_kw, params_np, ckpt_dir=None,
                 ckpt_every=3):
    guard = guards.GuardPlan()
    state, step, data = _build(guard=guard,
                               params=params_from_numpy(params_np, "cpu"))
    _, fallback, _ = _build("bf16", guard=guard)
    fplan = fi.FaultPlan(tuple(fi.Fault(*f) for f in FAULTS))
    pol = guards.GuardPolicy(**policy_kw)
    raised = False
    try:
        run_loop(fplan.wrap(step), state, data, n_steps=n_steps,
                 ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, guard_policy=pol,
                 fault_plan=fplan, fallback_step=fallback, **QUIET)
    except guards.GuardGiveUp:
        raised = True
    return pol.events, raised


LADDERS = {
    # skip, rollback (replaying into the fault), demote, re-promote
    "ladder": (10, dict(rollback_after=2, demote_after=3, demote_steps=3,
                        give_up_after=50), True),
    # no checkpoint: skips exhaust the budget
    "give_up": (10, dict(give_up_after=2), False),
}


@pytest.mark.parametrize("ladder", list(LADDERS))
def test_fault_ladder_gives_the_reference_loops_events(tmp_path, ladder):
    n, kw, ckpt = LADDERS[ladder]
    jd = str(tmp_path / "ref") if ckpt else None
    pd = str(tmp_path / "port") if ckpt else None
    ref, ref_raised, params_np = _reference_events(n, kw, jd)
    got, raised = _port_events(n, kw, params_np, pd)
    assert raised == ref_raised == (ladder == "give_up")
    assert [(e["step"], e["event"], e["flags"]) for e in got] == \
        [(e["step"], e["event"], e["flags"]) for e in ref]
    names = [e["event"] for e in got]
    if ladder == "ladder":
        assert names.index("skip") < names.index("rollback") < \
            names.index("demote") < names.index("repromote")
    else:
        assert names == ["skip", "give_up"]


def test_wire_faults_raise():
    """The wire faults arm now (they raised before the FP8 DP wire was
    ported): under payload_bitflip the wire's quantize writes 0x7f (e4m3's
    NaN) into its payload's first byte, under wire_scale the exponent 127,
    as the reference's hook does; with nothing armed the bucket is clean.
    tests/test_torch_dist_train.py shows the guard catching both."""
    from repro_torch.dist import grad_comm
    g = torch.linspace(-1.0, 1.0, 4 * 128).reshape(4, 128)
    clean_pay, clean_exp = grad_comm.quantize_bucket(g, None)
    with fi.activate(fi.Fault("payload_bitflip", 0)):
        pay, exp = grad_comm.quantize_bucket(g, None)
    assert int(pay.view(torch.uint8).reshape(-1)[0]) == 0x7F
    assert torch.equal(pay.view(torch.uint8).reshape(-1)[1:],
                       clean_pay.view(torch.uint8).reshape(-1)[1:])
    assert torch.equal(exp, clean_exp)
    with fi.activate(fi.Fault("wire_scale", 0)):
        pay, exp = grad_comm.quantize_bucket(g, None)
    assert int(exp.reshape(-1)[0]) == 127
    assert torch.equal(pay.view(torch.uint8), clean_pay.view(torch.uint8))
    assert int(clean_pay.view(torch.uint8).reshape(-1)[0]) != 0x7F


# ---------------------------------------------------------------------------
# Gradient accumulation and save_h.
# ---------------------------------------------------------------------------
def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


# the gradient comparison runs the bf16 recipe: whole-model FP8 gradients
# sit at the 0.999 bar against the reference's XLA route before any
# accumulation (ln2_s at 0.99892 in fp8_flow here), and the accumulation
# is the same code for every recipe
RECIPE_ACCUM = "bf16"


def test_grad_accum_matches_the_reference():
    jcfg = jget_arch("qwen3_moe_235b").reduced()
    mesh = make_mesh11()
    plan = ParallelPlan(mesh=mesh, dp_axes=("data",))
    jstate = jinit_train_state(jcfg, JAdamWConfig(), jax.random.key(0))
    params_np = jax.tree.map(np.asarray, jstate["params"])
    jb = jmake_batch(JDataConfig(vocab=jcfg.vocab, seq_len=64,
                                 global_batch=8), 0)
    jb = jax.tree.map(lambda a: a.reshape(2, 4, *a.shape[1:]), jb)
    recipe = jget_recipe(RECIPE_ACCUM)

    def loss_fn(p, mb):
        return jforward(jcfg, recipe, plan, p, mb)

    with mesh:
        jloss, _, jgrads = jax.jit(
            lambda p, b: j_local_grads(loss_fn, p, b, 2))(jstate["params"],
                                                           jb)
    cfg = get_arch("qwen3_moe_235b").reduced()
    params = params_from_numpy(params_np, "cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8), 0, device="cpu")
    batch = {k: v.reshape(2, 4, *v.shape[1:]) for k, v in batch.items()}
    loss, metrics, grads = _local_grads(cfg, get_recipe(RECIPE_ACCUM),
                                        params, batch, 2, False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert metrics["aux_loss"].shape == ()
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for path, jg in jflat:
        g = grads
        for k in path:
            g = g[k.key]
        assert g.dtype == torch.float32
        assert _cos(g.numpy(), np.asarray(jg, np.float32)) >= 0.999, path
    # the f32 sums are the mean of the two microbatches' own gradients
    gs = [tree_leaves(_local_grads(cfg, get_recipe(RECIPE_ACCUM), params,
                                   {k: v[m] for k, v in batch.items()}, 1,
                                   False)[2]) for m in range(2)]
    for a, b, g in zip(*gs, tree_leaves(grads)):
        assert torch.equal((a.to(torch.float32) + b.to(torch.float32)) / 2,
                           g)


def test_grad_accum_step_through_the_loop():
    cfg = get_arch("qwen15_05b").reduced()
    opt = AdamWConfig(lr=3e-3)
    state = init_train_state(cfg, opt, seed=0, device="cpu")
    step = make_train_step(cfg, get_recipe("fp8_flow"), opt, grad_accum=2,
                           total_steps=200, warmup_steps=5)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    _, hist = run_loop(step, state, data, n_steps=2, grad_accum=2, **QUIET)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("masked", [False, True])
def test_save_h_gives_the_same_bits(masked):
    kw = dict(masked_experts=True, swiglu_epilogue=True) if masked else {}
    cfg = get_arch("qwen3_moe_235b").reduced()
    runs = []
    for save_h in (False, True):
        opt = AdamWConfig(lr=3e-3)
        state = init_train_state(cfg, opt, seed=0, device="cpu")
        step = make_train_step(cfg, get_recipe("fp8_flow", save_h=save_h,
                                               **kw), opt,
                               total_steps=200, warmup_steps=5)
        data = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
        losses = []
        for i in range(2):
            state, m = step(state, make_batch(data, i, device="cpu"))
            losses.append(float(m["loss"]))
        runs.append((losses, _snapshot(state)))
    assert runs[0] == runs[1]
