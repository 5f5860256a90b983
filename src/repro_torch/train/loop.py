"""The training loop: checkpoint and restart, health monitoring, elastic
rewind, async checkpoints and the numerics-guardrail recovery ladder,
the control plane around the train step.

Counterpart of ``repro.train.loop``, with the same arguments and events.
What differs comes from PyTorch's in-place updates:

- **One host fetch a step.**  The step's metrics (loss, grad norm, the
  guard bits, the per-site FP8 stats) are stacked into one f32 tensor on
  the device and copied to the host once.  ``device_ms`` is the step's
  call to the end of the device's work (a synchronize on the card),
  ``fetch_ms`` that one copy.
- **Skip-step.**  The reference drops the update by keeping the previous
  state, still a live reference.  The port's update kernel has already
  skipped the write on the device (``guard_flags & GuardPlan.skip_flags``),
  so the loop only winds back the optimizer's host step counter and
  restores the guard state; every parameter and state byte is already as
  it was.  The two masks must agree, so ``run`` refuses a step whose
  GuardPlan's ``skip_flags`` differ from its GuardPolicy's.
- **Rollback and restart** copy a checkpoint into the live tensors in
  place (``checkpointing.restore``), and an async save copies the state
  to host memory before the next step overwrites it.
- **The cast-ledger snapshot** of a step callable is taken on its first
  real call (the reference traces it abstractly with ``jax.eval_shape``).

- **Checkpoints on a mesh.**  A step on a mesh carries its state's
  shardings (``train_step.shardings``): a DistPlan step's replicas hold
  their own rows of the flat optimizer state
  (``dist.opt_state.Zero1Shardings``), a plain step's ranks their own
  experts (``launch.sharding.MeshShardings``).  A save gathers the full
  logical state (every rank joins the gather) and one rank writes it; a
  restore reads the full state into a full-size template and copies this
  rank's part out.  ``restore_shardings`` names the layout to cut for,
  the step's own by default: a ZeRO-1 checkpoint saved at one DP size
  restores at another that divides ``DistPlan.shard_multiple``, and a
  plain one at another EP size, bit for bit.  Every rank waits at a
  barrier for a write to land before it looks for a checkpoint.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import checkpointing
from repro_torch.core import casts
from repro_torch.core import quant as quant_stats
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.obs.sink import null_telemetry
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import fault_injection
from repro_torch.runtime.fault_tolerance import ElasticTrainer


def _restore_latest_valid(ckpt_dir, state, log_fn, tel=None,
                          shardings=None):
    """The newest complete checkpoint that passes the integrity checks,
    copied into `state` (through the `shardings`' full-size template for
    a state sharded over a mesh); a corrupt step (CheckpointCorruptError)
    is logged and skipped, so one poisoned shard cannot wedge the
    rollback path.  Returns (state, step) or None."""
    for s in reversed(checkpointing.completed_steps(ckpt_dir)):
        try:
            if shardings is None:
                st, _ = checkpointing.restore(ckpt_dir, state, step=s)
            else:
                full, _ = checkpointing.restore(
                    ckpt_dir, shardings.template(state), step=s)
                st = shardings.shard(full, state)
            return st, s
        except checkpointing.CheckpointCorruptError as e:
            msg = (f"[loop] checkpoint step_{s} failed integrity check "
                   f"({e}); falling back to an older step")
            if tel is not None:
                tel.record("ckpt_corrupt", ckpt_step=s, error=str(e),
                           msg=msg)
                tel.counter("ckpt_corrupt_total").inc()
            log_fn(msg)
    return None


def _ledger_record(tel, fn, led, step, demoted):
    tel.record(
        "cast_ledger", step=step, demoted=bool(demoted),
        fn=getattr(fn, "__name__", type(fn).__name__),
        activation_casts=led.activation_casts(),
        fused_casts=led.fused_casts(), total=led.total(),
        by_tag={f"{k}:{t}": n for (k, t), n in sorted(led.by_tag().items())})


def fetch_metrics(metrics) -> dict:
    """The step's tensor metrics copied to the host in ONE transfer: every
    tensor flattened into one f32 vector on its device, then .cpu().
    Scalars come back as floats, others as nested lists; non-tensors pass
    through."""
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    out = {k: v for k, v in metrics.items() if not torch.is_tensor(v)}
    if not keys:
        return out
    flat = torch.cat([metrics[k].detach().reshape(-1).to(torch.float32)
                      for k in keys]).cpu()
    i = 0
    for k in keys:
        t = metrics[k]
        n = t.numel()
        v = flat[i:i + n].reshape(t.shape)
        out[k] = float(v) if t.dim() == 0 else v.tolist()
        i += n
    return out


def save_state(ckpt_dir, step, state, shardings=None, async_=False):
    """checkpointing.save of the state, or on a mesh of its gathered full
    state by the shardings' writer (the other ranks join the gather and
    write nothing: None)."""
    if shardings is None:
        return checkpointing.save(ckpt_dir, step, state, async_=async_)
    full = shardings.full(state)
    if not shardings.writer:
        return None
    return checkpointing.save(ckpt_dir, step, full, async_=async_)


def _sync(state) -> None:
    leaves = tree_leaves(state["params"])
    if leaves and leaves[0].is_cuda:
        torch.cuda.synchronize(leaves[0].device)


def run(train_step: Callable, state, data_cfg: DataConfig, *,
        n_steps: int, ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
        log_every: int = 10, elastic: Optional[ElasticTrainer] = None,
        grad_accum: int = 1, fail_injector: Optional[Callable] = None,
        restore_shardings=None, log_fn=print, guard_policy=None,
        fallback_step: Optional[Callable] = None,
        fault_plan: Optional[fault_injection.FaultPlan] = None,
        telemetry=None, batch_fn: Optional[Callable] = None):
    """Runs `n_steps`, restarting from the latest checkpoint if present.
    `fail_injector(step, elastic)` lets tests simulate host failures and
    stragglers.  Batches are ``make_batch(data_cfg, step)`` on the device
    of the state's parameters.

    guard_policy (``train.guards.GuardPolicy``) drives the recovery ladder
    off the 'guard_flags' metric of a guarded train step: skip-step,
    rollback to the last valid checkpoint after K consecutive strikes
    (rewinding `step` so the data pipeline replays those batches), and
    demotion to `fallback_step` (a bf16-recipe step built with the same
    GuardPlan) for a bounded window before re-promoting.  The steps must
    carry a GuardPlan (``train_step.guard``) whose ``skip_flags`` equal
    ``guard_policy.skip_flags``; a ValueError otherwise.

    fault_plan (``runtime.fault_injection.FaultPlan``) schedules faults:
    numeric ones armed around the step's call when `train_step` is a
    FaultStepper (``fault_plan.wrap(raw_step)``), host failures flip the
    HealthMonitor, and disk faults corrupt checkpoint shards.

    telemetry (``obs.sink.Telemetry``) collects typed events, per-step
    metric samples (from the one fetch a step), host spans and cast-ledger
    snapshots.  None -> a null handle: the same behaviour, nothing kept.

    restore_shardings (``dist.opt_state.Zero1Shardings`` or
    ``launch.sharding.MeshShardings``) cuts a restored checkpoint for a
    layout; the step's own (``train_step.shardings``) by default.
    batch_fn maps each global batch to what the step takes
    (``launch.sharding.shard_batch`` on a mesh).  Returns (state,
    history)."""
    shardings = restore_shardings if restore_shardings is not None \
        else getattr(train_step, "shardings", None)
    if guard_policy is not None:
        for fn in (train_step, fallback_step):
            plan = getattr(fn, "guard", None)
            if plan is not None and plan.skip_flags != guard_policy.skip_flags:
                raise ValueError(
                    f"the step's GuardPlan.skip_flags ({plan.skip_flags}) "
                    f"differ from GuardPolicy.skip_flags "
                    f"({guard_policy.skip_flags}): the device would drop "
                    f"other updates than the host winds back")
    tel = telemetry if telemetry is not None else null_telemetry()
    device = tree_leaves(state["params"])[0].device

    def _event(kind, msg, **fields):
        # typed record + the same human line as the reference's
        tel.record(kind, msg=msg, **fields)
        log_fn(msg)

    start = 0
    if ckpt_dir is not None and checkpointing.latest_step(ckpt_dir) is not None:
        res = _restore_latest_valid(ckpt_dir, state, log_fn, tel,
                                    shardings)
        if res is not None:
            state, rstep = res
            start = rstep + 1
            _event("ckpt_restore", f"[loop] restored checkpoint step={rstep}",
                   ckpt_step=rstep)

    if guard_policy is not None and getattr(guard_policy, "telemetry",
                                            None) is None:
        guard_policy.telemetry = tel

    history = []
    pending_save = None
    ledgered = set()        # id() of step callables already snapshot

    def _join_pending():
        nonlocal pending_save
        if pending_save is not None:
            pending_save.join()     # re-raises a failed background write
            pending_save = None
        if shardings is not None:   # the writer's save has landed
            shardings.barrier()

    step = start
    while step < n_steps:
        t0 = time.monotonic()
        if fault_plan is not None and ckpt_dir is not None:
            disk = fault_plan.disk_for(step)
            if disk is not None:
                _join_pending()
                poisoned = fault_injection.apply_disk_fault(disk, ckpt_dir)
                _event("disk_fault",
                       f"[loop] injected {disk.kind} at step {step} "
                       f"(checkpoint step_{poisoned})",
                       step=step, fault=disk.kind, ckpt_step=poisoned)
        batch = make_batch(data_cfg, step, device=device)
        if batch_fn is not None:        # e.g. this rank's share on a mesh
            batch = batch_fn(batch)
        if grad_accum > 1:
            batch = {k: a.reshape(grad_accum, a.shape[0] // grad_accum,
                                  *a.shape[1:]) for k, a in batch.items()}
        demoted = guard_policy is not None and fallback_step is not None \
            and guard_policy.demoted(step)
        fn = fallback_step if demoted else train_step
        base_fn = fn
        if hasattr(fn, "for_step"):     # FaultStepper: arms the step's fault
            fn = fn.for_step(step)
        snapshot = tel.enabled and id(base_fn) not in ledgered
        prev_opt_step = state["opt"]["step"]
        prev_guard = state.get("guard")
        with tel.span("device_step") as sp_dev:
            if snapshot:
                ledgered.add(id(base_fn))
                with casts.ledger() as led:
                    state, metrics = fn(state, batch)
                _ledger_record(tel, base_fn, led, step, demoted)
            else:
                state, metrics = fn(state, batch)
            _sync(state)
        with tel.span("host_fetch") as sp_fetch:
            host_metrics = fetch_metrics(metrics)
        loss = float(host_metrics["loss"])
        dt = time.monotonic() - t0
        history.append({"step": step, "loss": loss, "dt": dt,
                        "device_ms": sp_dev.ms, "fetch_ms": sp_fetch.ms})

        if tel.enabled:
            values = {"loss": loss}
            for k in ("grad_norm", "quant_sat_frac", "quant_flush_frac",
                      "guard_flags"):
                if k in host_metrics:
                    values[k] = float(host_metrics[k])
            extra = {}
            sv = host_metrics.get("quant_site_stats")
            if sv is not None:
                sites = {}
                for i, name in enumerate(quant_stats.STAT_SITES):
                    sat, flush = float(sv[i][0]), float(sv[i][1])
                    sites[name] = {"sat": sat, "flush": flush}
                    tel.gauge("quant_sat_frac",
                              labels={"site": name}).set(sat)
                    tel.gauge("quant_flush_frac",
                              labels={"site": name}).set(flush)
                extra["quant_sites"] = sites
            if demoted:
                extra["demoted"] = True
            tel.step(step, values,
                     spans={"device": sp_dev.ms, "fetch": sp_fetch.ms,
                            "total": dt * 1e3},
                     extra=extra)

        if guard_policy is not None:
            flags = int(host_metrics.get("guard_flags", 0))
            if flags and shardings is not None:
                # the flags are agreed: every rank looks for a checkpoint
                # after the same landed write
                _join_pending()
            have_ckpt = ckpt_dir is not None and \
                bool(checkpointing.completed_steps(ckpt_dir))
            verdict = guard_policy.observe(step, flags, log_fn,
                                           can_rollback=have_ckpt)
            if verdict.skip:
                # the update wrote nothing on the device; wind back what
                # lives on the host and the replaced guard state
                state["opt"]["step"] = prev_opt_step
                if prev_guard is not None:
                    state["guard"] = prev_guard
                if verdict.rollback and have_ckpt:
                    _join_pending()
                    res = _restore_latest_valid(ckpt_dir, state, log_fn,
                                                tel, shardings)
                    if res is not None:
                        state, rstep = res
                        _event("rollback",
                               f"[loop] rolled back to step {rstep}; "
                               f"replaying from step {rstep + 1}",
                               step=step, ckpt_step=rstep)
                        step = rstep + 1
                        continue
                step += 1
                continue

        if elastic is not None:
            if fault_plan is not None:
                hf = fault_plan.host_for(step)
                if hf is not None:
                    fault_injection.apply_host_fault(hf, elastic)
                    _event("host_fault",
                           f"[loop] injected host_failure "
                           f"host={hf.site or 0} at step {step}",
                           step=step, host=hf.site or 0)
            if fail_injector is not None:
                fail_injector(step, elastic)
            elastic.step_report(0, dt)
            remesh, reassign = elastic.plan_step()
            if remesh:
                _event("remesh",
                       f"[loop] host failure at step {step}: shrinking to "
                       f"{elastic.n_data_shards} data shards; restoring "
                       f"checkpoint and continuing",
                       step=step, n_data_shards=elastic.n_data_shards)
                if ckpt_dir is not None:
                    # join first: an async save still in flight must land
                    # before we look for the newest checkpoint
                    _join_pending()
                if ckpt_dir is not None and \
                        checkpointing.latest_step(ckpt_dir) is not None:
                    res = _restore_latest_valid(ckpt_dir, state, log_fn,
                                                tel, shardings)
                    if res is not None:
                        state, rstep = res
                        # rewind so the optimizer steps between the
                        # checkpoint and the failure are replayed (the data
                        # pipeline is a pure function of step)
                        _event("rewind",
                               f"[loop] rewound to step {rstep + 1} after "
                               f"remesh (was {step + 1})",
                               step=step, resume_step=rstep + 1)
                        step = rstep + 1
                        continue
            elif reassign:
                _event("reassign",
                       f"[loop] stragglers reassigned: {reassign}",
                       step=step, assignments=list(reassign))

        if step % log_every == 0:
            _event("progress",
                   f"[loop] step={step} loss={loss:.4f} "
                   f"gnorm={float(host_metrics.get('grad_norm', 0)):.3f} "
                   f"dt={dt*1e3:.0f}ms",
                   step=step, loss=loss, dt_ms=dt * 1e3)
        if ckpt_dir is not None and step % ckpt_every == 0 and step > 0:
            _join_pending()
            pending_save = save_state(ckpt_dir, step, state, shardings,
                                      async_=True)
            tel.record("ckpt_save", step=step)
            tel.counter("ckpt_saves_total").inc()
        step += 1
    _join_pending()
    tel.flush()
    return state, history
