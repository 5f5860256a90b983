"""Numerics guardrails: in-step FP8 anomaly detection and the recovery
ladder.

Counterpart of ``repro.train.guards``.  Two halves:

  on the device  ``evaluate`` runs inside the train step, after the global
                 norm and before the update, and folds the step's health
                 into an int32 anomaly bitmask and a tiny carried state
                 (the grad-norm EMA).  The update kernel reads the bitmask
                 and writes nothing where it meets ``GuardPlan.skip_flags``,
                 so skipping needs no host sync and no copy of the state;
                 the bits ride out in the metrics the loop already fetches
                 once a step.
  on the host    ``GuardPolicy.observe`` (a copy of the reference's) turns
                 the fetched bitmask into the recovery ladder: skip-step,
                 then rollback to the last complete checkpoint after
                 `rollback_after` consecutive strikes, then demotion to the
                 bf16 recipe for `demote_steps` steps and re-promotion, and
                 a hard stop after `give_up_after` strikes.  Every
                 transition is logged as a structured event.

As in the reference, only the forward entry quantize sites are
stat-instrumented; backward saturation surfaces through the grad-norm
spike and nonfinite-gradient bits one reduction later.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

# anomaly bitmask (int32 on the device; the reference's is uint32) --------
NONFINITE_LOSS = 1     # loss is NaN/inf
NONFINITE_GRAD = 2     # global grad norm is NaN/inf
GNORM_SPIKE = 4        # grad norm > spike_factor x carried EMA (post-warmup)
FP8_SAT = 8            # forward quantize-site saturation fraction too high
FP8_FLUSH = 16         # forward quantize-site underflow-flush fraction high
WIRE_SCALE = 32        # wire guard fired: a bucket rode the bf16 fallback

HARD_FLAGS = NONFINITE_LOSS | NONFINITE_GRAD | GNORM_SPIKE

_FLAG_NAMES = ((NONFINITE_LOSS, "nonfinite_loss"),
               (NONFINITE_GRAD, "nonfinite_grad"),
               (GNORM_SPIKE, "gnorm_spike"),
               (FP8_SAT, "fp8_sat"),
               (FP8_FLUSH, "fp8_flush"),
               (WIRE_SCALE, "wire_scale"))


def flag_names(flags: int) -> str:
    names = [n for bit, n in _FLAG_NAMES if int(flags) & bit]
    return "|".join(names) or "none"


@dataclasses.dataclass(frozen=True)
class GuardPlan:
    """Static detection thresholds, and the bits whose step the update
    drops on the device (`skip_flags`; the port's own field, which
    ``loop.run`` holds equal to ``GuardPolicy.skip_flags``)."""
    ema_beta: float = 0.95       # grad-norm EMA decay
    spike_factor: float = 4.0    # anomaly when gnorm > factor * EMA
    spike_warmup: int = 10       # healthy steps before the spike guard arms
    sat_frac_limit: float = 0.05   # fwd quantize |x/s| > fmax fraction
    flush_frac_limit: float = 0.5  # fwd quantize nonzero->zero fraction
    wire_exp_limit: int = 40     # |po2 exponent| beyond this is absurd
                                 # (e4m3 grads live within ~2^+-20 of scale 1)
    skip_flags: int = HARD_FLAGS


def init_guard_state(device="cpu"):
    """The tiny carried state: grad-norm EMA + healthy-step counter, on
    the device (``state['guard']``)."""
    return {"gnorm_ema": torch.zeros((), dtype=torch.float32, device=device),
            "steps": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def evaluate(plan: GuardPlan, gstate, *, loss, gnorm, sat_frac=None,
             flush_frac=None, wire_bad=None):
    """The in-step anomaly fold, torch ops on the device.  Returns (flags
    int32, new_gstate, guard_metrics); `gstate` is not modified."""
    def bit(cond, b):
        return torch.where(cond, b, 0).to(torch.int32)

    loss = torch.as_tensor(loss).to(torch.float32)
    gnorm = torch.as_tensor(gnorm).to(torch.float32)
    flags = bit(~torch.isfinite(loss), NONFINITE_LOSS)
    flags = flags | bit(~torch.isfinite(gnorm), NONFINITE_GRAD)
    warm = gstate["steps"] >= plan.spike_warmup
    ema = gstate["gnorm_ema"]
    spike = warm & torch.isfinite(gnorm) & (ema > 0) & \
        (gnorm > plan.spike_factor * ema)
    flags = flags | bit(spike, GNORM_SPIKE)
    if sat_frac is not None:
        flags = flags | bit(torch.as_tensor(sat_frac).to(torch.float32)
                            > plan.sat_frac_limit, FP8_SAT)
    if flush_frac is not None:
        flags = flags | bit(torch.as_tensor(flush_frac).to(torch.float32)
                            > plan.flush_frac_limit, FP8_FLUSH)
    if wire_bad is not None:
        flags = flags | bit(torch.as_tensor(wire_bad), WIRE_SCALE)

    # the EMA only learns from healthy steps, so one spike cannot drag the
    # baseline up and mask the next one
    ok = ((flags & HARD_FLAGS) == 0) & torch.isfinite(gnorm)
    seeded = torch.where(gstate["steps"] == 0, gnorm,
                         plan.ema_beta * ema + (1.0 - plan.ema_beta) * gnorm)
    new_state = {"gnorm_ema": torch.where(ok, seeded, ema),
                 "steps": gstate["steps"] + ok.to(torch.int32)}
    gmetrics = {"guard_flags": flags,
                "guard_gnorm_ema": new_state["gnorm_ema"]}
    return flags, new_state, gmetrics


# ---------------------------------------------------------------------------
# Host-side recovery ladder.
# ---------------------------------------------------------------------------
class GuardGiveUp(RuntimeError):
    """Raised when the anomaly budget is exhausted — the run is not
    recoverable by skipping/rolling back/demoting."""


@dataclasses.dataclass
class Verdict:
    skip: bool = False       # discard this step's update
    rollback: bool = False   # restore the last complete checkpoint
    demote: bool = False     # enter (or stay in) the bf16 fallback window


@dataclasses.dataclass
class GuardPolicy:
    """Recovery ladder driven by the per-step anomaly bitmask.

    Soft bits (FP8_SAT / FP8_FLUSH / WIRE_SCALE) are informational by
    default: the wire guard already recovered in-step (bf16 fallback), and
    saturation alone does not corrupt the update.  `skip_flags` widens the
    skip set if a deployment wants to act on them; the step's
    ``GuardPlan.skip_flags`` must then widen with it (``loop.run`` raises
    otherwise)."""
    skip_flags: int = HARD_FLAGS
    rollback_after: int = 3      # consecutive strikes -> restore checkpoint
    demote_after: int = 5        # consecutive strikes -> bf16 fallback
    demote_steps: int = 8        # fallback window length (steps)
    give_up_after: int = 20      # total strikes -> GuardGiveUp

    consecutive: int = 0
    total: int = 0
    demoted_until: int = -1
    events: List[dict] = dataclasses.field(default_factory=list)
    # optional obs.sink.Telemetry: the loop wires its handle in so every
    # ladder transition also lands in the structured sinks + a counter
    telemetry: Optional[object] = None

    def _event(self, log_fn: Callable, step: int, event: str, flags: int,
               **extra):
        rec = {"step": step, "event": event, "flags": int(flags),
               "flag_names": flag_names(flags), **extra}
        self.events.append(rec)
        detail = " ".join(f"{k}={v}" for k, v in extra.items())
        msg = (f"[guard] step={step} event={event} "
               f"flags={rec['flag_names']}{(' ' + detail) if detail else ''}")
        if self.telemetry is not None:
            self.telemetry.record("guard", msg=msg, **rec)
            self.telemetry.counter("guard_events_total",
                                   labels={"event": event}).inc()
        log_fn(msg)

    def demoted(self, step: int) -> bool:
        return step < self.demoted_until

    def observe(self, step: int, flags: int, log_fn: Callable = print,
                can_rollback: bool = True) -> Verdict:
        flags = int(flags)
        v = Verdict()
        if flags and not (flags & self.skip_flags):
            # soft-only anomaly: log it, keep the update
            self._event(log_fn, step, "soft_anomaly", flags)
            return v
        if not flags:
            if self.consecutive:
                self._event(log_fn, step, "recovered", 0,
                            after_strikes=self.consecutive)
            self.consecutive = 0
            if self.demoted_until == step:  # fallback window just ended
                self._event(log_fn, step, "repromote", 0)
            return v

        self.consecutive += 1
        self.total += 1
        v.skip = True
        if self.total >= self.give_up_after:
            self._event(log_fn, step, "give_up", flags, total=self.total)
            raise GuardGiveUp(
                f"step {step}: {self.total} anomalous steps "
                f"(flags={flag_names(flags)}) — giving up")
        if self.consecutive >= self.demote_after:
            v.demote = True
            self.demoted_until = step + 1 + self.demote_steps
            self._event(log_fn, step, "demote", flags,
                        until=self.demoted_until)
        elif self.consecutive >= self.rollback_after and can_rollback:
            v.rollback = True
            self._event(log_fn, step, "rollback", flags,
                        consecutive=self.consecutive)
        else:
            self._event(log_fn, step, "skip", flags,
                        consecutive=self.consecutive)
        return v
