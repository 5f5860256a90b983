"""Deterministic fault injection for the numerics guardrails.

Counterpart of ``repro.runtime.fault_injection``.  Every guard in
``train/guards.py`` has a fault here that shows detection and recovery.
Three families:

  numeric   a NaN into the first element of an entry quantize's input
            (``nan_activation``, at the ``q_entry`` sites: the dense entry
            and the MoE dispatch, before kernel #1 on the card and before
            its twin on the CPU); on the FP8 DP wire (``dp_wire``, in
            ``dist/grad_comm.quantize_bucket``) a flipped payload byte
            (``payload_bitflip``: 0x7f, e4m3fn's NaN) or a poisoned
            bucket exponent (``wire_scale``: int8 127, a scale of
            2^127), which the wire guard catches on the received message.
  host      a simulated host failure: flips the HealthMonitor's `failed`
            bit so ``ElasticTrainer``'s re-mesh path fires.
  disk      checkpoint corruption on the filesystem: rewrite a shard's
            payload bytes (a valid npz, wrong data: caught by the restore
            fingerprint check) or truncate the npz (caught by the load
            guard).  Both surface as CheckpointCorruptError.

PyTorch runs eagerly, so there is no per-spec jit cache: ``FaultStepper``
arms the contextvar around the call of the step it wraps, and the hook
(``apply``) is a no-op returning its input while nothing is armed.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

NUMERIC_KINDS = ("nan_activation", "payload_bitflip", "wire_scale")
DISK_KINDS = ("ckpt_corrupt", "ckpt_truncate")
HOST_KINDS = ("host_failure",)
KINDS = NUMERIC_KINDS + DISK_KINDS + HOST_KINDS

# numeric fault kind -> the hook point it fires at
_POINT_OF = {"nan_activation": "activation",
             "payload_bitflip": "wire_payload",
             "wire_scale": "wire_exp"}


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.  `site` scopes a numeric fault to a quantize
    tag ('q_entry'; empty = any hooked site) and names the host id of
    host_failure or the checkpoint step of a disk fault (empty =
    latest)."""
    kind: str
    step: int
    site: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind}; "
                             f"pick from {KINDS}")


_ACTIVE: contextvars.ContextVar[Optional[Fault]] = contextvars.ContextVar(
    "active_fault", default=None)


@contextlib.contextmanager
def activate(fault: Optional[Fault]):
    """Arm `fault` for the duration of a call."""
    tok = _ACTIVE.set(fault)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def armed() -> Optional[Fault]:
    """The fault armed in this context (None if none): a checkpoint block
    re-arms it in its recompute (train/memory.py)."""
    return _ACTIVE.get()


def apply(point: str, tag: str, x: torch.Tensor) -> torch.Tensor:
    """Hook call sites: returns `x` poisoned (a new tensor) iff the armed
    fault targets this (point, tag); `x` itself otherwise.  The first
    element becomes NaN (an activation), the byte 0x7f (a wire payload)
    or 127 (a wire exponent)."""
    f = _ACTIVE.get()
    if f is None or _POINT_OF.get(f.kind) != point:
        return x
    if f.site and f.site != tag:
        return x
    out = x.clone()
    if point == "activation":
        out.reshape(-1)[0] = float("nan")
    elif point == "wire_payload":
        out.view(torch.uint8).reshape(-1)[0] = 0x7F
    else:
        out.reshape(-1)[0] = 127
    return out


# ---------------------------------------------------------------------------
# The schedule: which fault fires at which loop step.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultPlan:
    faults: Tuple[Fault, ...] = ()

    def _at(self, step: int, kinds) -> Optional[Fault]:
        for f in self.faults:
            if f.step == step and f.kind in kinds:
                return f
        return None

    def numeric_for(self, step: int) -> Optional[Fault]:
        return self._at(step, NUMERIC_KINDS)

    def host_for(self, step: int) -> Optional[Fault]:
        return self._at(step, HOST_KINDS)

    def disk_for(self, step: int) -> Optional[Fault]:
        return self._at(step, DISK_KINDS)

    def wrap(self, raw_step_fn) -> "FaultStepper":
        """Wrap a train_step; the loop resolves the step's callable via
        `.for_step(step)`."""
        return FaultStepper(raw_step_fn, self)


class FaultStepper:
    """A train_step that arms the step's scheduled numeric fault around its
    call."""

    def __init__(self, raw_fn, plan: FaultPlan):
        self._raw = raw_fn
        self._plan = plan

    @property
    def guard(self):
        """The wrapped step's GuardPlan, which ``loop.run`` checks."""
        return getattr(self._raw, "guard", None)

    @property
    def shardings(self):
        """The wrapped step's state shardings on a mesh (None off one)."""
        return getattr(self._raw, "shardings", None)

    def for_step(self, step: int):
        fault = self._plan.numeric_for(step)
        if fault is None:
            return self._raw

        def faulted(state, batch, _f=fault):
            with activate(_f):
                return self._raw(state, batch)
        return faulted

    def __call__(self, state, batch):           # clean-path convenience
        return self._raw(state, batch)


def apply_host_fault(fault: Fault, elastic) -> None:
    """Mark a host failed on the HealthMonitor: the next
    ``ElasticTrainer.plan_step()`` sees it and takes the re-mesh path.
    A no-op when the host was already evicted (the rewound loop replays
    the failure step, and a dead host cannot die twice)."""
    host = int(fault.site or 0)
    st = elastic.monitor.hosts.get(host)
    if st is not None:
        st.failed = True


# ---------------------------------------------------------------------------
# Disk faults (on the layout of checkpoint/checkpointing.py).
# ---------------------------------------------------------------------------
def _shard_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}", "shard_0.npz")


def corrupt_checkpoint_shard(ckpt_dir: str, step: int) -> None:
    """Rewrite the largest leaf's bytes (bitwise NOT) through a valid npz
    re-save: the archive still loads, so only the manifest fingerprint
    can catch it."""
    path = _shard_path(ckpt_dir, step)
    with np.load(path) as data:
        raw = {k: np.array(data[k]) for k in data.files}
    victim = max(raw, key=lambda k: raw[k].size)
    raw[victim] = np.ascontiguousarray(~raw[victim])
    np.savez(path, **raw)


def truncate_checkpoint_shard(ckpt_dir: str, step: int) -> None:
    """Chop the shard file in half: a torn, partly written shard."""
    path = _shard_path(ckpt_dir, step)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


def apply_disk_fault(fault: Fault, ckpt_dir: str) -> Optional[int]:
    """Apply a scheduled disk fault to the newest complete checkpoint (or
    the step in `fault.site`).  Returns the poisoned step."""
    from repro_torch.checkpoint import checkpointing
    step = int(fault.site) if fault.site else \
        checkpointing.latest_step(ckpt_dir)
    if step is None:
        return None
    if fault.kind == "ckpt_corrupt":
        corrupt_checkpoint_shard(ckpt_dir, step)
    else:
        truncate_checkpoint_shard(ckpt_dir, step)
    return step
