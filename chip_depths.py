#!/usr/bin/env python3
"""How deep each config trains on one card: peak device memory of one
full-width train step at each depth asked for, under the f32 optimizer
state and the FP8-split one (``StatePolicy()``), and under each
activation-residency policy (``ArchConfig.remat_policy``,
train/memory.py).

    python3 chip_depths.py                       # the defaults below
    python3 chip_depths.py mamba2_27b:48,56 llava_next_34b:5,6,7:f32:fp8_resident

For each ARCH:DEPTHS[:STATE[:POLICY]] argument (STATE f32 or split, both
when left out; POLICY none, full, fp8_resident or pair, every one when
left out), smallest depth first: the state, step and batch of
chip_smoke.py's train path (``make_train``: AdamW with that state,
fp8_flow, random bf16 params from seed 0, chip_smoke's batch for that
config with its stub prefix or encoder input), one step, then one JSON
line with the state, the policy and peak GiB and the step's seconds, or
``"oom"`` where the card ran out.  Needs one NVIDIA GPU; imports nothing
of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

import chip_smoke

# the depths of each config, by optimizer state, around the known limits
# (PERF.md section 4) and the predicted ones; the remat policies each
# config is measured under (qwen3_moe_235b: the default only)
DEFAULTS = {
    "qwen3_moe_235b": {"f32": (1, 2), "split": (2, 3)},
    "deepseek_v2_lite": {"f32": (8, 9), "split": (12, 14, 15)},
    "mamba2_27b": {"f32": (52, 56, 64), "split": (64,)},
    "llava_next_34b": {"f32": (6, 7, 8), "split": (11, 12, 13, 14)},
}
POLICIES_OF = {"qwen3_moe_235b": ("full",)}
STATES = ("f32", "split")
POLICIES = chip_smoke.REMAT_POLICIES


def peak(arch: str, n_layers: int, state_kind: str = "f32",
         policy: str = "full") -> dict:
    # chip_smoke's path label of the config (qwen3_moe_235b's is "train")
    label = next((f"{t}_train" for t, a in chip_smoke.ARCH_TAGS.items()
                  if a == arch), "train")
    cfg = dataclasses.replace(chip_smoke.arch_config(arch, n_layers),
                              remat_policy=policy)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"arch": arch, "n_layers": n_layers, "opt_state": state_kind,
           "remat_policy": policy}
    state = step = batch = None
    try:
        from repro_torch.dist.opt_state import StatePolicy
        state, step, batch = chip_smoke.make_train(
            cfg, torch.device("cuda"), label,
            StatePolicy() if state_kind == "split" else None)
        torch.cuda.synchronize()
        out["state_gib"] = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        state, m = step(state, batch)
        out["loss"] = float(m["loss"])
        torch.cuda.synchronize()
        out["step_s"] = time.perf_counter() - t0
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    except torch.cuda.OutOfMemoryError:
        out["oom"] = True
        out["peak_gib_before_oom"] = \
            torch.cuda.max_memory_allocated() / 2**30
    del state, step, batch
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_depths: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps({"total_gib": torch.cuda.get_device_properties(
        0).total_memory / 2**30}))
    from repro_torch.kernels import build
    build.build()
    asks = [(a, k, pol, d) for a, by in DEFAULTS.items()
            for k, d in by.items() for pol in POLICIES_OF.get(a, POLICIES)]
    if argv:
        asks = []
        for x in argv:
            arch, depths, *rest = x.split(":")
            kinds = rest[:1] or STATES
            policies = rest[1:2] or POLICIES
            for k in kinds:
                for pol in policies:
                    asks.append((arch, k, pol, tuple(
                        int(n) for n in depths.split(","))))
    for arch, kind, policy, depths in asks:
        for n in sorted(depths):
            row = peak(arch, n, kind, policy)
            print(json.dumps(row), flush=True)
            if row.get("oom"):
                break
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
