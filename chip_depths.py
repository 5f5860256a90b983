#!/usr/bin/env python3
"""How deep each config trains on one card: peak device memory of one
full-width train step at each depth asked for, under the f32 optimizer
state and the FP8-split one (``StatePolicy()``).

    python3 chip_depths.py                       # the defaults below
    python3 chip_depths.py mamba2_27b:48,56 llava_next_34b:2,3:split

For each ARCH:DEPTHS[:STATE] argument (STATE f32 or split; both when
left out), smallest depth first: the state, step and batch of
chip_smoke.py's train path (``make_train``: AdamW with that state,
fp8_flow, random bf16 params from seed 0, chip_smoke's batch for that
config with its stub prefix or encoder input), one step, then one JSON
line with the state and peak GiB and the step's seconds, or ``"oom"``
where the card ran out.  Needs one NVIDIA GPU; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

import chip_smoke

# the depths of each config, by optimizer state: around the f32 state's
# known limits (PERF.md section 4) and the split state's predicted ones
DEFAULTS = {
    "qwen3_moe_235b": {"f32": (1, 2), "split": (2, 3)},
    "deepseek_v2_lite": {"f32": (6, 8, 10), "split": (12, 14, 16)},
    "mamba2_27b": {"f32": (52, 56), "split": (56, 60, 64)},
    "llava_next_34b": {"f32": (4, 5), "split": (5, 6, 7)},
}
STATES = ("f32", "split")


def peak(arch: str, n_layers: int, state_kind: str = "f32") -> dict:
    # chip_smoke's path label of the config (qwen3_moe_235b's is "train")
    label = next((f"{t}_train" for t, a in chip_smoke.ARCH_TAGS.items()
                  if a == arch), "train")
    cfg = chip_smoke.arch_config(arch, n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"arch": arch, "n_layers": n_layers, "opt_state": state_kind}
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
    asks = [(a, k, d) for a, by in DEFAULTS.items() for k, d in by.items()]
    if argv:
        asks = []
        for x in argv:
            arch, depths, *kind = x.split(":")
            for k in kind or STATES:
                asks.append((arch, k, tuple(int(n) for n in
                                            depths.split(","))))
    for arch, kind, depths in asks:
        for n in sorted(depths):
            row = peak(arch, n, kind)
            print(json.dumps(row), flush=True)
            if row.get("oom"):
                break
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
