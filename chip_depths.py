#!/usr/bin/env python3
"""How deep each config trains on one card: peak device memory of one
full-width train step at each depth asked for.

    python3 chip_depths.py                       # the defaults below
    python3 chip_depths.py mamba2_27b:48,56 llava_next_34b:2,3

For each ARCH:DEPTHS argument, smallest depth first: the state, step and
batch of chip_smoke.py's train path (``make_train``: AdamW, fp8_flow,
random bf16 params from seed 0, chip_smoke's batch for that config with
its stub prefix or encoder input), one step, then one JSON line with the
state and peak GiB and the step's seconds, or ``"oom"`` where the card
ran out.  Needs one NVIDIA GPU; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

import chip_smoke

DEFAULTS = {"mamba2_27b": (32, 48, 56, 64), "hymba_15b": (16, 32),
            "seamless_m4t_v2": (12, 24), "llava_next_34b": (1, 2, 3)}


def peak(arch: str, n_layers: int) -> dict:
    tag = next(t for t, a in chip_smoke.ARCH_TAGS.items() if a == arch)
    cfg = chip_smoke.arch_config(arch, n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"arch": arch, "n_layers": n_layers}
    state = step = batch = None
    try:
        state, step, batch = chip_smoke.make_train(cfg, torch.device("cuda"),
                                                   f"{tag}_train")
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
    asks = dict(DEFAULTS)
    if argv:
        asks = {a: tuple(int(n) for n in d.split(","))
                for a, d in (x.split(":") for x in argv)}
    for arch, depths in asks.items():
        for n in sorted(depths):
            row = peak(arch, n)
            print(json.dumps(row), flush=True)
            if row.get("oom"):
                break
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
