#!/usr/bin/env python3
"""Where the time goes on the port's serve path: torch.profiler over the
serve trace of chip_smoke.py on one NVIDIA GPU.

    python3 chip_profile.py        # from the repo root; needs one card

Builds the same engine as chip_smoke.py's phase 3 (qwen3_moe_235b at full
width, 4 layers, W8 experts, FP8 KV), runs the 16-request trace once to
warm up, once more with no profiler to time it, then again under
torch.profiler (CPU + CUDA activity), and prints one JSON line: the wall
seconds of the plain and the profiled run, the device's busy time (kernel
self time under the profiler), its busy and idle shares of the plain
run's wall time (the profiler adds host time, so its own wall would
overstate the idle share) and device time by group (the four
hand-written kernels, cuBLAS GEMMs, everything else), then a JSON line
with the top kernels.
"""
from __future__ import annotations

import json
import sys
import time

import torch

import chip_smoke

# kernel-name substrings -> group (first match wins)
GROUPS = (("grouped_gemm_fp8", ("grouped_gemm_fp8_kernel",)),
          ("quantize_rowwise", ("quantize_rowwise_kernel",)),
          ("fused_permute_pad", ("permute_pad_kernel",)),
          ("fused_swiglu_quant", ("swiglu_quant_kernel",)),
          ("cublas_gemm", ("gemm", "Gemm", "nvjet", "cutlass", "xmma")))


def group_of(name: str) -> str:
    for group, pats in GROUPS:
        if any(p in name for p in pats):
            return group
    return "other"


def device_us(evt) -> float:
    # torch renamed cuda_* to device_* timings; read whichever exists
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    eng, reqs = chip_smoke.make_serve(chip_smoke.serve_config(), dev)
    eng.run(reqs, realtime=False)                      # warm-up pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs, realtime=False)                      # timed, unprofiled
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    ticks0 = eng.stats()["ticks"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        results = eng.run(reqs, realtime=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    chip_smoke.check(len(results) == len(reqs), "profiled run incomplete")

    kernels = [e for e in prof.key_averages() if device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    by_group = {}
    for e in kernels:
        g = group_of(e.key)
        by_group.setdefault(g, [0.0, 0])
        by_group[g][0] += device_us(e) / 1e3
        by_group[g][1] += e.count
    busy_ms = sum(v[0] for v in by_group.values())
    chip_smoke.check(busy_ms > 0, "the profiler recorded no device time")
    print(json.dumps({"profile": dict(
        ticks=results.stats["ticks"] - ticks0, wall_s=plain_wall,
        profiled_wall_s=wall, device_busy_ms=busy_ms,
        device_busy_share=busy_ms / (plain_wall * 1e3),
        device_idle_share=1 - busy_ms / (plain_wall * 1e3),
        groups={g: dict(ms=v[0], share=v[0] / busy_ms, launches=v[1])
                for g, v in sorted(by_group.items(),
                                   key=lambda kv: -kv[1][0])})}))
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    print(json.dumps({"top_kernels": [
        dict(name=e.key[:120], ms=device_us(e) / 1e3, count=e.count)
        for e in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
