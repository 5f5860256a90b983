#!/usr/bin/env python3
"""Where the time goes on the port's serve and train paths: torch.profiler
over chip_smoke.py's serve trace and train step on one NVIDIA GPU.

    python3 chip_profile.py        # from the repo root; needs one card

Each pass runs with the padded recipe, then with the masked one
(masked_experts + the fused SwiGLU GEMM-1 epilogue; chip_smoke.py phases
3b and 6b).  Serve pass: builds the same engine as chip_smoke.py's phase 3
(qwen3_moe_235b at full width, 4 layers, W8 experts, FP8 KV), runs the
16-request trace once to warm up, once more with no profiler to time it,
then again under torch.profiler (CPU + CUDA activity).  Train pass: the
same for chip_smoke.py's phase 6 train step (full width, 1 layer, AdamW,
the fixed 2 x 1024-token batch): one warm-up step, three timed unprofiled
steps, three profiled steps.  Each pass prints one JSON line: the wall
seconds of the plain and the profiled run, the device's busy time (kernel
self time under the profiler), its busy and idle shares of the plain
run's wall time (the profiler adds host time, so its own wall would
overstate the idle share) and device time by group (the hand-written
kernels, cuBLAS GEMMs, everything else), then a JSON line with the top
kernels.
"""
from __future__ import annotations

import json
import re
import sys
import time

import torch

import chip_smoke

# the grouped GEMMs' template flags name their group:
# grouped_gemm_fp8_kernel<BM, W_TRANS, QUANT_OUT, MASKED>,
# grouped_gemm_nt_fp8_kernel<BF16_OUT, MASKED>
GG = re.compile(r"grouped_gemm_fp8_kernel<\d+, \w+, (\w+), (\w+)>")
NT = re.compile(r"grouped_gemm_nt_fp8_kernel<\w+, (\w+)>")
# other kernel-name substrings -> group (first match wins)
GROUPS = (("masked_grouped_gemm_swiglu_quant",
           ("grouped_gemm_swiglu_quant_kernel",)),
          ("fp8_transpose", ("fp8_transpose_kernel",)),
          ("quantize_rowwise", ("quantize_rowwise_kernel",)),
          ("fused_permute_pad", ("permute_pad_kernel",)),
          ("fused_swiglu_quant", ("swiglu_quant_kernel",)),
          ("cublas_gemm", ("gemm", "Gemm", "nvjet", "cutlass", "xmma")))


def group_of(name: str) -> str:
    m = GG.search(name)
    if m:
        return (("masked_" if m.group(2) == "true" else "")
                + "grouped_gemm_fp8"
                + ("_quant_out" if m.group(1) == "true" else ""))
    m = NT.search(name)
    if m:
        return ("masked_" if m.group(1) == "true" else "") + \
            "grouped_gemm_nt_fp8"
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


def profile_pass(label, run, unit):
    """Time one warmed call of `run` unprofiled, then profile another; `run`
    returns how many `unit`s it ran.  Prints the pass's JSON lines."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()                                              # timed, unprofiled
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n_units = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
        path=label, **{unit: n_units}, wall_s=plain_wall,
        profiled_wall_s=wall, device_busy_ms=busy_ms,
        device_busy_share=busy_ms / (plain_wall * 1e3),
        device_idle_share=1 - busy_ms / (plain_wall * 1e3),
        groups={g: dict(ms=v[0], share=v[0] / busy_ms, launches=v[1])
                for g, v in sorted(by_group.items(),
                                   key=lambda kv: -kv[1][0])})}))
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    print(json.dumps({"top_kernels": [
        dict(name=e.key[:120], ms=device_us(e) / 1e3, count=e.count)
        for e in top], "path": label}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))

    for masked in (False, True):
        eng, reqs = chip_smoke.make_serve(chip_smoke.serve_config(), dev,
                                          masked)
        eng.run(reqs, realtime=False)                  # warm-up pass

        def serve():
            t0 = eng.stats()["ticks"]
            results = eng.run(reqs, realtime=False)
            chip_smoke.check(len(results) == len(reqs),
                             "a serve run incomplete")
            return results.stats["ticks"] - t0

        profile_pass("masked_serve" if masked else "serve", serve, "ticks")
        del eng
        torch.cuda.empty_cache()

    cfg = chip_smoke.train_config()
    for masked in (False, True):
        state, step, batch = chip_smoke.make_train(cfg, dev, masked)
        box = {"state": state}
        del state

        def train(n=3):
            for _ in range(n):
                box["state"], m = step(box["state"], batch)
                chip_smoke.check(bool(torch.isfinite(m["loss"])),
                                 "a non-finite train loss")
            return n

        train(1)                                       # warm-up step
        profile_pass("masked_train" if masked else "train", train, "steps")
        box.clear()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
