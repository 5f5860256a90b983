#!/usr/bin/env python3
"""Where the time goes on the port's serve and train paths: torch.profiler
over chip_smoke.py's serve trace and train step on one NVIDIA GPU.

    python3 chip_profile.py [label ...]   # from the repo root; one card

With labels (``serve``, ``dsv2_train``, ``grok_serve``, ...), only those
passes run.

Each pass runs with the padded recipe, then with the masked one
(masked_experts + the fused SwiGLU GEMM-1 epilogue; chip_smoke.py phases
3b and 6b), then with the baselines: bf16 for serving, bf16, blockwise
and naive_fp8 for training (phases 3c and 6c).  Serve pass: builds the same engine as chip_smoke.py's phase 3
(qwen3_moe_235b at full width, 4 layers, W8 experts, FP8 KV), runs the
16-request trace once to warm up, once more with no profiler to time it,
then again under torch.profiler (CPU + CUDA activity).  Train pass: the
same for chip_smoke.py's phase 6 train step (full width, 1 layer, AdamW,
the fixed 2 x 1024-token batch): one warm-up step, three timed unprofiled
steps, three profiled steps.  Then the same two passes of deepseek_v2_lite
(chip_smoke.py's phases 10-11): the serve pass at full depth (27 layers)
and the train step at depth 4 (1 dense + 3 MoE layers), padded; and
qwen15_05b's train step (24 dense layers).  Then grok1_314b's serve pass
(chip_smoke.py phase 14: 4 layers of 8 GeGLU experts, W8) and
gemma2_9b's train step (phase 16: 8 local:global GeGLU layers).  Each
pass prints one JSON line: the wall
seconds of the plain and the profiled run, the device's busy time (kernel
self time under the profiler), its busy and idle shares of the plain
run's wall time (the profiler adds host time, so its own wall would
overstate the idle share), device time by group (the hand-written
kernels, cuBLAS GEMMs, everything else) and `quant_weights`: the device
time of the blockwise quantizes of bf16 weights inside the expert FFN
(``core.linear._quant_weights``, under a profiler range: in serving the
dense layers' and shared experts' weights at every prefill, W8 covering
only the routed experts), then a JSON line with the top kernels.
"""
from __future__ import annotations

import contextlib
import json
import re
import sys
import time

import torch

import chip_smoke

# the kernels' template flags name their group:
# grouped_gemm_fp8_kernel<BM, W_TRANS, QUANT_OUT, MASKED>,
# grouped_gemm_nt_fp8_kernel<BF16_OUT, MASKED>
GG = re.compile(r"grouped_gemm_fp8_kernel<\d+, \w+, (\w+), (\w+)>")
NT = re.compile(r"grouped_gemm_nt_fp8_kernel<\w+, (\w+)>")
# quantize_rowwise_kernel<T, UNITS, LINEAR>
QL = re.compile(r"quantize_rowwise_kernel<[^>]*, true>")
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
    if QL.search(name):
        return "quantize_rowwise_linear"
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


@contextlib.contextmanager
def weight_quantize_range():
    """core.linear._quant_weights under a profiler range named
    quant_weights, so the device time of its kernels can be read."""
    from repro_torch.core import linear
    orig = linear._quant_weights

    def annotated(*args, **kw):
        with torch.profiler.record_function("quant_weights"):
            return orig(*args, **kw)

    linear._quant_weights = annotated
    try:
        yield
    finally:
        linear._quant_weights = orig


def device_total_ms(prof, key) -> float:
    """Device time of the kernels launched inside the ranges `key`."""
    for e in prof.key_averages():
        if e.key == key:
            for attr in ("device_time_total", "cuda_time_total"):
                if hasattr(e, attr):
                    return float(getattr(e, attr)) / 1e3
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
    with weight_quantize_range(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n_units = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the quant_weights range also shows as a device event spanning its
    # kernels: it is not a kernel
    kernels = [e for e in prof.key_averages() if device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != "quant_weights"]
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
        quant_weights_ms=device_total_ms(prof, "quant_weights"),
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
    only = set(sys.argv[1:])

    passes = [(label, chip_smoke.serve_config()) for label in (
        "serve", "masked_serve", "bf16_serve")]
    passes.append(("dsv2_serve", chip_smoke.arch_config("deepseek_v2_lite")))
    passes.append(("grok_serve", chip_smoke.arch_config(
        "grok1_314b", chip_smoke.GROK_SERVE_LAYERS)))
    for label, cfg in passes:
        if only and label not in only:
            continue
        eng, reqs = chip_smoke.make_serve(cfg, dev, label)
        eng.run(reqs, realtime=False)                  # warm-up pass

        def serve():
            t0 = eng.stats()["ticks"]
            results = eng.run(reqs, realtime=False)
            chip_smoke.check(len(results) == len(reqs),
                             "a serve run incomplete")
            return results.stats["ticks"] - t0

        profile_pass(label, serve, "ticks")
        del eng
        torch.cuda.empty_cache()

    passes = [(label, chip_smoke.train_config()) for label in (
        "train", "masked_train", "bf16_train", "blockwise_train",
        "naive_train")]
    passes += [("dsv2_train", chip_smoke.arch_config(
        "deepseek_v2_lite", chip_smoke.DSV2_TRAIN_LAYERS)),
        ("qwen15_train", chip_smoke.arch_config("qwen15_05b")),
        ("g2_train", chip_smoke.arch_config(
            "gemma2_9b", chip_smoke.TRAIN_LAYERS["g2"]))]
    for label, cfg in passes:
        if only and label not in only:
            continue
        state, step, batch = chip_smoke.make_train(cfg, dev, label)
        box = {"state": state}
        del state

        def train(n=3):
            for _ in range(n):
                box["state"], m = step(box["state"], batch)
                chip_smoke.check(bool(torch.isfinite(m["loss"])),
                                 "a non-finite train loss")
            return n

        train(1)                                       # warm-up step
        profile_pass(label, train, "steps")
        box.clear()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
