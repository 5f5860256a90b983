#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs one card

Phases (any failure raises and the script exits non-zero):
  1. card + build: the card's name and power limit (nvidia-smi), then the
     four CUDA kernels built from src/repro_torch/csrc for sm_90a;
  2. kernels vs plain: each kernel against its plain PyTorch twin on the
     card at the serving path's full-width shapes (qwen3_moe_235b: bucket
     64 prefill, 8-slot decode), to the tolerances of the CPU tests, with
     device times (CUDA graph replays), the wrapper's call time, the bound
     of the H100 SXM and a library yardstick;
  3. the serve path: a ServeEngine over qwen3_moe_235b at full width, depth
     cut to 4 layers, random W8 weights from a seed, FP8 paged KV, serving
     16 greedy requests; every kernel's launch count must be > 0;
  4. GPU path vs CPU path: at reduced() size, one prefill + decode step on
     the card (kernels) and on the CPU (plain twins), logits cosine >= 0.999;
  5. the {"kernels": [...]} summary line, then the result line.
It imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published dense peaks of the H100 SXM (NVIDIA data sheet): HBM bytes/s,
# fp8 and bf16 tensor-core and f32 (non-tensor) FLOP/s; the bounds hold
# only for that part, whose name torch reports as "NVIDIA H100 80GB HBM3"
PEAKS = dict(bw=3.35e12, fp8=1979e12, bf16=989e12, f32=67e12)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, target_ms=25.0):
    """Median device time per call: n calls captured into one CUDA graph and
    replayed 5 times between CUDA events, so the host cost of a call
    (Python checks, allocation, the ctypes call) is not in it; n is sized
    from call_ms."""
    n = max(1, min(200, int(target_ms / max(call_ms(fn, 1, 1), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(5):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def call_ms(fn, n=20, reps=5):
    """Median time per call of `fn` issued from Python back to back between
    CUDA events: the device time or, for a short kernel, the host cost of
    one wrapper call, whichever is longer."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound(bytes_moved, ops, peak_ops, peaks):
    t_bytes = bytes_moved / peaks["bw"] * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dq(data, scale):
    """fp8 payload (M, K) + row scales -> f32, for error reporting."""
    M, K = data.shape
    return (data.to(torch.float32).reshape(M, -1, 128)
            * scale[..., None]).reshape(M, K)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its twin at the serving shapes.
# ---------------------------------------------------------------------------
def kernel_checks(cfg, peaks, dev):
    from repro_torch.core.moe import _dispatch_plan, _expert_plan, _round_up
    from repro_torch.core.quant import (QTensor, _dequantize_nocount,
                                        quantize_blockwise)
    from repro_torch.kernels import (fused_permute_pad, fused_swiglu_quant,
                                     grouped_gemm_fp8, quantize)

    gen = torch.Generator(device=dev).manual_seed(1)
    D, F, E, k = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.top_k
    T_pf, B_dec = 64, 8
    C_send = _round_up(max(int(T_pf * k * 1.25), 8), 8)          # 640
    C_exp = _round_up(max(C_send // E, 8), 128)                  # 128
    C_dec = _round_up(max(int(2.0 * B_dec * k / E), 8), 8)       # 8

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def route(T):
        return torch.topk(randn(T, E), k, dim=-1).indices

    results = {}

    def record(name, shape, kfn, pfn, lfn, nbytes, ops, peak_ops, err, extra,
               plain_target_ms=25.0):
        """Time kernel `kfn`, twin `pfn` and library call `lfn` (or None)."""
        b, by = bound(nbytes, ops, peak_ops, peaks)
        row = dict(kernel=name, shape=shape, kernel_ms=time_ms(kfn),
                   call_ms=call_ms(kfn),
                   plain_ms=time_ms(pfn, target_ms=plain_target_ms),
                   library_ms=time_ms(lfn) if lfn else None, bound_ms=b,
                   bound_by=by, max_abs_err=err, **extra)
        print(json.dumps(row))
        results.setdefault(name, []).append(row)

    # -- quantize: entry quantize of a prefill bucket and of a decode batch
    for shape, M in (("prefill", T_pf), ("decode", B_dec)):
        x = randn(M, D).to(torch.bfloat16)
        d, s = quantize.quantize_rowwise_cuda(x)
        dp, sp = quantize.quantize_rowwise_plain(x)
        check(torch.equal(d.view(torch.uint8), dp.view(torch.uint8))
              and torch.equal(s, sp), f"quantize {shape}: not bitwise")
        err = (dq(d, s) - dq(dp, sp)).abs().max().item()
        record("quantize_rowwise", f"{shape} ({M},{D}) bf16",
               lambda: quantize.quantize_rowwise_cuda(x),
               lambda: quantize.quantize_rowwise_plain(x), None,
               M * D * 2 + M * D + M * D // 128 * 4, 4 * M * D, peaks["f32"],
               err, {"tolerance": "bitwise"})

    # -- permute+pad: prefill send layout, expert grouping, decode gather
    ids = route(T_pf)
    rms, slot_e, _, _ = _dispatch_plan(ids, k, 1, E, C_send)
    rme, _ = _expert_plan(slot_e, E, C_exp)
    rme_dec, _ = _expert_plan(route(B_dec).reshape(-1), E, C_dec)
    tok_dec = torch.where(rme_dec >= 0, rme_dec // k, -1)
    for shape, T, row_map in (("prefill_send", T_pf, rms),
                              ("prefill_group", C_send, rme),
                              ("decode_gather", B_dec, tok_dec)):
        x, s = quantize.quantize_rowwise_cuda(randn(T, D))
        row_map = row_map.to(torch.int32).contiguous()
        xo, so = fused_permute_pad.fused_permute_pad_cuda(x, s, row_map)
        xp, sp = fused_permute_pad.fused_permute_pad_plain(x, s, row_map)
        check(torch.equal(xo.view(torch.uint8), xp.view(torch.uint8))
              and torch.equal(so, sp), f"permute_pad {shape}: not bitwise")
        n_out = row_map.numel()
        live = int((row_map >= 0).sum())
        row_bytes = D + D // 128 * 4
        record("fused_permute_pad", f"{shape} ({T},{D})->({n_out},{D})",
               lambda: fused_permute_pad.fused_permute_pad_cuda(x, s, row_map),
               lambda: fused_permute_pad.fused_permute_pad_plain(x, s, row_map),
               None,
               live * row_bytes + n_out * (row_bytes + 4), 0, peaks["f32"],
               (dq(xo, so) - dq(xp, sp)).abs().max().item(),
               {"tolerance": "bitwise", "live_rows": live})

    # -- grouped GEMM: GEMM-1 and GEMM-2 of prefill and decode
    w13 = quantize_blockwise(randn(E, D, 2 * F, scale=0.02).to(torch.bfloat16))
    w2 = quantize_blockwise(randn(E, F, D, scale=0.02).to(torch.bfloat16))
    for shape, C, qw in (("prefill_gemm1", C_exp, w13),
                         ("prefill_gemm2", C_exp, w2),
                         ("decode_gemm1", C_dec, w13),
                         ("decode_gemm2", C_dec, w2)):
        K, N = qw.data.shape[1], qw.data.shape[2]
        xd, xs = quantize.quantize_rowwise_cuda(randn(E * C, K))
        xd, xs = xd.reshape(E, C, K), xs.reshape(E, C, K // 128)
        args = (xd, xs, qw.data, qw.scale)
        out = grouped_gemm_fp8.grouped_gemm_fp8_cuda(*args).to(torch.float32)
        ref = grouped_gemm_fp8.grouped_gemm_fp8_plain(*args).to(torch.float32)
        torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2,
                                   msg=f"grouped_gemm {shape}")
        xb = _dequantize_nocount(QTensor(xd, xs, (1, 1, 128)), torch.bfloat16)
        wb = _dequantize_nocount(qw, torch.bfloat16)
        record("grouped_gemm_fp8", f"{shape} ({E},{C},{K})x({E},{K},{N})",
               lambda: grouped_gemm_fp8.grouped_gemm_fp8_cuda(*args),
               lambda: grouped_gemm_fp8.grouped_gemm_fp8_plain(*args),
               lambda: torch.bmm(xb, wb),
               E * C * K + E * C * K // 128 * 4 + E * K * N
               + E * (K // 128) * (N // 128) * 4 + E * C * N * 2,
               2 * E * C * K * N, peaks["fp8"],
               (out - ref).abs().max().item(),
               {"tolerance": "rtol=atol=2e-2",
                "library": "torch.bmm on bf16-dequantized operands "
                           "(nearest yardstick; not the same function)"},
               plain_target_ms=50)
        del xb, wb

    # -- fused SwiGLU + quantize on GEMM-1's output
    for shape, M in (("prefill", E * C_exp), ("decode", E * C_dec)):
        h = randn(M, 2 * F).to(torch.bfloat16)
        d, s = fused_swiglu_quant.fused_swiglu_quant_cuda(h)
        dp, sp = fused_swiglu_quant.fused_swiglu_quant_plain(h)
        check(torch.equal(s, sp), f"swiglu {shape}: scales differ")
        frac = (d.view(torch.uint8) != dp.view(torch.uint8)).float().mean()
        check(frac.item() < 0.01, f"swiglu {shape}: {frac.item()} mismatch")
        record("fused_swiglu_quant", f"{shape} ({M},{2 * F}) bf16",
               lambda: fused_swiglu_quant.fused_swiglu_quant_cuda(h),
               lambda: fused_swiglu_quant.fused_swiglu_quant_plain(h), None, M * 2 * F * 2 + M * F + M * F // 128 * 4, 8 * M * F,
               peaks["f32"], (dq(d, s) - dq(dp, sp)).abs().max().item(),
               {"tolerance": "scales equal, <1% payload bytes differ "
                             "(sigmoid bits)", "mismatch_frac": frac.item()})
    del w13, w2
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 3: the serve path at full width.
# ---------------------------------------------------------------------------
def serve_config():
    """qwen3_moe_235b at full width, depth cut to 4 of 94 layers to fit
    one card and the time limit."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("qwen3_moe_235b"), n_layers=4)


def make_serve(cfg, dev):
    """The serve path's engine (random W8 weights from seed 0, FP8 KV) and
    its trace: 16 greedy requests, prompts of 3-48 tokens, 16 new each."""
    from repro_torch.core.recipes import get_recipe
    from repro_torch.models.lm import init_params
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import Request

    ecfg = ServeConfig(max_batch=8, page_size=8, n_pages=128,
                       max_pages_per_req=8, token_budget=512,
                       prefill_buckets=(16, 32, 64), fp8_kv=True,
                       w8_weights=True, seed=0)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, get_recipe("fp8_flow"),
                      init_params(cfg, seed=0, device=dev), ecfg, device=dev)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} n_layers={cfg.n_layers} d_model="
          f"{cfg.d_model} experts={cfg.n_experts} top{cfg.top_k} "
          f"vocab={cfg.vocab}: random W8 params + FP8 pool in "
          f"{time.perf_counter() - t0:.1f}s, kv pool "
          f"{eng.kv_bytes() / 2**20:.1f} MiB")
    r = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in
                            r.integers(1, cfg.vocab, int(r.integers(3, 49)))],
                    max_new_tokens=16) for _ in range(16)]
    return eng, reqs


def serve_path(cfg, dev):
    from repro_torch import kernels

    torch.cuda.reset_peak_memory_stats()
    eng, reqs = make_serve(cfg, dev)
    ecfg = eng.ecfg
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(reqs, realtime=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    n_tok = sum(len(v["tokens"]) for v in results.values())
    check(len(results) == len(reqs), "not every request finished")
    check(all(len(results[q.rid]["tokens"]) == 16 for q in reqs),
          "a request stopped short of max_new_tokens")
    check(all(0 <= t < cfg.vocab for v in results.values()
              for t in v["tokens"]), "a token outside the vocabulary")
    check(eng.alloc.free_pages == ecfg.n_pages - 1, "pages were not returned")
    check(all(n > 0 for n in launches.values()),
          f"a kernel was never launched on the serve path: {launches}")
    s = results.stats
    print(json.dumps({"serve": dict(
        requests=len(results), tokens=n_tok, seconds=dt,
        tokens_per_s=n_tok / dt, ticks=s["ticks"],
        prefill_chunks=s["prefill_chunks"], evicted=s["evicted"],
        max_concurrent=s["max_concurrent"],
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches)}))

    # launches of one prefill (bucket 64) and one 8-slot decode step
    from repro_torch.models.lm import paged_decode_step, paged_prefill
    per_step = {}
    with torch.inference_mode():
        page_row = torch.arange(1, 9, device=dev)
        kernels.reset_launches()
        paged_prefill(cfg, eng.recipe, eng.params, eng.pools, page_row,
                      torch.ones((1, 64), dtype=torch.int64, device=dev), 48)
        per_step["prefill_bucket64"] = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        paged_decode_step(cfg, eng.recipe, eng.params, eng.pools,
                          page_row.repeat(8, 1),
                          torch.ones((8, 1), dtype=torch.int64, device=dev),
                          torch.full((8,), 48, device=dev),
                          torch.ones((8,), dtype=torch.bool, device=dev))
        per_step["decode_step_b8"] = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    print(json.dumps({"launches_per_step": per_step}))
    del eng
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 4: the GPU path against the CPU path at reduced() size.
# ---------------------------------------------------------------------------
def gpu_vs_cpu(dev):
    from repro_torch.configs import get_arch
    from repro_torch.core.recipes import get_recipe
    from repro_torch.models.lm import (init_params, paged_decode_step,
                                       paged_prefill)
    from repro_torch.serve.paged_kv import init_paged_cache
    from repro_torch.serve.w8 import quantize_params_for_serving
    from repro_torch.weights import params_to

    cfg = get_arch("qwen3_moe_235b").reduced()
    recipe = get_recipe("fp8_flow")
    params_cpu = quantize_params_for_serving(
        init_params(cfg, seed=0, device="cpu"))
    prompt = torch.from_numpy(
        np.random.default_rng(2).integers(1, cfg.vocab, 10))
    out = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        params = params_to(params_cpu, d)
        pools = init_paged_cache(cfg, 16, 8, fp8_kv=True, device=d)
        row = torch.tensor([1, 2, 0, 0], device=d)
        toks = torch.zeros((1, 16), dtype=torch.int64, device=d)
        toks[0, :9] = prompt[:9].to(d)
        with torch.inference_mode():
            lp = paged_prefill(cfg, recipe, params, pools, row, toks, 9)
            ld = paged_decode_step(
                cfg, recipe, params, pools, row[None].repeat(2, 1),
                torch.tensor([[int(prompt[9])], [0]], device=d),
                torch.tensor([9, 0], device=d),
                torch.tensor([True, False], device=d))
        out[name] = (lp[0, -1].float().cpu(), ld[0, -1].float().cpu())
    cos = [torch.nn.functional.cosine_similarity(a, b, dim=0).item()
           for a, b in zip(out["cuda"], out["cpu"])]
    same = [int(a.argmax()) == int(b.argmax())
            for a, b in zip(out["cuda"], out["cpu"])]
    print(json.dumps({"gpu_vs_cpu": dict(config="qwen3_moe_235b.reduced()",
                                         cosine=cos, same_argmax=same)}))
    check(min(cos) >= 0.999, f"GPU path vs CPU path cosine {cos} < 0.999")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    # plain twins and yardsticks in full f32 (no TF32), stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    name = torch.cuda.get_device_name(0)
    check("H100" in name and ("HBM3" in name or "SXM" in name),
          f"{name}: the bounds use the H100 SXM's peaks; not that card")
    print(f"[card] {name}; bounds from the published H100 SXM peaks "
          f"{PEAKS}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build()
    print(f"[build] {sorted(build.SIGNATURES)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f}s")
    for lib, log in build.build_report.get("logs", {}).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {lib}] {line.strip()}")

    cfg = serve_config()
    timings = kernel_checks(cfg, PEAKS, dev)
    launches = serve_path(cfg, dev)
    gpu_vs_cpu(dev)

    from repro_torch.kernels import (fused_permute_pad, fused_swiglu_quant,
                                     grouped_gemm_fp8, quantize)
    modules = {"quantize_rowwise": quantize,
               "fused_permute_pad": fused_permute_pad,
               "grouped_gemm_fp8": grouped_gemm_fp8,
               "fused_swiglu_quant": fused_swiglu_quant}
    rows = []
    for kname in kernels.KERNELS:
        main_row = timings[kname][0]          # the first prefill shape
        rows.append(dict(
            name=kname, route="cuda", source=modules[kname].SOURCE,
            replaces=modules[kname].REPLACES, launches=launches[kname],
            max_abs_err=max(r["max_abs_err"] for r in timings[kname]),
            ms=main_row["kernel_ms"], call_ms=main_row["call_ms"],
            plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shape=main_row["shape"],
            by_shape=[{k: r[k] for k in ("shape", "kernel_ms", "call_ms",
                                         "plain_ms", "library_ms", "bound_ms",
                                         "bound_by", "max_abs_err")}
                      for r in timings[kname]]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
