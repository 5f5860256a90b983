#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs one card

Phases (any failure raises and the script exits non-zero):
  1. card + build: the card's name and power limit (nvidia-smi), then the
     CUDA kernels built from src/repro_torch/csrc for sm_90a (one nvcc a
     source, all started together);
  2. kernels vs plain: each kernel against its plain PyTorch twin on the
     card at the serving path's full-width shapes (qwen3_moe_235b: bucket
     64 prefill, 8-slot decode), to the tolerances of the CPU tests, with
     device times (CUDA graph replays), the wrapper's call time, the bound
     of the H100 SXM and a library yardstick;
  3. the serve path: a ServeEngine over qwen3_moe_235b at full width, depth
     cut to 4 layers, random W8 weights from a seed, FP8 paged KV, serving
     16 greedy requests; every kernel of the path launched, no other;
     3b. the same engine, trace and seed with the masked recipe
     (masked_experts + the fused SwiGLU GEMM-1 epilogue): exactly the
     padded pass's tokens, through #5 and #7 and never #3 or #8; its plans
     (masked_m of a bucket-64 prefill and of a decode step) are kept;
     2b. #7 and #5 on the dispatch layouts of those plans: against their
     twins (GEMM rtol=atol=2e-2; #7 equal scales, codes within one on
     < 1% of lanes) and bit for bit against #3 then #8 / #3, each timed
     beside its padded counterpart, with the live-tile share;
  4. GPU path vs CPU path: at reduced() size, one prefill + decode step on
     the card (kernels) and on the CPU (plain twins), logits cosine >=
     0.999, for the padded and the masked recipe;
  5. all seven padded kernels vs plain at the train path's full-width
     shapes (2048 tokens, 128 experts x 256 rows): quantize (entry,
     backward island, dact_quant) and permute+pad (send, grouping, the
     backward gather by the inverse map) bitwise, SwiGLU+quantize (equal
     scales, codes within one on < 1% of lanes), the scaling-aware
     transpose (bitwise), GEMM-1/GEMM-2, the NT Wgrad GEMMs and the
     transposed-weight Dgrad-2 GEMM (rtol=atol=2e-2), the quant-out
     Dgrad-1 GEMM (equal scales, payload codes within one on < 0.1% of
     lanes), with the same timings as phase 2;
  6. the train path: qwen3_moe_235b at full width, depth cut to 1 layer,
     random bf16 params from a seed, AdamW (lr 1e-3 after the reference
     make_train_step's default 100-step warmup), one fixed batch of
     2 x 1024 tokens for 4 steps: finite and falling loss, 2 activation
     casts per MoE layer per step, every kernel of the path launched and
     no other; tokens/s, ms a step and peak device memory;
     6b. the padded run's state freed, the same from the same seed with
     the masked recipe: every step's loss the padded run's bit for bit,
     through #5, #6, #7 and #11 and never #3, #4, #8 or #10; its first
     step's plan is kept;
     5b. the four masked kernels on the dispatch layout of that plan at
     the train step's shapes (#7 GEMM-1; #5 GEMM-2, the h recompute,
     Dgrad-2; #6 Dgrad-1; #11 Wgrad-1 and -2), to the tolerances of
     phase 5 against their twins and bit for bit against their padded
     kernels, timed beside them;
  7. GPU path vs CPU path for reduced() training from the same params and
     batch (8 x 64 tokens), padded and masked: every leaf's gradient
     cosine >= 0.999 (the expert weights' and the router's, nonzero,
     included), the first step's loss within 1e-3 relative and global
     grad norm within 1%, the second step's loss (after the first update)
     within 1e-3 relative;
  8. the {"kernels": [...]} summary line (all eleven), then the result
     line.
It imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
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


# the kernels each path runs; every other kernel must stay at 0 launches
# in that path's run
PATH_KERNELS = {
    "serve": ("quantize_rowwise", "fused_permute_pad", "grouped_gemm_fp8",
              "fused_swiglu_quant"),
    "masked_serve": ("quantize_rowwise", "fused_permute_pad",
                     "masked_grouped_gemm_fp8",
                     "masked_grouped_gemm_swiglu_quant"),
    "train": ("quantize_rowwise", "fused_permute_pad", "grouped_gemm_fp8",
              "fused_swiglu_quant", "fp8_transpose", "grouped_gemm_nt_fp8",
              "grouped_gemm_fp8_quant_out"),
    "masked_train": ("quantize_rowwise", "fused_permute_pad",
                     "fp8_transpose", "masked_grouped_gemm_fp8",
                     "masked_grouped_gemm_fp8_quant_out",
                     "masked_grouped_gemm_swiglu_quant",
                     "masked_grouped_gemm_nt_fp8"),
}


def recipe_for(masked: bool):
    """The padded fp8_flow recipe, or the masked one with the fused SwiGLU
    GEMM-1 epilogue."""
    from repro_torch.core.recipes import get_recipe
    if masked:
        return get_recipe("fp8_flow", masked_experts=True,
                          swiglu_epilogue=True)
    return get_recipe("fp8_flow")


def check_launches(path, launches):
    """Every kernel of the path launched, every other one never."""
    run = PATH_KERNELS[path]
    check(all(launches[k] > 0 for k in run),
          f"a kernel of the {path} path was never launched: {launches}")
    check(all(n == 0 for k, n in launches.items() if k not in run),
          f"the {path} path launched a kernel not its own: {launches}")


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


def timing_row(peaks, name, shape, kfn, pfn, lfn, nbytes, ops, peak_ops, err,
               extra, plain_target_ms=25.0):
    """Time kernel `kfn`, twin `pfn` and library call `lfn` (or None) on the
    same inputs; print and return the row."""
    b, by = bound(nbytes, ops, peak_ops, peaks)
    row = dict(kernel=name, shape=shape, kernel_ms=time_ms(kfn),
               call_ms=call_ms(kfn),
               plain_ms=time_ms(pfn, target_ms=plain_target_ms),
               library_ms=time_ms(lfn) if lfn else None, bound_ms=b,
               bound_by=by, max_abs_err=err, **extra)
    print(json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# Each kernel against its twin on given inputs, timed (phases 2 and 5).
# ---------------------------------------------------------------------------
GEMM_LIBRARY = ("torch.bmm on bf16-dequantized operands (nearest yardstick; "
                "not the same function)")


def check_quantize(record, shape, x):
    """quantize_rowwise on (M, K) x: bitwise its twin."""
    from repro_torch.kernels import quantize
    M, K = x.shape
    d, s = quantize.quantize_rowwise_cuda(x)
    dp, sp = quantize.quantize_rowwise_plain(x)
    check(torch.equal(d.view(torch.uint8), dp.view(torch.uint8))
          and torch.equal(s, sp), f"quantize {shape}: not bitwise")
    record("quantize_rowwise", f"{shape} ({M},{K}) {str(x.dtype)[6:]}",
           lambda: quantize.quantize_rowwise_cuda(x),
           lambda: quantize.quantize_rowwise_plain(x), None,
           M * K * x.element_size() + M * K + M * K // 128 * 4, 4 * M * K,
           record.peaks["f32"], (dq(d, s) - dq(dp, sp)).abs().max().item(),
           {"tolerance": "bitwise"})


def check_permute(record, shape, x, s, row_map):
    """fused_permute_pad of e4m3 rows x (+ scales s) by row_map: bitwise."""
    from repro_torch.kernels import fused_permute_pad as fpp
    row_map = row_map.to(torch.int32).contiguous()
    xo, so = fpp.fused_permute_pad_cuda(x, s, row_map)
    xp, sp = fpp.fused_permute_pad_plain(x, s, row_map)
    check(torch.equal(xo.view(torch.uint8), xp.view(torch.uint8))
          and torch.equal(so, sp), f"permute_pad {shape}: not bitwise")
    (T, D), n_out = x.shape, row_map.numel()
    live = int((row_map >= 0).sum())
    # bytes: each distinct source row read once (the send layout reads a
    # token's row for each of its top-k slots), the map, the output
    distinct = int(torch.unique(row_map[row_map >= 0]).numel())
    row_bytes = D + D // 128 * 4
    record("fused_permute_pad", f"{shape} ({T},{D})->({n_out},{D})",
           lambda: fpp.fused_permute_pad_cuda(x, s, row_map),
           lambda: fpp.fused_permute_pad_plain(x, s, row_map), None,
           distinct * row_bytes + n_out * (row_bytes + 4), 0,
           record.peaks["f32"],
           (dq(xo, so) - dq(xp, sp)).abs().max().item(),
           {"tolerance": "bitwise", "live_rows": live,
            "distinct_source_rows": distinct})


def check_swiglu(record, shape, h):
    """fused_swiglu_quant on (M, 2F) bf16 h: scales equal, payload codes
    within one on < 1% of lanes (the sigmoid's last bits)."""
    from repro_torch.kernels import fused_swiglu_quant as fsq
    M, F2 = h.shape
    F = F2 // 2
    d, s = fsq.fused_swiglu_quant_cuda(h)
    dp, sp = fsq.fused_swiglu_quant_plain(h)
    check(torch.equal(s, sp), f"swiglu {shape}: scales differ")
    frac = codes_within_one(d, dp, 0.01, f"swiglu {shape}")
    record("fused_swiglu_quant", f"{shape} ({M},{F2}) bf16",
           lambda: fsq.fused_swiglu_quant_cuda(h),
           lambda: fsq.fused_swiglu_quant_plain(h), None,
           M * F2 * 2 + M * F + M * F // 128 * 4, 8 * M * F,
           record.peaks["f32"],
           (dq(d, s) - dq(dp, sp)).abs().max().item(),
           {"tolerance": "scales equal, payload codes within 1 on < 1% of "
                         "lanes (sigmoid bits)", "mismatch_frac": frac})


def codes_within_one(a, b, max_frac, what):
    """Fraction of e4m3 codes of `a` that differ from `b`; fails unless it
    is below max_frac and every difference is one step of the code."""
    ua, ub = a.view(torch.uint8), b.view(torch.uint8)
    oa = torch.where(ua >= 128, -(ua.int() & 127), ua.int())
    ob = torch.where(ub >= 128, -(ub.int() & 127), ub.int())
    frac = (ua != ub).float().mean().item()
    check(frac < max_frac and (oa - ob).abs().max().item() <= 1,
          f"{what}: {frac} of payload codes differ (not below {max_frac}, "
          "or by more than one)")
    return frac


def check_gemm(record, shape, x, sx, qw, w_trans=False,
               quant_out=False):
    """grouped_gemm_fp8 of x (E, C, K) e4m3 + row scales by the
    block-quantized qw, stored (E, K, N) or, with w_trans, (E, N, K) and
    read transposed: bf16 out within rtol=atol=2e-2, or (quant_out) equal
    scales and payload codes within one on < 0.1% of lanes."""
    from repro_torch.core.quant import QTensor, _dequantize_nocount
    from repro_torch.kernels import grouped_gemm_fp8 as gg
    E, C, K = x.shape
    N = qw.data.shape[1] if w_trans else qw.data.shape[2]
    args = (x, sx, qw.data, qw.scale)
    kw = dict(w_trans=w_trans, quant_out=quant_out)
    out = gg.grouped_gemm_fp8_cuda(*args, **kw)
    ref = gg.grouped_gemm_fp8_plain(*args, **kw)
    if quant_out:
        check(torch.equal(out[1], ref[1]), f"gemm {shape}: scales differ")
        extra = {"tolerance": "scales equal, payload codes within 1 on "
                              "< 0.1% of lanes",
                 "mismatch_frac": codes_within_one(out[0], ref[0], 1e-3,
                                                   f"gemm {shape}")}
        err = (_dequantize_nocount(QTensor(*out, (1, 1, 128)), torch.float32)
               - _dequantize_nocount(QTensor(*ref, (1, 1, 128)),
                                     torch.float32)).abs().max().item()
        name = "grouped_gemm_fp8_quant_out"
        out_bytes = E * C * N * (1 + 4 / 128)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2, msg=f"grouped_gemm {shape}")
        extra = {"tolerance": "rtol=atol=2e-2"}
        err = (out.float() - ref.float()).abs().max().item()
        name, out_bytes = "grouped_gemm_fp8", E * C * N * 2
    del out, ref
    xb = _dequantize_nocount(QTensor(x, sx, (1, 1, 128)), torch.bfloat16)
    wb = _dequantize_nocount(qw, torch.bfloat16)
    wb = wb.transpose(1, 2) if w_trans else wb
    wshape = f"({E},{N},{K})^T" if w_trans else f"({E},{K},{N})"
    record(name, f"{shape} ({E},{C},{K})x{wshape}",
           lambda: gg.grouped_gemm_fp8_cuda(*args, **kw),
           lambda: gg.grouped_gemm_fp8_plain(*args, **kw),
           lambda: torch.bmm(xb, wb),
           E * C * K * (1 + 4 / 128) + E * K * N
           + E * (K // 128) * (N // 128) * 4 + out_bytes,
           2 * E * C * K * N, record.peaks["fp8"], err,
           {**extra, "library": GEMM_LIBRARY}, plain_target_ms=50)
    del xb, wb
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The masked kernels against their twins and their padded counterparts, on
# the dispatch layout of a plan's masked_m (phases 2b and 5b).
# ---------------------------------------------------------------------------
MASKED_LIBRARY = ("torch.bmm on the bf16-dequantized operands of the live "
                  "experts, rows (or tokens) cut to the largest live count "
                  "(nearest yardstick; not the same function)")


def live_stats(mm, C):
    """What a plan's masked_m leaves live in a capacity of C rows (host
    reads, outside every path): live rows, experts, 128-row groups."""
    mmc = mm.clamp(0, C).long()
    groups = (C + 127) // 128
    live_groups = int(((mmc + 127) // 128).sum())
    return dict(live_rows=int(mmc.sum()), live_experts=int((mmc > 0).sum()),
                live_tile_share=live_groups / (mm.numel() * groups),
                max_live=int(mmc.max()))


def dispatch_rows(gen, dev, mm, C, K):
    """(E, C, K) e4m3 + row scales from random bf16 rows, the rows at or
    beyond masked_m[e] zero (payload 0, scale 1.0): the dispatch layout."""
    from repro_torch.kernels import quantize
    E = mm.numel()
    x = torch.randn((E, C, K), generator=gen, device=dev, dtype=torch.bfloat16)
    live = torch.arange(C, device=dev)[None, :] < mm[:, None]
    d, s = quantize.quantize_rowwise_cuda(
        torch.where(live[..., None], x, 0).reshape(E * C, K))
    return d.reshape(E, C, K), s.reshape(E, C, K // 128)


def dispatch_cols(gen, dev, mm, M, C):
    """(E, M, C) e4m3 + row scales over C with the token columns at or
    beyond masked_m[e] zero: a Wgrad operand as the transpose of the
    dispatch layout gives it."""
    from repro_torch.kernels import quantize
    E = mm.numel()
    x = torch.randn((E, M, C), generator=gen, device=dev, dtype=torch.bfloat16)
    live = torch.arange(C, device=dev)[None, None, :] < mm[:, None, None]
    d, s = quantize.quantize_rowwise_cuda(
        torch.where(live, x, 0).reshape(E * M, C))
    return d.reshape(E, M, C), s.reshape(E, M, C // 128)


def live_bf16(d, s, idx, rows=None, tile=(1, 1, 128)):
    """bf16-dequantized (E, R, K) operand of the live experts idx, rows cut
    to `rows` (row-tiled operands), for the library yardstick."""
    from repro_torch.core.quant import QTensor, _dequantize_nocount
    d, s = d[idx], s[idx]
    if rows is not None:
        d, s = d[:, :rows].contiguous(), s[:, :rows].contiguous()
    return _dequantize_nocount(QTensor(d, s, tile), torch.bfloat16)


def check_masked_gemm(record, shape, x, sx, qw, mm, w_trans=False,
                      quant_out=False):
    """#5 (bf16 out) or #6 (quant_out) on the dispatch layout of mm: within
    the tolerances of check_gemm of its twin, and bit for bit the padded
    kernel (#3 / #4) on the same inputs, which is timed beside it."""
    from repro_torch.core.quant import QTensor, _dequantize_nocount
    from repro_torch.kernels import grouped_gemm_fp8 as gg
    E, C, K = x.shape
    N = qw.data.shape[1] if w_trans else qw.data.shape[2]
    args = (x, sx, qw.data, qw.scale)
    kw = dict(w_trans=w_trans, quant_out=quant_out)
    out = gg.masked_grouped_gemm_fp8_cuda(*args, mm, **kw)
    ref = gg.masked_grouped_gemm_fp8_plain(*args, mm, **kw)
    pad = gg.grouped_gemm_fp8_cuda(*args, **kw)
    if quant_out:
        check(torch.equal(out[1], ref[1]), f"masked gemm {shape}: scales "
              "differ from the twin")
        check(torch.equal(out[0].view(torch.uint8), pad[0].view(torch.uint8))
              and torch.equal(out[1], pad[1]),
              f"masked gemm {shape}: not bitwise the padded kernel")
        extra = {"tolerance": "scales equal, payload codes within 1 on "
                              "< 0.1% of lanes; bitwise the padded kernel",
                 "mismatch_frac": codes_within_one(out[0], ref[0], 1e-3,
                                                   f"masked gemm {shape}")}
        err = (_dequantize_nocount(QTensor(*out, (1, 1, 128)), torch.float32)
               - _dequantize_nocount(QTensor(*ref, (1, 1, 128)),
                                     torch.float32)).abs().max().item()
        name = "masked_grouped_gemm_fp8_quant_out"
        out_bytes = E * C * N * (1 + 4 / 128)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2, msg=f"masked gemm {shape}")
        check(torch.equal(out.view(torch.int16), pad.view(torch.int16)),
              f"masked gemm {shape}: not bitwise the padded kernel")
        extra = {"tolerance": "rtol=atol=2e-2; bitwise the padded kernel"}
        err = (out.float() - ref.float()).abs().max().item()
        name, out_bytes = "masked_grouped_gemm_fp8", E * C * N * 2
    del out, ref, pad
    st = live_stats(mm, C)
    idx = torch.nonzero(mm > 0).squeeze(1)
    xb = live_bf16(x, sx, idx, st["max_live"])
    wb = live_bf16(qw.data, qw.scale, idx, tile=qw.tile)
    wb = wb.transpose(1, 2) if w_trans else wb
    wshape = f"({E},{N},{K})^T" if w_trans else f"({E},{K},{N})"
    record(name, f"{shape} ({E},{C},{K})x{wshape}",
           lambda: gg.masked_grouped_gemm_fp8_cuda(*args, mm, **kw),
           lambda: gg.masked_grouped_gemm_fp8_plain(*args, mm, **kw),
           lambda: torch.bmm(xb, wb),
           st["live_rows"] * K * (1 + 4 / 128)
           + st["live_experts"] * (K * N + (K // 128) * (N // 128) * 4)
           + out_bytes,
           2 * st["live_rows"] * K * N, record.peaks["fp8"], err,
           {**extra, **st, "library": MASKED_LIBRARY,
            "padded_ms": time_ms(lambda: gg.grouped_gemm_fp8_cuda(*args,
                                                                   **kw))},
           plain_target_ms=50)
    del xb, wb
    torch.cuda.empty_cache()


def check_masked_swiglu(record, shape, x, sx, qw13, mm):
    """#7 on the dispatch layout of mm: equal scales and payload codes
    within one on < 1% of lanes against its twin (the sigmoid's last
    bits), and bit for bit #3 (bf16 h) then #8, which is timed beside it."""
    from repro_torch.kernels import fused_swiglu_quant as fsq
    from repro_torch.kernels import grouped_gemm_fp8 as gg
    from repro_torch.kernels import grouped_gemm_swiglu_quant as gsq
    E, C, K = x.shape
    F = qw13.data.shape[2] // 2
    args = (x, sx, qw13.data, qw13.scale)
    d, s = gsq.masked_grouped_gemm_swiglu_quant_cuda(*args, mm)
    dp, sp = gsq.masked_grouped_gemm_swiglu_quant_plain(*args, mm)

    def pair():
        h = gg.grouped_gemm_fp8_cuda(*args)
        return fsq.fused_swiglu_quant_cuda(h.reshape(E * C, 2 * F))

    du, su = pair()
    check(torch.equal(s, sp), f"swiglu epilogue {shape}: scales differ")
    frac = codes_within_one(d, dp, 0.01, f"swiglu epilogue {shape}")
    check(torch.equal(d.view(torch.uint8),
                      du.view(torch.uint8).reshape(E, C, F))
          and torch.equal(s, su.reshape(E, C, F // 128)),
          f"swiglu epilogue {shape}: not bitwise the GEMM + SwiGLU pair")
    err = (dq(d.reshape(E * C, F), s.reshape(E * C, -1))
           - dq(dp.reshape(E * C, F), sp.reshape(E * C, -1))
           ).abs().max().item()
    del d, s, dp, sp, du, su
    st = live_stats(mm, C)
    idx = torch.nonzero(mm > 0).squeeze(1)
    xb = live_bf16(x, sx, idx, st["max_live"])
    wb = live_bf16(qw13.data, qw13.scale, idx, tile=qw13.tile)
    record("masked_grouped_gemm_swiglu_quant",
           f"{shape} ({E},{C},{K})x({E},{K},{2 * F})->({E},{C},{F}) e4m3",
           lambda: gsq.masked_grouped_gemm_swiglu_quant_cuda(*args, mm),
           lambda: gsq.masked_grouped_gemm_swiglu_quant_plain(*args, mm),
           lambda: torch.bmm(xb, wb),
           st["live_rows"] * K * (1 + 4 / 128)
           + st["live_experts"] * (K * 2 * F + (K // 128) * (2 * F // 128) * 4)
           + E * C * F * (1 + 4 / 128),
           2 * st["live_rows"] * K * 2 * F, record.peaks["fp8"], err,
           {"tolerance": "scales equal, payload codes within 1 on < 1% of "
                         "lanes (sigmoid bits); bitwise GEMM then SwiGLU",
            "mismatch_frac": frac, **st,
            "library": MASKED_LIBRARY + "; the GEMM only",
            "padded_ms": time_ms(pair)}, plain_target_ms=50)
    del xb, wb
    torch.cuda.empty_cache()


def check_masked_nt(record, shape, a, sa, b, sb, mm):
    """#11 (bf16 out) with the dead token columns zero: rtol=atol=2e-2
    against its twin and bit for bit the padded #10, timed beside it."""
    from repro_torch.kernels import grouped_gemm_nt_fp8 as nt
    E, M, C = a.shape
    N = b.shape[1]
    bf16 = torch.bfloat16
    args = (a, sa, b, sb)
    out = nt.masked_grouped_gemm_nt_fp8_cuda(*args, mm, bf16)
    ref = nt.masked_grouped_gemm_nt_fp8_plain(*args, mm, bf16)
    pad = nt.grouped_gemm_nt_fp8_cuda(*args, bf16)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2,
                               msg=f"masked gemm_nt {shape}")
    check(torch.equal(out.view(torch.int16), pad.view(torch.int16)),
          f"masked gemm_nt {shape}: not bitwise the padded kernel")
    err = (out.float() - ref.float()).abs().max().item()
    del out, ref, pad
    st = live_stats(mm, C)
    mmc = mm.clamp(0, C).long()
    steps = int(((mmc + 127) // 128).sum())
    idx = torch.nonzero(mm > 0).squeeze(1)
    cl = st["max_live"]
    ab = live_bf16(a, sa, idx)[:, :, :cl].contiguous()
    bb = live_bf16(b, sb, idx)[:, :, :cl].transpose(1, 2).contiguous()
    record("masked_grouped_gemm_nt_fp8",
           f"{shape} ({E},{M},{C})x({E},{N},{C})^T bf16 out",
           lambda: nt.masked_grouped_gemm_nt_fp8_cuda(*args, mm, bf16),
           lambda: nt.masked_grouped_gemm_nt_fp8_plain(*args, mm, bf16),
           lambda: torch.bmm(ab, bb),
           (M + N) * (st["live_rows"] + steps * 4) + E * M * N * 2,
           2 * M * N * st["live_rows"], record.peaks["fp8"], err,
           {"tolerance": "rtol=atol=2e-2; bitwise the padded kernel",
            **st, "live_token_steps": steps, "library": MASKED_LIBRARY,
            "padded_ms": time_ms(lambda: nt.grouped_gemm_nt_fp8_cuda(
                *args, bf16))}, plain_target_ms=50)
    del ab, bb
    torch.cuda.empty_cache()


def add_rows(timings, rows):
    for kname, rs in rows.items():
        timings.setdefault(kname, []).extend(rs)


class KernelRows:
    """Collects the timed rows of phases 2 and 5 by kernel name."""

    def __init__(self, peaks):
        self.peaks, self.rows = peaks, {}

    def __call__(self, *args, **kw):
        row = timing_row(self.peaks, *args, **kw)
        self.rows.setdefault(row["kernel"], []).append(row)


def rowq(gen, dev, M, K, spread=0.0):
    """(M, K) e4m3 + (M, K/128) scales quantized from a random bf16 tensor
    (with `spread`, row magnitudes vary over 2**+-6, so the transpose's
    rebasing reaches the subnormal range)."""
    from repro_torch.kernels import quantize
    x = torch.randn((M, K), generator=gen, device=dev, dtype=torch.bfloat16)
    if spread:
        x = x * torch.exp2(torch.randint(
            -6, 7, (M, 1), generator=gen, device=dev)).to(x.dtype)
    return quantize.quantize_rowwise_cuda(x)


def blockq(gen, dev, *shape):
    from repro_torch.core.quant import quantize_blockwise
    return quantize_blockwise(torch.randn(
        shape, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its twin at the serving shapes.
# ---------------------------------------------------------------------------
def kernel_checks(cfg, peaks, dev):
    from repro_torch.core.moe import _dispatch_plan, _expert_plan, _round_up

    gen = torch.Generator(device=dev).manual_seed(1)
    D, F, E, k = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.top_k
    T_pf, B_dec = 64, 8
    C_send = _round_up(max(int(T_pf * k * 1.25), 8), 8)          # 640
    C_exp = _round_up(max(C_send // E, 8), 128)                  # 128
    C_dec = _round_up(max(int(2.0 * B_dec * k / E), 8), 8)       # 8
    record = KernelRows(peaks)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def route(T):
        return torch.topk(randn(T, E), k, dim=-1).indices

    # -- quantize: entry quantize of a prefill bucket and of a decode batch
    for shape, M in (("prefill", T_pf), ("decode", B_dec)):
        check_quantize(record, shape, randn(M, D).to(torch.bfloat16))

    # -- permute+pad: prefill send layout, expert grouping, decode gather
    ids = route(T_pf)
    rms, slot_e, _, _ = _dispatch_plan(ids, k, 1, E, C_send)
    rme, _ = _expert_plan(slot_e, E, C_exp)
    rme_dec, _ = _expert_plan(route(B_dec).reshape(-1), E, C_dec)
    tok_dec = torch.where(rme_dec >= 0, rme_dec // k, -1)
    for shape, T, row_map in (("prefill_send", T_pf, rms),
                              ("prefill_group", C_send, rme),
                              ("decode_gather", B_dec, tok_dec)):
        check_permute(record, shape, *rowq(gen, dev, T, D), row_map)

    # -- grouped GEMM: GEMM-1 and GEMM-2 of prefill and decode
    w13 = blockq(gen, dev, E, D, 2 * F)
    w2 = blockq(gen, dev, E, F, D)
    for shape, C, qw in (("prefill_gemm1", C_exp, w13),
                         ("prefill_gemm2", C_exp, w2),
                         ("decode_gemm1", C_dec, w13),
                         ("decode_gemm2", C_dec, w2)):
        K = qw.data.shape[1]
        xd, xs = rowq(gen, dev, E * C, K)
        check_gemm(record, shape, xd.reshape(E, C, K),
                   xs.reshape(E, C, K // 128), qw)
    del w13, w2

    # -- fused SwiGLU + quantize on GEMM-1's output
    for shape, M in (("prefill", E * C_exp), ("decode", E * C_dec)):
        check_swiglu(record, shape, randn(M, 2 * F).to(torch.bfloat16))
    torch.cuda.empty_cache()
    return record.rows


# ---------------------------------------------------------------------------
# Phase 3: the serve path at full width.
# ---------------------------------------------------------------------------
def serve_config():
    """qwen3_moe_235b at full width, depth cut to 4 of 94 layers to fit
    one card and the time limit."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("qwen3_moe_235b"), n_layers=4)


def make_serve(cfg, dev, masked=False):
    """The serve path's engine (random W8 weights from seed 0, FP8 KV) and
    its trace: 16 greedy requests, prompts of 3-48 tokens, 16 new each."""
    from repro_torch.models.lm import init_params
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import Request

    ecfg = ServeConfig(max_batch=8, page_size=8, n_pages=128,
                       max_pages_per_req=8, token_budget=512,
                       prefill_buckets=(16, 32, 64), fp8_kv=True,
                       w8_weights=True, seed=0)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, recipe_for(masked),
                      init_params(cfg, seed=0, device=dev), ecfg, device=dev)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} n_layers={cfg.n_layers} d_model="
          f"{cfg.d_model} experts={cfg.n_experts} top{cfg.top_k} "
          f"vocab={cfg.vocab} masked={masked}: random W8 params + FP8 pool "
          f"in {time.perf_counter() - t0:.1f}s, kv pool "
          f"{eng.kv_bytes() / 2**20:.1f} MiB")
    r = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in
                            r.integers(1, cfg.vocab, int(r.integers(3, 49)))],
                    max_new_tokens=16) for _ in range(16)]
    return eng, reqs


@contextlib.contextmanager
def recorded_plans():
    """Keeps a device copy of every masked_m the MoE blocks compute, by
    capacity (no host read inside the path)."""
    from repro_torch.core import moe
    orig, plans = moe._masked_m_or_none, {}

    def record(recipe, row_map_exp, E_loc, C):
        mm = orig(recipe, row_map_exp, E_loc, C)
        if mm is not None:
            plans.setdefault(C, []).append(mm.clone())
        return mm

    moe._masked_m_or_none = record
    try:
        yield plans
    finally:
        moe._masked_m_or_none = orig


def pick_plan(plans):
    """Of the calls with the most rows (prefill: the largest bucket), the
    plan with the median number of live experts."""
    totals = [int(p.sum()) for p in plans]
    full = sorted((p for p, t in zip(plans, totals) if t == max(totals)),
                  key=lambda p: int((p > 0).sum()))
    return full[len(full) // 2]


def serve_path(cfg, dev, masked=False, padded_tokens=None):
    """The trace through the engine; with `masked`, the masked recipe,
    whose tokens must be padded_tokens exactly.  Returns (launches, tokens
    by request, the plans of a prefill and a decode step or None)."""
    from repro_torch import kernels

    label = "masked_serve" if masked else "serve"
    torch.cuda.reset_peak_memory_stats()
    eng, reqs = make_serve(cfg, dev, masked)
    ecfg = eng.ecfg
    with recorded_plans() as plans:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.run(reqs, realtime=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)

    tokens = [results[q.rid]["tokens"] for q in reqs]
    n_tok = sum(len(t) for t in tokens)
    check(len(results) == len(reqs), "not every request finished")
    check(all(len(t) == 16 for t in tokens),
          "a request stopped short of max_new_tokens")
    check(all(0 <= t < cfg.vocab for ts in tokens for t in ts),
          "a token outside the vocabulary")
    check(eng.alloc.free_pages == ecfg.n_pages - 1, "pages were not returned")
    check_launches(label, launches)
    if masked:
        check(tokens == padded_tokens, "the masked serve pass generated "
              "other tokens than the padded pass")
    s = results.stats
    print(json.dumps({label: dict(
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
    print(json.dumps({f"{label}_launches_per_step": per_step}))
    del eng
    torch.cuda.empty_cache()
    picked = None
    if masked:
        C_pf, C_dec = max(plans), min(plans)       # 128 (C_exp), 8 (C_dec)
        # live experts of every MoE call, by (rows routed, live experts)
        print(json.dumps({"masked_serve_plans": {
            call: sorted((int(p.sum()), int((p > 0).sum())) for p in plans[C])
            for call, C in (("prefill", C_pf), ("decode", C_dec))}}))
        picked = {"prefill": pick_plan(plans[C_pf]),
                  "decode": pick_plan(plans[C_dec])}
    return launches, tokens, picked


def masked_serve_kernel_checks(cfg, peaks, dev, plans):
    """#7 (GEMM-1 + SwiGLU) and #5 (GEMM-2) on the dispatch layouts of the
    masked serve pass's own plans: a bucket-64 prefill (C = 128) and an
    8-slot decode step (C = 8); each against its twin and its padded
    kernel(s), timed beside them."""
    gen = torch.Generator(device=dev).manual_seed(3)
    D, F, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    record = KernelRows(peaks)
    w13 = blockq(gen, dev, E, D, 2 * F)
    w2 = blockq(gen, dev, E, F, D)
    for shape, C in (("prefill", 128), ("decode", 8)):
        mm = plans[shape]
        print(json.dumps({"masked_plan": dict(path="serve", call=shape,
                                              **live_stats(mm, C))}))
        check_masked_swiglu(record, f"{shape}_gemm1",
                            *dispatch_rows(gen, dev, mm, C, D), w13, mm)
        check_masked_gemm(record, f"{shape}_gemm2",
                          *dispatch_rows(gen, dev, mm, C, F), w2, mm)
    del w13, w2
    torch.cuda.empty_cache()
    return record.rows


# ---------------------------------------------------------------------------
# Phase 4: the GPU path against the CPU path at reduced() size.
# ---------------------------------------------------------------------------
def gpu_vs_cpu(dev, masked=False):
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import (init_params, paged_decode_step,
                                       paged_prefill)
    from repro_torch.serve.paged_kv import init_paged_cache
    from repro_torch.serve.w8 import quantize_params_for_serving
    from repro_torch.weights import params_to

    cfg = get_arch("qwen3_moe_235b").reduced()
    recipe = recipe_for(masked)
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
                                         masked=masked, cosine=cos,
                                         same_argmax=same)}))
    check(min(cos) >= 0.999, f"GPU path vs CPU path cosine {cos} < 0.999")


# ---------------------------------------------------------------------------
# Phase 5: the training path's kernels against their twins at full width.
# ---------------------------------------------------------------------------
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 1024, 4


def train_config():
    """qwen3_moe_235b at full width, depth cut to 1 of 94 layers: one
    layer plus the embedding and lm_head is 3.73 G parameters, and AdamW
    with f32 master weights and moments holds 16 bytes a parameter
    (59.7 GB); two layers would not fit one 80 GB card."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("qwen3_moe_235b"), n_layers=1)


def train_capacity(cfg) -> int:
    """Rows an expert on the train path: moe_block's C_exp at B*S tokens."""
    from repro_torch.core.moe import _round_up
    T = TRAIN_B * TRAIN_S
    C_send = _round_up(max(int(T * cfg.top_k * cfg.capacity_factor), 8), 8)
    return _round_up(max(C_send // cfg.n_experts, 8), 128)


def train_kernel_checks(cfg, peaks, dev):
    """Every kernel of the train path against its twin at the shapes one
    full-width train step gives it (T = 2048 tokens, C = 256 rows an
    expert)."""
    from repro_torch.core.moe import _dispatch_plan, _expert_plan, _round_up
    from repro_torch.kernels import fp8_transpose, grouped_gemm_nt_fp8

    gen = torch.Generator(device=dev).manual_seed(2)
    D, F, E, k = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.top_k
    T = TRAIN_B * TRAIN_S                                       # 2048
    C_send = _round_up(max(int(T * k * cfg.capacity_factor), 8), 8)
    C = train_capacity(cfg)                                     # 256
    record = KernelRows(peaks)

    def erowq(M, K, spread=0.0):
        d, s = rowq(gen, dev, E * M, K, spread)
        return d.reshape(E, M, K), s.reshape(E, M, K // 128)

    def bf(d, s):
        from repro_torch.core.quant import QTensor, _dequantize_nocount
        return _dequantize_nocount(QTensor(d, s, (1, 1, 128)), torch.bfloat16)

    # -- #1: the entry quantize, the backward island and dact_quant
    for shape, M, K in (("q_entry", T, D), ("q_bwd_island", E * C, D),
                        ("dact_quant", E * C, 2 * F)):
        check_quantize(record, shape, torch.randn(
            (M, K), generator=gen, device=dev, dtype=torch.bfloat16))

    # -- #2: the dispatch send, the expert grouping, and the backward gather
    # of the FP8 cotangent by the grouping's inverse map
    ids = torch.topk(torch.randn((T, E), generator=gen, device=dev), k,
                     dim=-1).indices
    rms, slot_e, _, _ = _dispatch_plan(ids, k, 1, E, C_send)
    rme, ret = _expert_plan(slot_e, E, C)
    for shape, M, row_map in (("train_send", T, rms),
                              ("train_group", C_send, rme),
                              ("train_bwd_inv_map", E * C, ret)):
        check_permute(record, shape, *rowq(gen, dev, M, D), row_map)

    # -- #8: SwiGLU + quantize on GEMM-1's output
    check_swiglu(record, "train", torch.randn(
        (E * C, 2 * F), generator=gen, device=dev, dtype=torch.bfloat16))

    # -- #9 the scaling-aware transpose: T(qx) and T(qa) of Wgrad-1 / -2
    for shape, K in (("T(qx)", D), ("T(qa)", F)):
        d, s = erowq(C, K, spread=1.0)
        out, so = fp8_transpose.fp8_transpose_cuda(d, s)
        pd, ps = fp8_transpose.fp8_transpose_plain(d, s)
        check(torch.equal(out.view(torch.uint8), pd.view(torch.uint8))
              and torch.equal(so, ps), f"fp8_transpose {shape}: not bitwise")
        nbytes = 2 * (E * C * K + E * C * K // 128 * 4)
        record("fp8_transpose", f"{shape} ({E},{C},{K})->({E},{K},{C})",
               lambda: fp8_transpose.fp8_transpose_cuda(d, s),
               lambda: fp8_transpose.fp8_transpose_plain(d, s),
               lambda: d.view(torch.uint8).transpose(-1, -2).contiguous(),
               nbytes, 0, peaks["fp8"], 0.0,
               {"tolerance": "bitwise",
                "library": "uint8 .transpose(-1,-2).contiguous(): a relayout "
                           "copy, not the same function"})
        del out, so, pd, ps

    # -- #10 the NT grouped GEMM: Wgrad-1 and Wgrad-2, bf16 out
    for shape, M, N in (("wgrad1", D, 2 * F), ("wgrad2", F, D)):
        a, sa = erowq(M, C)
        b, sb = erowq(N, C)
        bf16 = torch.bfloat16
        out = grouped_gemm_nt_fp8.grouped_gemm_nt_fp8_cuda(a, sa, b, sb, bf16)
        ref = grouped_gemm_nt_fp8.grouped_gemm_nt_fp8_plain(a, sa, b, sb, bf16)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2, msg=f"grouped_gemm_nt {shape}")
        err = (out.float() - ref.float()).abs().max().item()
        del out, ref
        ab, bb = bf(a, sa), bf(b, sb).transpose(1, 2)
        record("grouped_gemm_nt_fp8",
               f"{shape} ({E},{M},{C})x({E},{N},{C})^T bf16 out",
               lambda: grouped_gemm_nt_fp8.grouped_gemm_nt_fp8_cuda(
                   a, sa, b, sb, bf16),
               lambda: grouped_gemm_nt_fp8.grouped_gemm_nt_fp8_plain(
                   a, sa, b, sb, bf16),
               lambda: torch.bmm(ab, bb),
               E * (M + N) * C * (1 + 4 / 128) + E * M * N * 2,
               2 * E * M * N * C, peaks["fp8"], err,
               {"tolerance": "rtol=atol=2e-2", "library": GEMM_LIBRARY},
               plain_target_ms=50)
        del ab, bb
        torch.cuda.empty_cache()

    # -- #3 GEMM-1 (and the h recompute, same shape) and GEMM-2 at C = 256;
    # -- #4 Dgrad-1 with the quantizing epilogue, w13 read transposed;
    # -- #3 Dgrad-2 with w2 read transposed
    for shape, K, N, w_trans, quant_out in (
            ("train_gemm1", D, 2 * F, False, False),
            ("train_gemm2", F, D, False, False),
            ("dgrad1", 2 * F, D, True, True),
            ("dgrad2", D, F, True, False)):
        x, sx = erowq(C, K)
        qw = blockq(gen, dev, *((E, N, K) if w_trans else (E, K, N)))
        check_gemm(record, shape, x, sx, qw, w_trans=w_trans,
                   quant_out=quant_out)
        del x, sx, qw
    return record.rows


# ---------------------------------------------------------------------------
# Phase 6: the train path at full width.
# ---------------------------------------------------------------------------
def make_train(cfg, dev, masked=False):
    """The train path's state (random bf16 params from seed 0, AdamW at the
    reference's defaults with lr=1e-3), step function (the reference
    make_train_step's default schedule: 100 warmup steps of a cosine over
    100k) and its one fixed batch (make_batch step 0, B=2, S=1024).  With
    no warmup, lr 1e-3 overshoots at this width: the loss falls at the
    second step and rises from the third (PERF.md, section 6)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    opt = AdamWConfig(lr=1e-3)
    state = init_train_state(cfg, opt, seed=0, device=dev)
    step = make_train_step(cfg, recipe_for(masked), opt)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                  global_batch=TRAIN_B), 0, device=dev)
    return state, step, batch


def expert_grad_zero_fraction(cfg, params, batch):
    """Fraction of exactly-zero entries in the expert weights' gradients
    of one more forward+backward (the scaling-aware transpose flushes a
    128-row block that holds a padding row; ROADMAP.md, Queue 3)."""
    from repro_torch.models.lm import forward
    from repro_torch.optim.adamw import tree_leaves
    loss, _ = forward(cfg, recipe_for(False), params, batch)
    loss.backward()
    out = {}
    for name in ("we13", "we2"):
        g = params["layers"][name].grad
        nz = sum(int(torch.count_nonzero(g[:, e]))
                 for e in range(g.shape[1]))
        out[name] = 1.0 - nz / g.numel()
    for p in tree_leaves(params):
        p.grad = None
    return out


def train_path(cfg, dev, masked=False, padded_losses=None):
    """TRAIN_STEPS steps on the fixed batch; with `masked`, the masked
    recipe from the same seed, whose every loss must be padded_losses'
    bit for bit.  Returns (launches, losses, the first step's plan or
    None)."""
    from repro_torch import kernels
    from repro_torch.core import casts
    from repro_torch.optim.adamw import tree_leaves

    label = "masked_train" if masked else "train"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step, batch = make_train(cfg, dev, masked)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gib = torch.cuda.memory_allocated() / 2**30
    losses, gnorms, step_s, n_casts = [], [], [], []
    with recorded_plans() as plans:
        kernels.reset_launches()
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with casts.ledger() as led:
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            gnorms.append(float(m["grad_norm"]))
            n_casts.append(led.activation_casts())
        launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    zero_frac = None if masked else expert_grad_zero_fraction(
        cfg, state["params"], batch)
    check(all(np.isfinite(losses)), f"a non-finite train loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(all(n == 2 * cfg.n_layers for n in n_casts),
          f"activation casts per step {n_casts}, expected "
          f"{2 * cfg.n_layers} (2 per MoE layer)")
    check_launches(label, launches)
    if masked:
        check(losses == padded_losses, f"masked train losses {losses} are "
              f"not the padded run's {padded_losses} bit for bit")
    tokens = TRAIN_B * TRAIN_S
    warm = step_s[1:]
    print(json.dumps({label: dict(
        config=f"{cfg.name} n_layers={cfg.n_layers} full width",
        params=sum(p.numel() for p in tree_leaves(state["params"])),
        batch=[TRAIN_B, TRAIN_S], steps=TRAIN_STEPS, losses=losses,
        grad_norms=gnorms, step_s=step_s, init_s=init_s,
        ms_per_step_warm=1e3 * statistics.mean(warm),
        tokens_per_s_warm=tokens / statistics.mean(warm),
        activation_casts_per_step=n_casts, state_gib=state_gib,
        expert_grad_zero_fraction=zero_frac,
        max_memory_allocated_gib=peak_gib, launches=launches,
        launches_per_step_per_layer={
            k: v / (TRAIN_STEPS * cfg.n_layers) for k, v in launches.items()
        })}))
    del state, step, batch, m
    torch.cuda.empty_cache()
    plan = plans[max(plans)][0] if masked else None
    return launches, losses, plan


def masked_train_kernel_checks(cfg, peaks, dev, mm):
    """The four masked kernels at the shapes one full-width masked train
    step gives them (C = 256 rows an expert), on the dispatch layout of
    the masked train pass's own first plan: #7 GEMM-1, #5 GEMM-2, the h
    recompute and Dgrad-2 (w2 read transposed), #6 Dgrad-1 (w13 read
    transposed), #11 Wgrad-1 and Wgrad-2; each against its twin and its
    padded kernel(s), timed beside them."""
    gen = torch.Generator(device=dev).manual_seed(4)
    D, F, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    C = train_capacity(cfg)                                     # 256
    record = KernelRows(peaks)
    print(json.dumps({"masked_plan": dict(path="train", call="step 1",
                                          **live_stats(mm, C))}))
    w13 = blockq(gen, dev, E, D, 2 * F)
    check_masked_swiglu(record, "train_gemm1",
                        *dispatch_rows(gen, dev, mm, C, D), w13, mm)
    check_masked_gemm(record, "train_h_recompute",
                      *dispatch_rows(gen, dev, mm, C, D), w13, mm)
    del w13
    for shape, K, N, w_trans, quant_out in (
            ("train_gemm2", F, D, False, False),
            ("dgrad2", D, F, True, False),
            ("dgrad1", 2 * F, D, True, True)):
        qw = blockq(gen, dev, *((E, N, K) if w_trans else (E, K, N)))
        check_masked_gemm(record, shape, *dispatch_rows(gen, dev, mm, C, K),
                          qw, mm, w_trans=w_trans, quant_out=quant_out)
        del qw
    for shape, M, N in (("wgrad1", D, 2 * F), ("wgrad2", F, D)):
        check_masked_nt(record, shape, *dispatch_cols(gen, dev, mm, M, C),
                        *dispatch_cols(gen, dev, mm, N, C), mm)
    torch.cuda.empty_cache()
    return record.rows


# ---------------------------------------------------------------------------
# Phase 7: one train step on the GPU path against the CPU path (reduced).
# ---------------------------------------------------------------------------
def named_leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in named_leaves(v, f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]


def cosine(a, b):
    """Cosine of two tensors in f64 (1.0 for two zero tensors)."""
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    na, nb = a.norm().item(), b.norm().item()
    if na == 0.0 and nb == 0.0:
        return 1.0
    return (a @ b).item() / max(na * nb, 1e-300)


GRAD_COSINE_MIN = 0.999
MOE_LEAVES = ("layers/we13", "layers/we2", "layers/w_router")


def gpu_vs_cpu_train(dev, masked=False):
    """From the same params and batch on the card and on the CPU: every
    leaf's gradient (the expert weights' through the hand-written FP8
    backward), then two train steps, the second's loss depending on the
    first's update.  The batch is 8 x 64 tokens: at 4 x 64 every expert's
    128-row block holds padding rows, and the scaling-aware transpose then
    flushes all of Wgrad-1 to zero on both paths (a fault the port keeps
    from the reference; ROADMAP.md, Queue 3), so the comparison could not
    see it.  The MoE leaves' CPU gradients must be nonzero."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, make_batch_np
    from repro_torch.models.lm import forward, init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    from repro_torch.weights import params_to

    cfg = get_arch("qwen3_moe_235b").reduced()
    recipe = recipe_for(masked)
    opt = AdamWConfig(lr=1e-3)
    batch_np = make_batch_np(DataConfig(vocab=cfg.vocab, seq_len=64,
                                        global_batch=8), 0)
    out, grads = {}, {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        # the same random params on both paths (a fresh CPU draw each)
        state = init_train_state(cfg, opt, device=d, params=params_to(
            init_params(cfg, seed=0, device="cpu"), d))
        step = make_train_step(cfg, recipe, opt, total_steps=10,
                               warmup_steps=1)
        batch = {k: torch.from_numpy(v).to(d) for k, v in batch_np.items()}
        loss, _ = forward(cfg, recipe, state["params"], batch)
        loss.backward()
        grads[name] = {path: p.grad.float().cpu()
                       for path, p in named_leaves(state["params"])}
        for _, p in named_leaves(state["params"]):
            p.grad = None
        state, m1 = step(state, batch)
        state, m2 = step(state, batch)
        out[name] = (float(m1["loss"]), float(m1["grad_norm"]),
                     float(m2["loss"]))
        del state, step
    (lg, gg, lg2), (lc, gc, lc2) = out["cuda"], out["cpu"]
    rel_loss, rel_gn = abs(lg - lc) / abs(lc), abs(gg - gc) / abs(gc)
    rel_loss2 = abs(lg2 - lc2) / abs(lc2)
    cos = {path: cosine(grads["cuda"][path], grads["cpu"][path])
           for path in grads["cpu"]}
    print(json.dumps({"gpu_vs_cpu_train": dict(
        config="qwen3_moe_235b.reduced()", masked=masked, loss=[lg, lc],
        grad_norm=[gg, gc], rel_loss=rel_loss, rel_grad_norm=rel_gn,
        step2_loss=[lg2, lc2], rel_step2_loss=rel_loss2,
        grad_cosine=cos)}))
    check(np.isfinite([lg, lc, gg, gc, lg2, lc2]).all(),
          "a non-finite train step")
    check(rel_loss <= 1e-3, f"GPU vs CPU train loss rel diff {rel_loss}")
    check(rel_gn <= 1e-2, f"GPU vs CPU grad norm rel diff {rel_gn}")
    check(rel_loss2 <= 1e-3,
          f"GPU vs CPU second-step loss rel diff {rel_loss2}")
    check(set(MOE_LEAVES) <= set(cos),
          f"the expert and router leaves are missing: {sorted(cos)}")
    check(all(grads["cpu"][p].abs().max().item() > 0 for p in MOE_LEAVES),
          "a MoE leaf's gradient is zero on the CPU path")
    low = {p: c for p, c in cos.items() if not c >= GRAD_COSINE_MIN}
    check(not low, f"GPU vs CPU gradient cosine < {GRAD_COSINE_MIN}: {low}")


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
    launches = {}
    launches["serve"], tokens, _ = serve_path(cfg, dev)
    launches["masked_serve"], _, plans = serve_path(cfg, dev, masked=True,
                                                    padded_tokens=tokens)
    add_rows(timings, masked_serve_kernel_checks(cfg, PEAKS, dev, plans))
    for masked in (False, True):
        gpu_vs_cpu(dev, masked)
    tcfg = train_config()
    add_rows(timings, train_kernel_checks(tcfg, PEAKS, dev))
    launches["train"], losses, _ = train_path(tcfg, dev)
    launches["masked_train"], _, plan = train_path(
        tcfg, dev, masked=True, padded_losses=losses)
    add_rows(timings, masked_train_kernel_checks(tcfg, PEAKS, dev, plan))
    for masked in (False, True):
        gpu_vs_cpu_train(dev, masked)

    from repro_torch.kernels import (fp8_transpose, fused_permute_pad,
                                     fused_swiglu_quant, grouped_gemm_fp8,
                                     grouped_gemm_nt_fp8,
                                     grouped_gemm_swiglu_quant, quantize)
    modules = {"quantize_rowwise": quantize,
               "fused_permute_pad": fused_permute_pad,
               "grouped_gemm_fp8": grouped_gemm_fp8,
               "fused_swiglu_quant": fused_swiglu_quant,
               "fp8_transpose": fp8_transpose,
               "grouped_gemm_nt_fp8": grouped_gemm_nt_fp8,
               "grouped_gemm_fp8_quant_out": grouped_gemm_fp8,
               "masked_grouped_gemm_fp8": grouped_gemm_fp8,
               "masked_grouped_gemm_fp8_quant_out": grouped_gemm_fp8,
               "masked_grouped_gemm_swiglu_quant": grouped_gemm_swiglu_quant,
               "masked_grouped_gemm_nt_fp8": grouped_gemm_nt_fp8}
    replaces = {
        "grouped_gemm_fp8_quant_out": grouped_gemm_fp8.REPLACES_QUANT_OUT,
        "masked_grouped_gemm_fp8": grouped_gemm_fp8.REPLACES_MASKED,
        "masked_grouped_gemm_fp8_quant_out":
            grouped_gemm_fp8.REPLACES_MASKED_QUANT_OUT,
        "masked_grouped_gemm_nt_fp8": grouped_gemm_nt_fp8.REPLACES_MASKED}
    rows = []
    for kname in kernels.KERNELS:
        # the main row: the first shape of the first path that runs it
        main_row = timings[kname][0]
        main_path = next(p for p in PATH_KERNELS if kname in PATH_KERNELS[p])
        rows.append(dict(
            name=kname, route="cuda", source=modules[kname].SOURCE,
            replaces=replaces.get(kname, modules[kname].REPLACES),
            launches=launches[main_path][kname], launches_path=main_path,
            launches_by_path={p: n[kname] for p, n in launches.items()},
            max_abs_err=max(r["max_abs_err"] for r in timings[kname]),
            ms=main_row["kernel_ms"], call_ms=main_row["call_ms"],
            plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shape=main_row["shape"],
            by_shape=[{k: r.get(k) for k in (
                "shape", "kernel_ms", "call_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "max_abs_err", "padded_ms",
                "live_tile_share")} for r in timings[kname]]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
