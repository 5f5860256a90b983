#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs one card

Phases (any failure raises and the script exits non-zero):
  1. card + build: the card's name and power limit (nvidia-smi), then the
     CUDA kernels built from src/repro_torch/csrc for sm_90a (one nvcc a
     source, all started together), with ptxas's entry, register and
     spill lines for each;
  2. kernels vs plain: each kernel against its plain PyTorch twin on the
     card at the serving path's full-width shapes (qwen3_moe_235b: bucket
     64 prefill, 8-slot decode), to the tolerances of the CPU tests, with
     device times (CUDA graph replays), the wrapper's call time, the bound
     of the H100 SXM and its share reached (bound_share = bound / kernel
     time), and a library yardstick (vs_library = kernel / library time);
     first a `launch_floor_ms` line (zero_() of one element, graph-
     replayed: the card's launch floor); the permute+pad and SwiGLU rows
     (here and in phase 5) add `copy_ms`, a device copy_ of their input's
     bytes, and the floor; the SwiGLU rows add `issue`, the instruction
     issue time of its path estimated from the built library's SASS;
  3. the serve path: a ServeEngine over qwen3_moe_235b at full width, depth
     cut to 4 layers, random W8 weights from a seed, FP8 paged KV, serving
     16 greedy requests; every kernel of the path launched, no other;
     3b. the same engine, trace and seed with the masked recipe
     (masked_experts + the fused SwiGLU GEMM-1 epilogue): exactly the
     padded pass's tokens, through #5 and #7 and never #3 or #8; its plans
     (masked_m of a bucket-64 prefill and of a decode step) are kept;
     3c. the same engine, trace and seed with the bf16 recipe (bf16
     expert weights, FP8 KV): every request finished, no kernel of the
     port launched (its products are bf16 matmuls);
     2b. #7 and #5 on the dispatch layouts of those plans: against their
     twins (GEMM rtol=atol=2e-2; #7 equal scales, codes within one on
     < 1% of lanes) and bit for bit against #3 then #8 / #3, each timed
     beside its padded counterpart, with the live-tile share;
  4. GPU path vs CPU path: at reduced() size, one prefill + decode step on
     the card (kernels) and on the CPU (plain twins), logits cosine >=
     0.999, for the padded, the masked and the bf16 recipe;
  5. all seven padded kernels vs plain at the train path's full-width
     shapes (2048 tokens, 128 experts x 256 rows): quantize (entry,
     backward island, dact_quant) and permute+pad (send, grouping, the
     backward gather by the inverse map) bitwise, SwiGLU+quantize (equal
     scales, codes within one on < 1% of lanes), the scaling-aware
     transpose (bitwise at its four launches T(qx), T(qa), T(qg), T(qgh);
     the T(qx) row adds `t_phases`: its time and bitwise check with
     uniform, spread and flush-tile row scales), GEMM-1/GEMM-2, the NT
     Wgrad GEMMs and the transposed-weight Dgrad-2 GEMM (rtol=atol=2e-2;
     the NT rows add the share of bf16 lanes off the twin and an f32
     run's max |kernel - twin| / max |twin|), the quant-out Dgrad-1 GEMM
     (equal scales, payload codes within one on < 0.1% of lanes), with
     the same timings as phase 2;
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
     8. #1's linear mode bitwise its twin at every shape of the blockwise
     and naive_fp8 train steps (timed beside its bound and the po2 mode,
     `po2_ms`), #3 and #10 on linear-scale operands under their gates;
     6c. the baselines from the same seed and batch, each state freed
     before the next: bf16 (no kernel), blockwise (#1 linear, #3, #10)
     and naive_fp8 (#1 linear, #2, #3, #10), each with finite, falling
     losses, 0 / 8 / 12 activation casts per layer per step, exactly its
     kernels, ms a step, tokens/s, peak memory and the expert gradients'
     zero share;
  7. GPU path vs CPU path for reduced() training from the same params and
     batch (8 x 64 tokens), for the padded, masked, bf16, blockwise and
     naive_fp8 recipes: every leaf's gradient
     cosine >= 0.999 (the expert weights' and the router's, nonzero,
     included), the first step's loss within 1e-3 relative and global
     grad norm within 1%, the second step's loss (after the first update)
     within 1e-3 relative (a token the card routes to other experts than
     the CPU must sit at a router near-tie, and the gradients are then
     compared with the card routed as the CPU routed, when one did);
     qwen3_moe_235b's served tokens and fp8_flow losses are held to PR
     18's bits;
 10. the configs with dense layers and shared experts at full width:
     deepseek_v2_lite served at full depth (27 layers) with the padded
     and then the masked recipe (the same tokens), qwen15_05b served
     whole (24 dense layers; no kernel in decode), deepseek_v3_671b
     served at depth 4 (3 dense + 1 MoE layer); each through exactly its
     kernels (the dense and shared MLPs on the padded #1, #3, #8 in
     every recipe), with tokens/s, ticks, peak memory, tokens_sha256;
     10b. #7 and #5 on the masked deepseek_v2_lite pass's own plans, as
     phase 2b;
 11. each config's kernels at the shapes its paths give them, timed as
     phases 2 and 5: deepseek_v2_lite's and deepseek_v3_671b's bucket-64
     prefill and 8-slot decode step, qwen15_05b's prefill, and
     deepseek_v2_lite's (depth 4) and qwen15_05b's train step; the dense
     and shared MLPs as E = 1 groups (GEMMs, SwiGLU+quantize, in train
     the transposes, the NT Wgrads contracting C = 2048 tokens and the
     Dgrads), the routed experts at the path's capacity (with #2's
     layouts), #1 at each quantize; deepseek_v3_671b's routed GEMMs on
     64 of its 256 experts (the f32 twin of all 256 holds 30 GB);
 12. deepseek_v2_lite trained at depth 4 (1 dense + 3 MoE layers) and
     qwen15_05b whole, as phase 6: padded, masked (bit for bit the
     padded losses), bf16, blockwise and naive_fp8 for deepseek_v2_lite,
     fp8_flow for qwen15_05b; activation casts per step pinned per
     layer kind (a dense MLP 2 / 0 / 8 / 10, an MoE block 2 / 0 / 8 /
     12, fp8_flow / bf16 / blockwise / naive_fp8; a shared expert is a
     dense MLP); 12b. the four masked kernels on the masked
     deepseek_v2_lite step's own plan, as phase 5b;
 13. GPU path vs CPU path at reduced() size for the three: serve logits
     (fp8_flow), and train gradients and losses as phase 7, for all five
     train paths of deepseek_v2_lite and qwen15_05b and for fp8_flow of
     deepseek_v3_671b;
 14. the GeGLU and GELU configs served at full width: starcoder2_15b
     (40 layers, ungated GELU, LayerNorm, QKV bias), gemma3_4b (34
     layers, every one local by the reference's fallback for a pattern
     that does not divide the depth) and gemma2_9b (42 layers, local:
     global, softcaps) whole, grok1_314b at depth 4 (8 GeGLU experts of
     d_ff 32768) padded and then masked (the same tokens), each through
     exactly its kernels: no #7 and no #8 (the activation in plain
     PyTorch, then #1's act_quant), no #2 for a dense config; 14b. #5
     GEMM-1 and GEMM-2 on the masked grok pass's own plans (4 of its 8
     experts: GEMM_CHECK_ELEMS);
 15. each new path's kernels at its own shapes, as phase 11: the dense
     configs' bucket-64 prefill and train step, grok's prefill and decode;
 16. starcoder2_15b (4 layers), gemma3_4b (12: two whole pattern groups)
     and gemma2_9b (8) trained as phase 6 in fp8_flow, padded and then
     masked (bit for bit the padded losses), 2 casts a layer a step;
 17. GPU path vs CPU path at reduced() size (the gemmas at window 8) for
     the four: serve logits, and all five train paths as phase 7;
 18. the configs the paged engine refuses, served whole through
     serve.serve_step: mamba2_27b (64 SSD mixer layers: no kernel of the
     port), hymba_15b (32 hybrid layers), seamless_m4t_v2 (24 encoder +
     24 decoder layers; its cross cache filled from its encoder) and
     llava_next_34b (60 layers, 64 GiB of bf16 weights): make_prefill
     timed (llava's at 2 x (2880-row prefix + 192 tokens)), then 8
     requests' 16-token prompts fed through make_serve_step at one
     shared position and 16 greedy tokens, through exactly their kernels
     (#1, #3, #8 in hymba's and llava's prefill, #1 and #3 in seamless's;
     none in decode), with tokens/s, ms a step, peak memory,
     tokens_sha256;
 19. their kernels at the shapes those paths give them, as phase 11:
     hymba's, seamless's (decoder and encoder) and llava's prefill MLPs
     (llava's GEMM-1 at 6144 x 7168 x 40960) and their train steps;
 20. the four trained as phase 6 in fp8_flow at full width (mamba2 52 of
     64 layers, hymba and seamless whole, llava 4 of 60 at batch 1 with
     its prefix) and hymba in bf16: losses falling, 2 casts a dense MLP a
     step (the encoder's too), exactly their kernels;
 21. GPU path vs CPU path at reduced() size for the four: make_prefill
     and four decode steps' logits, and fp8_flow training as phase 7
     (seamless's fp8_flow gradients at the six-layer bar 0.998, its bf16
     and hymba's bf16 at 0.999);
  9. the {"kernels": [...]} summary line (the eleven kernels and #1's
     linear mode, with the new shapes' rows), then the result line.
It imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import re
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
    # the baselines: bf16 runs no kernel of the port (bf16 matmuls)
    "bf16_serve": (),
    "bf16_train": (),
    "blockwise_train": ("quantize_rowwise_linear", "grouped_gemm_fp8",
                        "grouped_gemm_nt_fp8"),
    "naive_train": ("quantize_rowwise_linear", "fused_permute_pad",
                    "grouped_gemm_fp8", "grouped_gemm_nt_fp8"),
}
# The paths of the configs with dense layers and shared experts, by the
# tag that prefixes their labels.  A dense MLP (a dense layer's, a shared
# expert's) is the expert FFN as one group with no masked_m: the masked
# recipe runs the padded #3, #4, #8 and #10 for it, as the reference does.
# qwen15_05b has no dispatch (#2), and its decode runs no kernel.
ARCH_TAGS = {"dsv2": "deepseek_v2_lite", "qwen15": "qwen15_05b",
             "dsv3": "deepseek_v3_671b"}
DENSE_MLP_KERNELS = {
    "serve": ("grouped_gemm_fp8", "fused_swiglu_quant"),
    "train": ("grouped_gemm_fp8", "fused_swiglu_quant",
              "grouped_gemm_fp8_quant_out", "grouped_gemm_nt_fp8")}
PATH_KERNELS.update({
    "dsv2_serve": PATH_KERNELS["serve"],
    "dsv2_masked_serve": PATH_KERNELS["masked_serve"]
    + DENSE_MLP_KERNELS["serve"],
    "dsv2_train": PATH_KERNELS["train"],
    "dsv2_masked_train": PATH_KERNELS["masked_train"]
    + DENSE_MLP_KERNELS["train"],
    "dsv2_bf16_train": (),
    "dsv2_blockwise_train": PATH_KERNELS["blockwise_train"],
    "dsv2_naive_train": PATH_KERNELS["naive_train"],
    "qwen15_serve": ("quantize_rowwise",) + DENSE_MLP_KERNELS["serve"],
    "qwen15_train": ("quantize_rowwise", "fp8_transpose")
    + DENSE_MLP_KERNELS["train"],
    "dsv3_serve": PATH_KERNELS["serve"],
})
# The GeGLU and GELU configs: the activation runs in plain PyTorch and #1
# quantizes it (``act_quant``; in train also ``dact_quant``), so no #7 and
# no #8 run; the dense ones (starcoder2, the gemmas) have no dispatch (#2)
# and no kernel in decode; the masked recipe runs their MLPs on the padded
# kernels, and grok's experts on #5 (GEMM-1 and GEMM-2).
ARCH_TAGS.update({"sc2": "starcoder2_15b", "g3": "gemma3_4b",
                  "g2": "gemma2_9b", "grok": "grok1_314b"})
ACT_MLP_KERNELS = {
    "serve": ("quantize_rowwise", "grouped_gemm_fp8"),
    "train": ("quantize_rowwise", "fp8_transpose", "grouped_gemm_fp8",
              "grouped_gemm_nt_fp8", "grouped_gemm_fp8_quant_out")}
for _tag in ("sc2", "g3", "g2"):
    PATH_KERNELS.update({f"{_tag}_serve": ACT_MLP_KERNELS["serve"],
                         f"{_tag}_train": ACT_MLP_KERNELS["train"],
                         f"{_tag}_masked_train": ACT_MLP_KERNELS["train"]})
PATH_KERNELS.update({
    "grok_serve": ("quantize_rowwise", "fused_permute_pad",
                   "grouped_gemm_fp8"),
    "grok_masked_serve": ("quantize_rowwise", "fused_permute_pad",
                          "masked_grouped_gemm_fp8")})

# activation casts per train step (paper Fig. 2): per MoE block (router,
# dispatch, experts, combine) and per dense MLP (a dense layer's or a
# shared expert's: the expert FFN's, plus fp8_flow's entry quantize), as
# the reference's ledger counts them (tests/test_cast_count.py)
CASTS_PER_LAYER = {"bf16": 0, "blockwise": 8, "naive_fp8": 12,
                   "fp8_flow": 2}
CASTS_PER_MLP = {"bf16": 0, "blockwise": 8, "naive_fp8": 10, "fp8_flow": 2}


def casts_per_step(cfg, name):
    """Activation casts of one train step of `cfg` with recipe `name`: its
    dense MLPs (none in mamba2's mixer-only layers; an encoder-decoder's
    encoder layers have one each) and its MoE blocks."""
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.moe else 0
    n_mlp = (cfg.n_layers - n_moe if cfg.d_ff else 0) + (
        cfg.n_enc_layers if cfg.encdec else 0)
    moe_layer = CASTS_PER_LAYER[name] + (
        CASTS_PER_MLP[name] if cfg.n_shared_experts else 0)
    return n_mlp * CASTS_PER_MLP[name] + n_moe * moe_layer


MASKED = dict(masked_experts=True, swiglu_epilogue=True)
# each path's recipe: fp8_flow padded, masked with the fused SwiGLU GEMM-1
# epilogue, or a baseline
PATH_RECIPES = {"serve": ("fp8_flow", {}),
                "masked_serve": ("fp8_flow", MASKED),
                "bf16_serve": ("bf16", {}),
                "train": ("fp8_flow", {}),
                "masked_train": ("fp8_flow", MASKED),
                "bf16_train": ("bf16", {}),
                "blockwise_train": ("blockwise", {}),
                "naive_train": ("naive_fp8", {})}


def base_label(label: str) -> str:
    """The path `label` less its config tag: "dsv2_masked_train" ->
    "masked_train"."""
    tag, _, rest = label.partition("_")
    return rest if tag in ARCH_TAGS else label


def recipe_for(label: str):
    """The recipe of the path `label`."""
    from repro_torch.core.recipes import get_recipe
    name, kw = PATH_RECIPES[base_label(label)]
    return get_recipe(name, **kw)


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
    # the share of the bound reached, and the kernel against its yardstick
    row["bound_share"] = b / row["kernel_ms"]
    row["vs_library"] = (row["kernel_ms"] / row["library_ms"]
                         if row["library_ms"] else None)
    print(json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# Each kernel against its twin on given inputs, timed (phases 2 and 5).
# ---------------------------------------------------------------------------
GEMM_LIBRARY = ("torch.bmm on bf16-dequantized operands (nearest yardstick; "
                "not the same function)")


def check_quantize(record, shape, x, scale_mode="po2"):
    """quantize_rowwise on (M, K) x, po2 or linear scales: bitwise its
    twin.  A linear row adds po2_ms, the po2 mode on the same input."""
    from repro_torch.kernels import quantize
    M, K = x.shape
    linear = scale_mode == "linear"
    plain = quantize.quantize_rowwise_linear_plain if linear else \
        quantize.quantize_rowwise_plain
    d, s = quantize.quantize_rowwise_cuda(x, scale_mode)
    dp, sp = plain(x)
    check(torch.equal(d.view(torch.uint8), dp.view(torch.uint8))
          and torch.equal(s, sp), f"quantize {scale_mode} {shape}: not "
          "bitwise")
    extra = {"tolerance": "bitwise"}
    if linear:
        extra["po2_ms"] = time_ms(lambda: quantize.quantize_rowwise_cuda(x))
    record("quantize_rowwise_linear" if linear else "quantize_rowwise",
           f"{shape} ({M},{K}) {str(x.dtype)[6:]}",
           lambda: quantize.quantize_rowwise_cuda(x, scale_mode),
           lambda: plain(x), None,
           M * K * x.element_size() + M * K + M * K // 128 * 4, 4 * M * K,
           record.peaks["f32"], (dq(d, s) - dq(dp, sp)).abs().max().item(),
           extra)


def check_transpose(record, shape, d, s, phases=False):
    """fp8_transpose of (E, M, K) e4m3 d with row scales s: bitwise its
    twin; with `phases`, the row adds t_phases."""
    from repro_torch.kernels import fp8_transpose
    E, M, K = d.shape
    out, so = fp8_transpose.fp8_transpose_cuda(d, s)
    pd, ps = fp8_transpose.fp8_transpose_plain(d, s)
    check(torch.equal(out.view(torch.uint8), pd.view(torch.uint8))
          and torch.equal(so, ps), f"fp8_transpose {shape}: not bitwise")
    del out, so, pd, ps
    record("fp8_transpose", f"{shape} ({E},{M},{K})->({E},{K},{M})",
           lambda: fp8_transpose.fp8_transpose_cuda(d, s),
           lambda: fp8_transpose.fp8_transpose_plain(d, s),
           lambda: d.view(torch.uint8).transpose(-1, -2).contiguous(),
           2 * (E * M * K + E * M * K // 128 * 4), 0, record.peaks["fp8"],
           0.0, {"tolerance": "bitwise",
                 "library": "uint8 .transpose(-1,-2).contiguous(): a "
                            "relayout copy, not the same function",
                 **(t_phases(d, s) if phases else {})})


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
            "distinct_source_rows": distinct, **copy_and_floor(record, x)})


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
                         "lanes (sigmoid bits)", "mismatch_frac": frac,
            **copy_and_floor(record, h), "issue": swiglu_issue(M, F)})


def copy_and_floor(record, x):
    """copy_ms: a device copy of a buffer the size of a kernel's input
    (`copy_`, the same bytes read and written), the rate the card reaches
    on that traffic; beside it the launch floor of this run."""
    src = x.view(torch.uint8)
    buf = torch.empty_like(src)
    ms = time_ms(lambda: buf.copy_(src))
    del buf
    return {"copy_ms": ms, "launch_floor_ms": record.floor_ms}


def launch_floor_ms(dev):
    """The graph-replayed launch floor: time_ms of zero_() on a
    one-element tensor (a kernel that moves ~0 bytes)."""
    one = torch.zeros(1, device=dev)
    return time_ms(lambda: one.zero_())


SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", re.M)


def path_length(sass, kernel):
    """Instructions a warp issues on the main path of the first function
    in cuobjdump's SASS listing `sass` whose name holds `kernel`, for a
    kernel without loops: every instruction ahead of the first subroutine
    (the lowest CALL target: the IEEE divisions' slow paths), less the NOPs
    and the closing branch to itself.  It counts the few instructions of
    each slow-path call site too, which the fast path branches around."""
    for fn in sass.split("Function : ")[1:]:
        if kernel not in fn.split(None, 1)[0]:
            continue
        code = [(int(a, 16), text.strip())
                for a, text in SASS_LINE.findall(fn)]
        calls = [int(t, 16) for _, text in code
                 for t in re.findall(r"\bCALL\S*\s+(0x[0-9a-f]+)", text)]
        end = min(calls, default=code[-1][0] + 1)
        return sum(1 for at, text in code if at < end
                   and not text.startswith("NOP")
                   and text != f"BRA {at:#x}")
    return None


def swiglu_issue(M, F):
    """#8's issue-time estimate at (M, 2F): the SASS instructions of its
    path times its warps (one for each two tiles), over the card's issue
    rate (4 schedulers a SM, one warp instruction a clock each, at the
    maximum SM clock nvidia-smi reports); the SASS is cuobjdump's listing
    of the built library."""
    from repro_torch.kernels import build
    try:
        sass = subprocess.run(
            [str(Path(build.nvcc_path()).parent / "cuobjdump"), "-sass",
             str(build.build()["swiglu_quant"])], capture_output=True,
            text=True, timeout=120, check=True).stdout
        n = path_length(sass, "swiglu_quant_kernel")
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError,
            IndexError) as e:
        return {"error": f"{type(e).__name__}: {e}"}
    if not n:
        return {"error": "swiglu_quant_kernel not found in the SASS"}
    warps = -(-(M * F // 128) // 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"path_instructions": n, "instructions_per_value": n / 8,
            "sm_clock_mhz": mhz,
            "issue_ms": warps * n / (sms * 4 * mhz * 1e6) * 1e3}


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
    prec = nt_precision(
        f"masked gemm_nt {shape}", out, ref,
        lambda dt: nt.masked_grouped_gemm_nt_fp8_cuda(*args, mm, dt),
        lambda dt: nt.masked_grouped_gemm_nt_fp8_plain(*args, mm, dt))
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
           {"tolerance": "rtol=atol=2e-2; bf16 lanes off <= "
                         f"{NT_BF16_MISMATCH_LIMIT:g}; bitwise the padded "
                         "kernel",
            **st, **prec, "live_token_steps": steps,
            "library": MASKED_LIBRARY,
            "padded_ms": time_ms(lambda: nt.grouped_gemm_nt_fp8_cuda(
                *args, bf16))}, plain_target_ms=50)
    del ab, bb
    torch.cuda.empty_cache()


# The share of an NT Wgrad kernel's bf16 lanes that may differ from its
# twin.  The f16-wgmma loop leaves 3.1e-6 off at Wgrad-1, an FP8-wgmma
# build of it 5.26e-2 (H100; PERF.md): the limit lies between, so
# FP8-level sums fail on any seed, not only where a lane leaves 2e-2.
NT_BF16_MISMATCH_LIMIT = 1e-3


def nt_precision(name, out, ref, kfn, pfn):
    """How far an NT Wgrad kernel's sums are from its twin's: the share of
    bf16 lanes of `out` (the kernel) that differ from `ref` (the twin),
    which must not pass NT_BF16_MISMATCH_LIMIT, and max |kernel - twin| /
    max |twin| of an f32-out run of kfn / pfn (called with the output
    dtype) on the same inputs."""
    frac = (out.view(torch.int16) != ref.view(torch.int16)).sum().item() \
        / out.numel()
    check(frac <= NT_BF16_MISMATCH_LIMIT,
          f"{name}: {frac:.3g} of bf16 lanes differ from the twin (limit "
          f"{NT_BF16_MISMATCH_LIMIT:g})")
    k32, t32 = kfn(torch.float32), pfn(torch.float32)
    rel = (k32.sub_(t32).abs_().max() / t32.abs().max()).item()
    del k32, t32
    torch.cuda.empty_cache()
    return {"bf16_mismatch_frac": frac, "f32_max_rel_diff": rel}


def nt_phases(a, sa, b, sb):
    """Where #10's time goes, read from the kernel itself on variants of
    its bf16 launch: with masked_m 0 for every expert (#11 then runs no
    product and stores +0 tiles: the tile walk and the output store alone),
    on the first 128 tokens (one C step: half the loads and products, the
    same store), and with an f32 output (twice the store bytes)."""
    from repro_torch.kernels import grouped_gemm_nt_fp8 as nt
    bf16 = torch.bfloat16
    zero = torch.zeros(a.shape[0], dtype=torch.int32, device=a.device)
    a1, b1 = a[:, :, :128].contiguous(), b[:, :, :128].contiguous()
    sa1, sb1 = sa[:, :, :1].contiguous(), sb[:, :, :1].contiguous()
    ms = {"store_only_ms": time_ms(lambda: nt.masked_grouped_gemm_nt_fp8_cuda(
              a, sa, b, sb, zero, bf16)),
          "one_step_ms": time_ms(lambda: nt.grouped_gemm_nt_fp8_cuda(
              a1, sa1, b1, sb1, bf16)),
          "f32_out_ms": time_ms(lambda: nt.grouped_gemm_nt_fp8_cuda(
              a, sa, b, sb, torch.float32))}
    del a1, b1, sa1, sb1
    torch.cuda.empty_cache()
    return ms


def t_phases(d, s):
    """#9 on three sets of row scales for one payload `d`: uniform (k = 0
    everywhere: every word is copied), `s` itself (rows over 2**+-6), and
    flush tiles (one row of scale 1.0 in every 128-row tile beside rows at
    2**-21..2**-17, as the train path's gradients beside a padding row:
    k = 17..21, the table and the sign-bits path).  Each bitwise against
    the twin, and timed; beside them, copy_ms: a device copy of the
    payload (`copy_`, the same bytes read and written), the rate the card
    reaches on this traffic."""
    from repro_torch.kernels import fp8_transpose as ft
    gen = torch.Generator(device=s.device).manual_seed(3)
    ex = torch.randint(-21, -16, s.shape, generator=gen, device=s.device)
    ex[:, ::128] = 0
    phases = {}
    for name, sc in (("uniform", torch.ones_like(s)), ("spread", s),
                     ("flush", torch.exp2(ex.to(torch.float32)))):
        out, so = ft.fp8_transpose_cuda(d, sc)
        pd, ps = ft.fp8_transpose_plain(d, sc)
        bitwise = (torch.equal(out.view(torch.uint8), pd.view(torch.uint8))
                   and torch.equal(so, ps))
        check(bitwise, f"fp8_transpose t_phases {name}: not bitwise")
        del out, so, pd, ps
        phases[f"{name}_ms"] = time_ms(lambda: ft.fp8_transpose_cuda(d, sc))
        phases[f"{name}_bitwise"] = bitwise
    copy = torch.empty_like(d)
    phases["copy_ms"] = time_ms(lambda: copy.copy_(d))
    del copy
    torch.cuda.empty_cache()
    return {"t_phases": phases}


def check_nt(record, shape, a, sa, b, sb, phases=True):
    """grouped_gemm_nt_fp8 (bf16 out) of a (E, M, C) and b (E, N, C), both
    row-tiled over C: rtol=atol=2e-2 against its twin and at most
    NT_BF16_MISMATCH_LIMIT of bf16 lanes off it; with `phases`, the row
    adds nt_phases."""
    from repro_torch.core.quant import QTensor, _dequantize_nocount
    from repro_torch.kernels import grouped_gemm_nt_fp8 as nt
    E, M, C = a.shape
    N = b.shape[1]
    bf16 = torch.bfloat16
    out = nt.grouped_gemm_nt_fp8_cuda(a, sa, b, sb, bf16)
    ref = nt.grouped_gemm_nt_fp8_plain(a, sa, b, sb, bf16)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2, msg=f"grouped_gemm_nt {shape}")
    err = (out.float() - ref.float()).abs().max().item()
    prec = nt_precision(
        f"grouped_gemm_nt {shape}", out, ref,
        lambda dt: nt.grouped_gemm_nt_fp8_cuda(a, sa, b, sb, dt),
        lambda dt: nt.grouped_gemm_nt_fp8_plain(a, sa, b, sb, dt))
    del out, ref

    def bf(d, s):
        return _dequantize_nocount(QTensor(d, s, (1, 1, 128)), bf16)

    ab, bb = bf(a, sa), bf(b, sb).transpose(1, 2)
    record("grouped_gemm_nt_fp8",
           f"{shape} ({E},{M},{C})x({E},{N},{C})^T bf16 out",
           lambda: nt.grouped_gemm_nt_fp8_cuda(a, sa, b, sb, bf16),
           lambda: nt.grouped_gemm_nt_fp8_plain(a, sa, b, sb, bf16),
           lambda: torch.bmm(ab, bb),
           E * (M + N) * C * (1 + 4 / 128) + E * M * N * 2,
           2 * E * M * N * C, record.peaks["fp8"], err,
           {"tolerance": "rtol=atol=2e-2; bf16 lanes off <= "
                         f"{NT_BF16_MISMATCH_LIMIT:g}",
            "library": GEMM_LIBRARY, **prec,
            **(nt_phases(a, sa, b, sb) if phases else {})},
           plain_target_ms=50)
    del ab, bb
    torch.cuda.empty_cache()


def add_rows(timings, rows):
    for kname, rs in rows.items():
        timings.setdefault(kname, []).extend(rs)


class KernelRows:
    """Collects the timed rows of phases 2 and 5 by kernel name."""

    def __init__(self, peaks, floor_ms=None):
        self.peaks, self.floor_ms, self.rows = peaks, floor_ms, {}

    def __call__(self, *args, **kw):
        row = timing_row(self.peaks, *args, **kw)
        self.rows.setdefault(row["kernel"], []).append(row)


def rowq(gen, dev, M, K, spread=0.0, scale_mode="po2"):
    """(M, K) e4m3 + (M, K/128) scales quantized from a random bf16 tensor
    (with `spread`, row magnitudes vary over 2**+-6, so the transpose's
    rebasing reaches the subnormal range)."""
    from repro_torch.kernels import quantize
    x = torch.randn((M, K), generator=gen, device=dev, dtype=torch.bfloat16)
    if spread:
        x = x * torch.exp2(torch.randint(
            -6, 7, (M, 1), generator=gen, device=dev)).to(x.dtype)
    return quantize.quantize_rowwise_cuda(x, scale_mode)


def blockq(gen, dev, *shape, scale_mode="po2"):
    from repro_torch.core.quant import quantize_blockwise
    return quantize_blockwise(torch.randn(
        shape, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02,
        scale_mode)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its twin at the serving shapes.
# ---------------------------------------------------------------------------
def kernel_checks(cfg, peaks, dev, floor_ms):
    from repro_torch.core.moe import _dispatch_plan, _expert_plan, _round_up

    gen = torch.Generator(device=dev).manual_seed(1)
    D, F, E, k = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.top_k
    T_pf, B_dec = 64, 8
    C_send = _round_up(max(int(T_pf * k * 1.25), 8), 8)          # 640
    C_exp = _round_up(max(C_send // E, 8), 128)                  # 128
    C_dec = _round_up(max(int(2.0 * B_dec * k / E), 8), 8)       # 8
    record = KernelRows(peaks, floor_ms)

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


# qwen3_moe_235b's served tokens (the 16-request trace at depth 4, random
# weights from seed 0) since PR 13 (fp8_flow) and PR 18 (bf16): the head
# and tail of their sha256, held bit for bit
SERVE_SHA256 = {"serve": ("03d9545e", "14e6"),
                "masked_serve": ("03d9545e", "14e6"),
                "bf16_serve": ("dab58147", "6c6d")}


def make_serve(cfg, dev, label="serve"):
    """The serve path's engine (random weights from seed 0: W8 for
    fp8_flow, bf16 for the bf16 recipe; FP8 KV) and its trace: 16 greedy
    requests, prompts of 3-48 tokens, 16 new each."""
    from repro_torch.models.lm import init_params
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import Request

    ecfg = ServeConfig(max_batch=8, page_size=8, n_pages=128,
                       max_pages_per_req=8, token_budget=512,
                       prefill_buckets=(16, 32, 64), fp8_kv=True,
                       w8_weights=True, seed=0)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, recipe_for(label),
                      init_params(cfg, seed=0, device=dev), ecfg, device=dev)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} n_layers={cfg.n_layers} d_model="
          f"{cfg.d_model} experts={cfg.n_experts} top{cfg.top_k} "
          f"vocab={cfg.vocab} {label}: random params + FP8 pool "
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


def serve_path(cfg, dev, label="serve", padded_tokens=None):
    """The trace through the engine with the recipe of `label`; the masked
    recipe's tokens must be padded_tokens exactly.  Returns (launches,
    tokens by request, the plans of a prefill and a decode step or
    None)."""
    from repro_torch import kernels

    masked = recipe_for(label).masked_experts
    torch.cuda.reset_peak_memory_stats()
    eng, reqs = make_serve(cfg, dev, label)
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
    sha = hashlib.sha256(json.dumps(tokens).encode()).hexdigest()
    if label in SERVE_SHA256:
        head, tail = SERVE_SHA256[label]
        check(sha.startswith(head) and sha.endswith(tail),
              f"{label}: tokens_sha256 {sha}, not {head}...{tail} as before")
    s = results.stats
    print(json.dumps({label: dict(
        config=f"{cfg.name} n_layers={cfg.n_layers} full width",
        requests=len(results), tokens=n_tok, seconds=dt,
        tokens_sha256=sha, tokens_per_s=n_tok / dt, ticks=s["ticks"],
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
    if base_label(label) == "masked_serve":
        C_pf, C_dec = max(plans), min(plans)       # 128 (C_exp), 8 (C_dec)
        # live experts of every MoE call, by (rows routed, live experts)
        print(json.dumps({f"{label}_plans": {
            call: sorted((int(p.sum()), int((p > 0).sum())) for p in plans[C])
            for call, C in (("prefill", C_pf), ("decode", C_dec))}}))
        picked = {"prefill": pick_plan(plans[C_pf]),
                  "decode": pick_plan(plans[C_dec])}
    return launches, tokens, picked


def masked_serve_kernel_checks(cfg, peaks, dev, plans, tag=""):
    """#7 (GEMM-1 + SwiGLU; #5 for another activation) and #5 (GEMM-2) on
    the dispatch layouts of the masked serve pass's own plans: a bucket-64
    prefill (C = 128) and an 8-slot decode step (C = 8); each against its
    twin and its padded kernel(s), timed beside them.  An expert stack
    past GEMM_CHECK_ELEMS is checked on its first experts (grok's 8 of
    65536-wide GEMM-1 on 4).  `tag` prefixes the rows' shapes."""
    gen = torch.Generator(device=dev).manual_seed(3)
    D, F, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    g = cfg.gate_factor
    Eg = experts_checked(E, D * g * F)
    record = KernelRows(peaks)
    w13 = blockq(gen, dev, Eg, D, g * F)
    w2 = blockq(gen, dev, Eg, F, D)
    cut = f" ({Eg} of {E} experts)" if Eg < E else ""
    for shape, C in (("prefill", 128), ("decode", 8)):
        mm = plans[shape][:Eg].contiguous()
        print(json.dumps({"masked_plan": dict(
            path=f"{tag}serve", call=shape, **live_stats(mm, C))}))
        if cfg.act == "swiglu":
            check_masked_swiglu(record, f"{tag}{shape}_gemm1{cut}",
                                *dispatch_rows(gen, dev, mm, C, D), w13, mm)
        else:
            check_masked_gemm(record, f"{tag}{shape}_gemm1{cut}",
                              *dispatch_rows(gen, dev, mm, C, D), w13, mm)
        check_masked_gemm(record, f"{tag}{shape}_gemm2{cut}",
                          *dispatch_rows(gen, dev, mm, C, F), w2, mm)
    del w13, w2
    torch.cuda.empty_cache()
    return record.rows


# ---------------------------------------------------------------------------
# Phase 4: the GPU path against the CPU path at reduced() size.
# ---------------------------------------------------------------------------
def gpu_vs_cpu(dev, label="serve", arch="qwen3_moe_235b"):
    from repro_torch.models.lm import (init_params, paged_decode_step,
                                       paged_prefill)
    from repro_torch.serve.paged_kv import init_paged_cache
    from repro_torch.serve.w8 import quantize_params_for_serving
    from repro_torch.weights import params_to

    cfg = reduced_config(arch)
    recipe = recipe_for(label)
    params_cpu = init_params(cfg, seed=0, device="cpu")
    if recipe.name == "fp8_flow":                    # the engine's W8 weights
        params_cpu = quantize_params_for_serving(params_cpu)
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
    print(json.dumps({"gpu_vs_cpu": dict(config=f"{arch}.reduced()",
                                         path=label, cosine=cos,
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


def train_kernel_checks(cfg, peaks, dev, floor_ms):
    """Every kernel of the train path against its twin at the shapes one
    full-width train step gives it (T = 2048 tokens, C = 256 rows an
    expert)."""
    from repro_torch.core.moe import _dispatch_plan, _expert_plan, _round_up

    gen = torch.Generator(device=dev).manual_seed(2)
    D, F, E, k = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.top_k
    T = TRAIN_B * TRAIN_S                                       # 2048
    C_send = _round_up(max(int(T * k * cfg.capacity_factor), 8), 8)
    C = train_capacity(cfg)                                     # 256
    record = KernelRows(peaks, floor_ms)

    def erowq(M, K, spread=0.0):
        d, s = rowq(gen, dev, E * M, K, spread)
        return d.reshape(E, M, K), s.reshape(E, M, K // 128)

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

    # -- #9 the scaling-aware transpose at its four train launches
    # (core/linear.py): Wgrad-2 takes T(qa) and T(qg), Wgrad-1 T(qx) and
    # T(qgh)
    for shape, K in (("T(qx)", D), ("T(qa)", F), ("T(qg)", D),
                     ("T(qgh)", 2 * F)):
        d, s = erowq(C, K, spread=1.0)
        check_transpose(record, shape, d, s, phases=shape == "T(qx)")
        del d, s
        torch.cuda.empty_cache()

    # -- #10 the NT grouped GEMM: Wgrad-1 and Wgrad-2, bf16 out
    for shape, M, N in (("wgrad1", D, 2 * F), ("wgrad2", F, D)):
        check_nt(record, shape, *erowq(M, C), *erowq(N, C))

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
def make_train(cfg, dev, label="train"):
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
    step = make_train_step(cfg, recipe_for(label), opt)
    B, S = TRAIN_SHAPES.get(label.partition("_")[0], (TRAIN_B, TRAIN_S))
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B), 0, device=dev)
    batch.update(stub_inputs(cfg, B, S, torch.Generator(
        device=dev).manual_seed(7), dev))
    return state, step, batch


def expert_grad_zero_fraction(cfg, recipe, params, batch):
    """Fraction of exactly-zero entries in the expert weights' gradients
    of one more forward+backward with `recipe` (fp8_flow's scaling-aware
    transpose flushes a 128-row block that holds a padding row; ROADMAP.md,
    Queue 3; experts no token reaches have zero gradients in every
    recipe)."""
    from repro_torch.models.lm import forward
    from repro_torch.optim.adamw import tree_leaves
    loss, _ = forward(cfg, recipe, params, batch)
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


# qwen3_moe_235b's fp8_flow losses on the train path (depth 1, seed 0, the
# fixed batch) as PR 18 measured them, to the six decimals PERF.md keeps
TRAIN_LOSSES = {"train": (12.851900, 12.590693, 11.596179, 8.347960)}


def train_path(cfg, dev, label="train", padded_losses=None):
    """TRAIN_STEPS steps on the fixed batch with the recipe of `label`,
    from the same seed; the masked recipe's every loss must be
    padded_losses' bit for bit.  Returns (launches, losses, the first
    step's plan or None)."""
    from repro_torch import kernels
    from repro_torch.core import casts
    from repro_torch.optim.adamw import tree_leaves

    recipe = recipe_for(label)
    masked = recipe.masked_experts
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step, batch = make_train(cfg, dev, label)
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
    zero_frac = None if masked or "we13" not in state["params"]["layers"] \
        else expert_grad_zero_fraction(cfg, recipe, state["params"], batch)
    want = casts_per_step(cfg, recipe.name)
    check(all(np.isfinite(losses)), f"a non-finite train loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(all(n == want for n in n_casts),
          f"activation casts per step {n_casts}, expected {want} "
          f"({CASTS_PER_LAYER[recipe.name]} per MoE block, "
          f"{CASTS_PER_MLP[recipe.name]} per dense MLP, {recipe.name})")
    check_launches(label, launches)
    if masked:
        check(losses == padded_losses, f"masked train losses {losses} are "
              f"not the padded run's {padded_losses} bit for bit")
    if label in TRAIN_LOSSES:
        check(all(abs(a - b) <= 5e-7 for a, b in zip(losses,
                                                      TRAIN_LOSSES[label])),
              f"{label}: losses {losses}, not {TRAIN_LOSSES[label]} as "
              "before")
    B, S = batch["tokens"].shape
    tokens = B * S
    warm = step_s[1:]
    print(json.dumps({label: dict(
        config=f"{cfg.name} n_layers={cfg.n_layers} full width",
        recipe=recipe.name,
        params=sum(p.numel() for p in tree_leaves(state["params"])),
        batch=[B, S], stub_rows={k: batch[k].shape[1] for k in (
            "prefix", "enc_input") if k in batch},
        steps=TRAIN_STEPS, losses=losses,
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
    # a dense config's masked recipe has no expert plan
    plan = plans[max(plans)][0] if base_label(label) == "masked_train" \
        and plans else None
    return launches, losses, plan


def masked_train_kernel_checks(cfg, peaks, dev, mm, tag=""):
    """The four masked kernels at the shapes one full-width masked train
    step gives them (C = 256 rows an expert), on the dispatch layout of
    the masked train pass's own first plan: #7 GEMM-1, #5 GEMM-2, the h
    recompute and Dgrad-2 (w2 read transposed), #6 Dgrad-1 (w13 read
    transposed), #11 Wgrad-1 and Wgrad-2; each against its twin and its
    padded kernel(s), timed beside them.  `tag` prefixes the rows'
    shapes."""
    gen = torch.Generator(device=dev).manual_seed(4)
    D, F, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    C = train_capacity(cfg)                                     # 256
    record = KernelRows(peaks)
    print(json.dumps({"masked_plan": dict(
        path=f"{tag}train", call="step 1", **live_stats(mm, C))}))
    w13 = blockq(gen, dev, E, D, 2 * F)
    check_masked_swiglu(record, f"{tag}train_gemm1",
                        *dispatch_rows(gen, dev, mm, C, D), w13, mm)
    check_masked_gemm(record, f"{tag}train_h_recompute",
                      *dispatch_rows(gen, dev, mm, C, D), w13, mm)
    del w13
    for shape, K, N, w_trans, quant_out in (
            ("train_gemm2", F, D, False, False),
            ("dgrad2", D, F, True, False),
            ("dgrad1", 2 * F, D, True, True)):
        qw = blockq(gen, dev, *((E, N, K) if w_trans else (E, K, N)))
        check_masked_gemm(record, f"{tag}{shape}",
                          *dispatch_rows(gen, dev, mm, C, K),
                          qw, mm, w_trans=w_trans, quant_out=quant_out)
        del qw
    for shape, M, N in (("wgrad1", D, 2 * F), ("wgrad2", F, D)):
        check_masked_nt(record, f"{tag}{shape}",
                        *dispatch_cols(gen, dev, mm, M, C),
                        *dispatch_cols(gen, dev, mm, N, C), mm)
    torch.cuda.empty_cache()
    return record.rows


# ---------------------------------------------------------------------------
# Phase 8: the baselines' kernels on linear scales at the train shapes.
# ---------------------------------------------------------------------------
def linear_kernel_checks(cfg, peaks, dev, floor_ms):
    """#1's linear mode bitwise its twin at every shape the blockwise and
    naive_fp8 train steps give it (the FFN's row-wise quantizes of x, a
    and gh, the transposed Wgrad-layout copies, bf16 or, after the naive
    transpose's f32 dequantize, f32; the naive dispatch entry), timed
    beside its bound and the po2 mode; #3 (GEMM-1, and Dgrad-1 with bf16
    out as the baselines keep it) and #10 (Wgrad-1, Wgrad-2) on
    linear-scale operands under their gates."""
    gen = torch.Generator(device=dev).manual_seed(5)
    D, F, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    T = TRAIN_B * TRAIN_S                                       # 2048
    C = train_capacity(cfg)                                     # 256
    record = KernelRows(peaks, floor_ms)
    for shape, M, K, dt in (
            ("q_gemm1_in", E * C, D, torch.bfloat16),
            ("q_gemm2_in", E * C, F, torch.bfloat16),
            ("q_bwd_dgrad1", E * C, 2 * F, torch.bfloat16),
            ("wgrad1_x^T", E * D, C, torch.bfloat16),
            ("q_transpose(qx)", E * D, C, torch.float32),
            ("wgrad1_g^T", E * 2 * F, C, torch.bfloat16),
            ("wgrad2_a^T", E * F, C, torch.bfloat16),
            ("q_transpose(qa)", E * F, C, torch.float32),
            ("naive_dispatch", T, D, torch.bfloat16)):
        check_quantize(record, shape, torch.randn(
            (M, K), generator=gen, device=dev, dtype=dt), "linear")
        torch.cuda.empty_cache()

    def erowq(M, K):
        d, s = rowq(gen, dev, E * M, K, scale_mode="linear")
        return d.reshape(E, M, K), s.reshape(E, M, K // 128)

    for shape, K, N, w_trans in (("linear_gemm1", D, 2 * F, False),
                                 ("linear_dgrad1_bf16", 2 * F, D, True)):
        qw = blockq(gen, dev, *((E, N, K) if w_trans else (E, K, N)),
                    scale_mode="linear")
        check_gemm(record, shape, *erowq(C, K), qw, w_trans=w_trans)
        del qw
    for shape, M, N in (("linear_wgrad1", D, 2 * F), ("linear_wgrad2", F, D)):
        check_nt(record, shape, *erowq(M, C), *erowq(N, C), phases=False)
    return record.rows


# ---------------------------------------------------------------------------
# Phases 10-13: the configs with dense layers and shared experts.
# ---------------------------------------------------------------------------
# Depth cuts, at 16 bytes a parameter for training (bf16 weights and grads,
# f32 AdamW moments and master weights) and, for serving, the bf16 tree
# plus the W8 experts made from it (ArchConfig.n_params):
# deepseek_v2_lite trains 1 dense + 3 MoE layers (2.27 G parameters, 36.3
# GB of state) and serves all 27 (15.8 G: 31.6 GB bf16 + 14.4 GB W8);
# deepseek_v3_671b serves its 3 dense layers + 1 MoE layer (15.4 G: 30.8
# GB bf16 + 11.3 GB W8; a second MoE layer makes 54.0 + 22.6 GB); its
# training needs the multi-GPU slice.  qwen15_05b runs whole (0.46 G).
DSV2_TRAIN_LAYERS, DSV3_SERVE_LAYERS = 4, 4
# The GeGLU and GELU configs (phases 14-17), by the same reckoning: every
# dense one serves whole (starcoder2_15b 16.0 G: 31.9 GB; gemma3_4b 3.9 G,
# every layer local by the reference's fallback, 34 % 6 != 0; gemma2_9b
# 9.2 G) and trains cut: starcoder2_15b 4 layers (2.14 G, 34 GB), gemma3_4b
# 12, two whole local:global groups (1.80 G, 29 GB), gemma2_9b 8 (2.50 G,
# 40 GB).  grok1_314b serves 4 of 64 layers (4.92 G a layer: 42.6 GB bf16
# + 19.3 GB W8, and the 12.9 GB f32 draw of one layer's we13 at init); one
# layer's training state (79 GB) does not fit one card.
TRAIN_LAYERS = {"sc2": 4, "g3": 12, "g2": 8}
GROK_SERVE_LAYERS = 4
# reduced() sets window 64, which neither the GPU-vs-CPU prompt (10
# tokens) nor its train rows (64) cross: the local:global configs are
# compared at window 8
REDUCED_CUTS = {"gemma3_4b": dict(window=8), "gemma2_9b": dict(window=8)}


def reduced_config(arch):
    """`arch`'s reduced() config for the GPU-vs-CPU phases."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch).reduced(),
                               **REDUCED_CUTS.get(arch, {}))


def arch_config(arch, n_layers=None):
    """`arch` at full width, at full depth or cut to n_layers."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


# The largest expert stack a GEMM check takes whole (elements of w13): its
# f32 twin holds 4 bytes an element.  deepseek_v3_671b's 256 routed
# experts (7.5 G) are checked on 64 of them, grok1_314b's 8 (3.2 G) on 4:
# each expert is its own tiles.
GEMM_CHECK_ELEMS = 2**31


def experts_checked(E, per_expert):
    """How many of E experts of `per_expert` weight elements a check takes:
    halved until the stack fits GEMM_CHECK_ELEMS."""
    while E > 1 and E * per_expert > GEMM_CHECK_ELEMS:
        E //= 2
    return E


def arch_kernel_checks(cfg, tag, path, peaks, dev, floor_ms, T=None):
    """Every kernel of `cfg`'s padded fp8_flow `path` at the shapes that
    path gives it, each against its twin to its gate and timed as phases
    2 and 5.  `path` is "train" (one step of TRAIN_B x TRAIN_S tokens),
    "prefill" (a bucket-64 prefill) or "decode" (an 8-slot decode step).
    The MLPs: the dense layers' and the shared experts' (E = 1 groups of
    the tokens padded to 128 rows; decode runs them as bf16 products, no
    kernel), and the routed experts at the path's capacity, C as
    core/moe.py computes it.  For each: #3 GEMM-1 and GEMM-2 and #8 (for
    GeGLU, GELU or ReLU, #1's ``act_quant`` of the activation in its
    place); in train also #1's dact quantize, #9 at its four operands,
    #10 Wgrad-1
    and Wgrad-2 (contracting C = 2048 tokens at E = 1: past the two
    cached b slots of csrc/grouped_gemm_nt_fp8.cu, which then turn over),
    #3 Dgrad-2 and #4 Dgrad-1.  Then #1's entry quantize and, for routed
    experts, #1's backward island and #2's layouts, as phases 2 and 5.
    `T` replaces the path's token count (a serve_step prefill's B x S, an
    encoder's rows); a config without an MLP (mamba2_27b) has no row."""
    from repro_torch.core.moe import _dispatch_plan, _expert_plan, _round_up

    gen = torch.Generator(device=dev).manual_seed(6)
    record = KernelRows(peaks, floor_ms)
    # dense_mlp zero-pads D to the 128-tile (hymba_15b's 1600 -> 1664)
    D, train, g = _round_up(cfg.d_model, 128), path == "train", \
        cfg.gate_factor
    if T is None:
        T = {"train": TRAIN_B * TRAIN_S, "prefill": 64, "decode": 8}[path]
    groups = []                                 # (kind, E, C, F)
    if path != "decode" and cfg.d_ff:
        if not cfg.moe or cfg.n_dense_layers:
            groups.append(("dense", 1, _round_up(T, 128), cfg.d_ff))
        if cfg.moe and cfg.n_shared_experts:
            groups.append(("shared", 1, _round_up(T, 128),
                           cfg.n_shared_experts * cfg.d_ff_expert))
    if cfg.moe:
        E, k = cfg.n_experts, cfg.top_k
        C_send = _round_up(max(int(T * k * cfg.capacity_factor), 8), 8)
        C = _round_up(max(int(2.0 * T * k / E), 8), 8) if path == "decode" \
            else _round_up(max(C_send // E, 8), 128)
        groups.append(("routed", E, C, cfg.d_ff_expert))

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def erowq(E, M, K, spread=0.0):
        d, s = rowq(gen, dev, E * M, K, spread)
        return d.reshape(E, M, K), s.reshape(E, M, K // 128)

    # -- #1: the entry quantize of the tokens, padded to 128 rows for a
    # dense MLP (dense_mlp pads first), as they are for the dispatch
    for M in sorted({C for kind, _, C, _ in groups if kind != "routed"}
                    | ({T} if cfg.moe else set())):
        check_quantize(record, f"{tag} {path} q_entry", bf16(M, D))
    for kind, E, C, F in groups:
        name = f"{tag} {path} {kind}"
        if kind == "routed":
            # -- #2: the dispatch send and the expert grouping (decode:
            # the gather of the slots' tokens), and in train the backward
            # gather by the grouping's inverse map; #1's backward island
            ids = torch.topk(torch.randn((T, E), generator=gen, device=dev),
                             k, dim=-1).indices
            if path == "decode":
                rme, _ = _expert_plan(ids.reshape(-1), E, C)
                maps = (("gather", T, torch.where(rme >= 0, rme // k, -1)),)
            else:
                rms, slot_e, _, _ = _dispatch_plan(ids, k, 1, E, C_send)
                rme, ret = _expert_plan(slot_e, E, C)
                maps = (("send", T, rms), ("group", C_send, rme)) + (
                    (("bwd_inv_map", E * C, ret),) if train else ())
            for what, M, row_map in maps:
                check_permute(record, f"{name} {what}",
                              *rowq(gen, dev, M, D), row_map)
            if train:
                check_quantize(record, f"{name} q_bwd_island",
                               bf16(E * C, D))
        if cfg.act == "swiglu":
            check_swiglu(record, name, bf16(E * C, 2 * F))
        else:
            check_quantize(record, f"{name} act_quant", bf16(E * C, F))
        if train:
            check_quantize(record, f"{name} dact_quant", bf16(E * C, g * F))
            for what, K in (("T(qx)", D), ("T(qa)", F), ("T(qg)", D),
                            ("T(qgh)", g * F)):
                d, s = erowq(E, C, K, spread=1.0)
                check_transpose(record, f"{name} {what}", d, s,
                                phases=what == "T(qa)" and E == 1)
                del d, s
            for what, M, N in (("wgrad1", D, g * F), ("wgrad2", F, D)):
                check_nt(record, f"{name} {what}", *erowq(E, M, C),
                         *erowq(E, N, C), phases=what == "wgrad1")
                torch.cuda.empty_cache()
        Eg = experts_checked(E, D * g * F)
        gemms = (("gemm1", D, g * F, False, False),
                 ("gemm2", F, D, False, False))
        if train:
            gemms += (("dgrad2", D, F, True, False),
                      ("dgrad1", g * F, D, True, True))
        for what, K, N, w_trans, quant_out in gemms:
            x, sx = erowq(Eg, C, K)
            qw = blockq(gen, dev, *((Eg, N, K) if w_trans else (Eg, K, N)))
            check_gemm(record, f"{name} {what}" + (
                f" ({Eg} of {E} experts)" if Eg < E else ""), x, sx, qw,
                w_trans=w_trans, quant_out=quant_out)
            del x, sx, qw
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


def mlp_leaves(cfg):
    """The leaves whose CPU gradient must be nonzero: the expert and
    router weights, the dense layers' and the shared experts' MLP, or a
    dense model's MLP."""
    if not cfg.d_ff and not cfg.moe:             # mamba2: the mixer only
        return ["layers/in_proj", "layers/out_proj", "layers/conv_w"]
    if not cfg.moe:
        return ["layers/w13", "layers/w2"] + (
            ["enc_layers/w13", "enc_layers/w2", "cross_layers/wk"]
            if cfg.encdec else [])
    return (["layers/we13", "layers/we2", "layers/w_router"]
            + (["layers/ws13", "layers/ws2"] if cfg.n_shared_experts else [])
            + (["dense_layers/w13", "dense_layers/w2"]
               if cfg.n_dense_layers else []))


# The largest router gap (top_k-th minus next probability) at which a
# token may go to other experts on the two devices: their bf16 products
# round apart, and a few of 512 tokens sit that close to a tie (the CPU
# tests' ROUTE_TIE, tests/test_torch_arch_train.py).
ROUTE_TIE = 1e-3


@contextlib.contextmanager
def routed(ids_by_call=None):
    """Records each router call's expert ids and its gaps (top_k-th minus
    next probability) on the host; with ids_by_call, each call routes to
    the given ids (in call order) instead of its own top-k.  The port's
    own router runs (core/moe.py::router_topk): only its torch.topk is
    replaced, for the call's length, by a gather of the given ids."""
    from repro_torch.core import moe
    orig, topk, calls = moe.router_topk, torch.topk, []
    forced = None if ids_by_call is None else iter(ids_by_call)

    def router_topk(x, w_router, top_k):
        if forced is None:
            p, ids, aux = orig(x, w_router, top_k)
        else:
            want = next(forced).to(x.device)
            torch.topk = lambda probs, k, dim=-1: (
                probs.gather(-1, want), want)
            try:
                p, ids, aux = orig(x, w_router, top_k)
            finally:
                torch.topk = topk
        probs = torch.softmax(x.detach().float() @ w_router.detach().float(),
                              dim=-1)
        top = topk(probs, top_k + 1, dim=-1).values
        calls.append((ids.detach().cpu(),
                      (top[:, top_k - 1] - top[:, top_k]).cpu()))
        return p, ids, aux

    moe.router_topk = router_topk
    try:
        yield calls
    finally:
        moe.router_topk = orig


def moved_tokens(calls, ref_calls):
    """The gaps (on `calls`' side) of the tokens that `calls` routed to
    other experts than `ref_calls` did."""
    gaps = []
    for (ids, gap), (ref, _) in zip(calls, ref_calls):
        moved = (ids.sort(-1).values != ref.sort(-1).values).any(-1)
        gaps += gap[moved].tolist()
    return gaps


def gpu_vs_cpu_train(dev, label="train", arch="qwen3_moe_235b"):
    """From the same params and batch on the card and on the CPU: every
    leaf's gradient (the expert weights' through the hand-written FP8
    backward), then two train steps, the second's loss depending on the
    first's update.  The batch is 8 x 64 tokens: at 4 x 64 every expert's
    128-row block holds padding rows, and the scaling-aware transpose then
    flushes all of Wgrad-1 to zero on both paths (a fault the port keeps
    from the reference; ROADMAP.md, Queue 3), so the comparison could not
    see it.  The expert, router, dense and shared MLP leaves' CPU
    gradients must be nonzero.  A token the card routes to other experts
    than the CPU must sit at a router near-tie (ROUTE_TIE); when one
    does, the gradients are compared on a third run, the card routed as
    the CPU routed (the unrouted cosines are printed beside them)."""
    from repro_torch.data.pipeline import DataConfig, make_batch_np
    from repro_torch.models.lm import forward, init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    from repro_torch.weights import params_to

    cfg = reduced_config(arch)
    recipe = recipe_for(label)
    opt = AdamWConfig(lr=1e-3)
    batch_np = make_batch_np(DataConfig(vocab=cfg.vocab, seq_len=64,
                                        global_batch=8), 0)
    batch_np.update(stub_inputs_np(cfg, 8, 64))
    out, grads, calls = {}, {}, {}

    def grads_of(name, d, route=None):
        """A fresh state on d (the same CPU draw each time), its gradients
        by leaf (routed by `route`'s ids if given), and the state."""
        state = init_train_state(cfg, opt, device=d, params=params_to(
            init_params(cfg, seed=0, device="cpu"), d))
        batch = {k: torch.from_numpy(v).to(d) for k, v in batch_np.items()}
        with routed(route) as calls[name]:
            loss, _ = forward(cfg, recipe, state["params"], batch)
            loss.backward()
        # a leaf the forward never reads (mamba2's ln2) has no gradient:
        # jax.grad's zeros
        grads[name] = {path: torch.zeros(p.shape) if p.grad is None
                       else p.grad.float().cpu()
                       for path, p in named_leaves(state["params"])}
        for _, p in named_leaves(state["params"]):
            p.grad = None
        return state, batch

    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        state, batch = grads_of(name, d)
        step = make_train_step(cfg, recipe, opt, total_steps=10,
                               warmup_steps=1)
        state, m1 = step(state, batch)
        state, m2 = step(state, batch)
        out[name] = (float(m1["loss"]), float(m1["grad_norm"]),
                     float(m2["loss"]))
        del state, step, batch
    (lg, gg, lg2), (lc, gc, lc2) = out["cuda"], out["cpu"]
    rel_loss, rel_gn = abs(lg - lc) / abs(lc), abs(gg - gc) / abs(gc)
    rel_loss2 = abs(lg2 - lc2) / abs(lc2)
    moved = moved_tokens(calls["cuda"], calls["cpu"])
    unrouted = {path: cosine(grads["cuda"][path], grads["cpu"][path])
                for path in grads["cpu"]}
    cos = unrouted
    if moved:
        grads_of("cuda_routed", dev, [ids for ids, _ in calls["cpu"]])
        cos = {path: cosine(grads["cuda_routed"][path], grads["cpu"][path])
               for path in grads["cpu"]}
    print(json.dumps({"gpu_vs_cpu_train": dict(
        config=f"{arch}.reduced()", path=label, loss=[lg, lc],
        grad_norm=[gg, gc], rel_loss=rel_loss, rel_grad_norm=rel_gn,
        step2_loss=[lg2, lc2], rel_step2_loss=rel_loss2,
        tokens_routed_apart=len(moved), their_router_gaps=moved,
        grad_cosine=cos,
        **({"grad_cosine_unrouted": unrouted} if moved else {}))}))
    check(np.isfinite([lg, lc, gg, gc, lg2, lc2]).all(),
          "a non-finite train step")
    check(rel_loss <= 1e-3, f"GPU vs CPU train loss rel diff {rel_loss}")
    check(rel_gn <= 1e-2, f"GPU vs CPU grad norm rel diff {rel_gn}")
    check(rel_loss2 <= 1e-3,
          f"GPU vs CPU second-step loss rel diff {rel_loss2}")
    check(all(g < ROUTE_TIE for g in moved),
          f"a token routed apart away from a router near-tie: {moved}")
    need = mlp_leaves(cfg)
    check(set(need) <= set(cos),
          f"the MLP, expert or router leaves {need} are missing: "
          f"{sorted(cos)}")
    check(all(grads["cpu"][p].abs().max().item() > 0 for p in need),
          f"an MLP, expert or router leaf's gradient is zero on the CPU "
          f"path: {need}")
    bar = DEEP_GRAD_COSINE if arch in FP8_DEEP_ARCHS \
        and recipe.name != "bf16" else GRAD_COSINE_MIN
    low = {p: c for p, c in cos.items() if not c >= bar}
    check(not low, f"GPU vs CPU gradient cosine < {bar}: {low}")


# ---------------------------------------------------------------------------
# Phases 18-21: the SSM, hybrid, encoder-decoder and frontend configs.
# ---------------------------------------------------------------------------
# mamba2_27b (mixer-only SSM layers: no FP8 site, no kernel of the port,
# as in the reference), hymba_15b (attention + Mamba2 mixer, SwiGLU MLP),
# seamless_m4t_v2 (encoder-decoder, ReLU MLPs, in the encoder too) and
# llava_next_34b (a 2880-row vision prefix in front of the tokens, SwiGLU
# MLP).  The paged engine refuses all four, as the reference's does; they
# serve through serve.serve_step (make_prefill, then make_serve_step over
# a dense cache at one shared position).
ARCH_TAGS.update({"m2": "mamba2_27b", "hy": "hymba_15b",
                  "sm": "seamless_m4t_v2", "lv": "llava_next_34b"})
PATH_KERNELS.update({
    "m2_serve": (), "m2_train": (),
    "hy_serve": PATH_KERNELS["qwen15_serve"],
    "hy_train": PATH_KERNELS["qwen15_train"], "hy_bf16_train": (),
    "sm_serve": ACT_MLP_KERNELS["serve"], "sm_train": ACT_MLP_KERNELS["train"],
    "lv_serve": PATH_KERNELS["qwen15_serve"],
    "lv_train": PATH_KERNELS["qwen15_train"]})
# the serve path: SERVE_B requests, SERVE_PROMPT-token prompts fed through
# the serve step at positions 0.., then SERVE_NEW greedy tokens; the
# encoder-decoder's input has SERVE_ENC rows (its cross cache holds as
# many: the cache is SERVE_PROMPT + SERVE_NEW long)
SERVE_B, SERVE_PROMPT, SERVE_NEW, SERVE_ENC = 8, 16, 16, 32
# llava's prefill batch: its 2880-row prefix and 192 tokens (3072 rows, a
# multiple of the flash block of 256) for LLAVA_PREFILL_B requests
LLAVA_PREFILL_B, LLAVA_TOKENS = 2, 192
# the stub frontend and encoder inputs: N(0, 1) x STUB_SCALE
STUB_SCALE = 0.5
# train batches other than TRAIN_B x TRAIN_S: llava at batch 1 with its
# prefix (1 x (2880 + 192) rows)
TRAIN_SHAPES = {"lv": (1, LLAVA_TOKENS)}
# depths trained, each config's deepest with ~6 GiB of the card's 79.18
# GiB to spare (chip_depths.py, one fp8_flow step: mamba2_27b 52 layers
# 73.31 GiB, 54 76.07, 56 out of memory; llava_next_34b 4 layers 72.92;
# hymba_15b and seamless_m4t_v2 whole, 56.45 and 52.95; PERF.md section
# 4); every one serves whole
NEW_TRAIN_LAYERS = {"m2": 52, "hy": 32, "sm": 24, "lv": 4}
# seamless_m4t_v2's reduced() encoder sits under both decoder layers'
# cross-attention, four FP8 MLPs deep: its fp8_flow gradients on the two
# devices meet at the six-layer bar of the CPU tests (DEEP_GRAD_COSINE in
# tests/test_torch_train_gelu_moe.py; the port against itself with a
# last-bit change reads 0.99889 on enc_layers/ln2_s there), and its bf16
# gradients at GRAD_COSINE_MIN
DEEP_GRAD_COSINE, FP8_DEEP_ARCHS = 0.998, ("seamless_m4t_v2",)


def stub_inputs(cfg, B, S, gen, dev):
    """The frontend's stub prefix (B, frontend_len, D) and an encoder-
    decoder's input (B, S, D), bf16, from `gen` (the batch keys forward
    reads)."""
    shapes = {}
    if cfg.frontend != "none" and cfg.frontend_len:
        shapes["prefix"] = (B, cfg.frontend_len, cfg.d_model)
    if cfg.encdec:
        shapes["enc_input"] = (B, S, cfg.d_model)
    return {k: (torch.randn(shape, generator=gen, device=dev)
                * STUB_SCALE).to(torch.bfloat16)
            for k, shape in shapes.items()}


def stub_inputs_np(cfg, B, S, seed=5):
    """stub_inputs as f32 numpy from a numpy seed (the same on both
    devices)."""
    r = np.random.default_rng(seed)
    out = {}
    if cfg.frontend != "none" and cfg.frontend_len:
        out["prefix"] = (r.normal(size=(B, cfg.frontend_len, cfg.d_model))
                         * STUB_SCALE).astype(np.float32)
    if cfg.encdec:
        out["enc_input"] = (r.normal(size=(B, S, cfg.d_model))
                            * STUB_SCALE).astype(np.float32)
    return out


def fill_cross_cache(cfg, recipe, params, cache, enc_input):
    """cache["cross"] rows [0, S_enc) from the port's own encoder on
    enc_input and each decoder layer's _project_cross_kv (no code of the
    port or the reference writes them: the caller does)."""
    from repro_torch.models import lm
    with torch.no_grad():
        enc, _ = lm._run_encoder(cfg, recipe, params, enc_input)
        n = enc.shape[1]
        for i in range(cfg.n_layers):
            k, v = lm._project_cross_kv(
                cfg, lm.layer_slice(params["cross_layers"], i), enc)
            cache["cross"]["k"][i, :, :n] = k
            cache["cross"]["v"][i, :, :n] = v


def prefill_batch(cfg, dev, gen, prompts):
    """make_prefill's batch: the prompts, or llava's LLAVA_PREFILL_B
    requests of LLAVA_TOKENS tokens behind their prefix; an
    encoder-decoder's SERVE_ENC-row input."""
    if cfg.frontend == "vision":
        B, S = LLAVA_PREFILL_B, LLAVA_TOKENS
        tokens = torch.randint(1, cfg.vocab, (B, S), generator=gen,
                               device=dev)
    else:
        tokens = prompts
        B, S = prompts.shape
    return {"tokens": tokens, **stub_inputs(cfg, B, SERVE_ENC, gen, dev)}


def serve_step_path(cfg, dev, label):
    """The fixed-batch serve path of `cfg` (random bf16 params from seed
    0): one make_prefill call timed after a warm one, then SERVE_B
    requests through make_serve_step, their SERVE_PROMPT-token prompts fed
    at positions 0.. and SERVE_NEW greedy tokens after them; an
    encoder-decoder's cross cache filled first from its encoder on its
    input.  Every kernel of the path launched in that run, no other.
    Returns (launches, tokens)."""
    from repro_torch import kernels
    from repro_torch.models import lm
    from repro_torch.serve.serve_step import make_prefill, make_serve_step

    recipe = recipe_for(label)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params_gib = torch.cuda.memory_allocated() / 2**30
    gen = torch.Generator(device=dev).manual_seed(7)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (SERVE_B, SERVE_PROMPT))).to(dev)
    pbatch = prefill_batch(cfg, dev, gen, prompts)
    prefill, step = make_prefill(cfg, recipe), make_serve_step(cfg, recipe)
    kernels.reset_launches()
    prefill_ms = []
    for _ in range(2):                           # warm, then timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = prefill(params, pbatch)
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
    check(bool(torch.isfinite(last.float()).all()) and tuple(last.shape)
          == (pbatch["tokens"].shape[0], cfg.vocab_padded),
          f"{label}: prefill logits {tuple(last.shape)} not finite or "
          "not (B, V)")
    cache = lm.init_cache(cfg, SERVE_B, SERVE_PROMPT + SERVE_NEW, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if cfg.encdec:
        fill_cross_cache(cfg, recipe, params, cache,
                         pbatch["enc_input"][:SERVE_B])
    out, tok = [], prompts[:, :1]
    for pos in range(SERVE_PROMPT + SERVE_NEW - 1):
        if pos < SERVE_PROMPT:
            tok = prompts[:, pos:pos + 1]
        tok, cache = step(params, cache, tok, pos)
        if pos >= SERVE_PROMPT - 1:
            out.append(tok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    tokens = torch.cat(out, dim=1).tolist()
    check(all(len(t) == SERVE_NEW for t in tokens),
          f"{label}: a request stopped short of {SERVE_NEW} tokens")
    check(all(0 <= t < cfg.vocab for ts in tokens for t in ts),
          f"{label}: a token outside the vocabulary")
    check_launches(label, launches)
    sha = hashlib.sha256(json.dumps(tokens).encode()).hexdigest()
    steps = SERVE_PROMPT + SERVE_NEW - 1
    print(json.dumps({label: dict(
        config=f"{cfg.name} n_layers={cfg.n_layers} full width",
        path="make_prefill + make_serve_step (dense cache, shared pos)",
        requests=SERVE_B, prompt=SERVE_PROMPT, new_tokens=SERVE_NEW,
        prefill_batch={k: list(v.shape) for k, v in pbatch.items()},
        prefill_ms=prefill_ms, decode_steps=steps, seconds=dt,
        ms_per_step=1e3 * dt / steps,
        tokens_per_s=SERVE_B * SERVE_NEW / dt, tokens_sha256=sha,
        init_s=init_s, params_gib=params_gib,
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches)}))
    del params, cache, pbatch, last
    torch.cuda.empty_cache()
    return launches, tokens


def gpu_vs_cpu_serve_step(dev, arch):
    """At reduced() size, from the same params: make_prefill's logits and
    four serve steps' decode_step logits on the card and on the CPU,
    cosine >= 0.999 each (an encoder-decoder's cross cache filled on each
    device from its own encoder)."""
    from repro_torch.models import lm
    from repro_torch.serve.serve_step import make_prefill
    from repro_torch.weights import params_to

    cfg = reduced_config(arch)
    recipe = recipe_for("serve")
    params_cpu = lm.init_params(cfg, seed=0, device="cpu")
    r = np.random.default_rng(2)
    tokens = r.integers(1, cfg.vocab, (2, 16))
    stubs = stub_inputs_np(cfg, 2, 16)
    out = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        params = params_to(params_cpu, d)
        batch = {"tokens": torch.from_numpy(tokens).to(d), **{
            k: torch.from_numpy(v).to(d).to(torch.bfloat16)
            for k, v in stubs.items()}}
        logits = [make_prefill(cfg, recipe)(params, batch).float().cpu()]
        cache = lm.init_cache(cfg, 2, 16, device=d)
        if cfg.encdec:
            fill_cross_cache(cfg, recipe, params, cache, batch["enc_input"])
        for pos in range(4):
            lg, cache = lm.decode_step(cfg, recipe, params, cache,
                                       batch["tokens"][:, pos:pos + 1], pos)
            logits.append(lg[:, 0].float().cpu())
        out[name] = logits
    cos = [torch.nn.functional.cosine_similarity(
        a.reshape(-1), b.reshape(-1), dim=0).item()
        for a, b in zip(out["cuda"], out["cpu"])]
    print(json.dumps({"gpu_vs_cpu": dict(
        config=f"{arch}.reduced()", path="serve_step (prefill + 4 decode "
        "steps)", cosine=cos)}))
    check(min(cos) >= 0.999, f"{arch}: GPU path vs CPU path cosine {cos} "
          "< 0.999")


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
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"[ptxas {lib}] {line.strip()}")

    floor_ms = launch_floor_ms(dev)
    print(json.dumps({"launch_floor_ms": floor_ms, "what": "time_ms of "
                      "zero_() on a one-element tensor: a graph-replayed "
                      "launch that moves ~0 bytes"}))
    cfg = serve_config()
    timings = kernel_checks(cfg, PEAKS, dev, floor_ms)
    launches = {}
    launches["serve"], tokens, _ = serve_path(cfg, dev)
    launches["masked_serve"], _, plans = serve_path(
        cfg, dev, "masked_serve", padded_tokens=tokens)
    launches["bf16_serve"], _, _ = serve_path(cfg, dev, "bf16_serve")
    add_rows(timings, masked_serve_kernel_checks(cfg, PEAKS, dev, plans))
    for label in ("serve", "masked_serve", "bf16_serve"):
        gpu_vs_cpu(dev, label)
    tcfg = train_config()
    add_rows(timings, train_kernel_checks(tcfg, PEAKS, dev, floor_ms))
    launches["train"], losses, _ = train_path(tcfg, dev)
    launches["masked_train"], _, plan = train_path(
        tcfg, dev, "masked_train", padded_losses=losses)
    add_rows(timings, masked_train_kernel_checks(tcfg, PEAKS, dev, plan))
    add_rows(timings, linear_kernel_checks(tcfg, PEAKS, dev, floor_ms))
    for label in ("bf16_train", "blockwise_train", "naive_train"):
        launches[label], _, _ = train_path(tcfg, dev, label)
    for label in ("train", "masked_train", "bf16_train", "blockwise_train",
                  "naive_train"):
        gpu_vs_cpu_train(dev, label)

    # the configs with dense layers and shared experts (phases 10-13),
    # each path's kernels checked at the shapes it gives them
    dcfg = arch_config("deepseek_v2_lite")
    launches["dsv2_serve"], tokens, _ = serve_path(dcfg, dev, "dsv2_serve")
    launches["dsv2_masked_serve"], _, plans = serve_path(
        dcfg, dev, "dsv2_masked_serve", padded_tokens=tokens)
    add_rows(timings, masked_serve_kernel_checks(dcfg, PEAKS, dev, plans,
                                                 "dsv2 "))
    qcfg = arch_config("qwen15_05b")
    launches["qwen15_serve"], _, _ = serve_path(qcfg, dev, "qwen15_serve")
    v3cfg = arch_config("deepseek_v3_671b", DSV3_SERVE_LAYERS)
    launches["dsv3_serve"], _, _ = serve_path(v3cfg, dev, "dsv3_serve")
    for tag, c, path in (("dsv2", dcfg, "prefill"), ("dsv2", dcfg, "decode"),
                         ("qwen15", qcfg, "prefill"),
                         ("dsv3", v3cfg, "prefill"),
                         ("dsv3", v3cfg, "decode")):
        add_rows(timings, arch_kernel_checks(c, tag, path, PEAKS, dev,
                                             floor_ms))
    dcfg = arch_config("deepseek_v2_lite", DSV2_TRAIN_LAYERS)
    for tag, c in (("dsv2", dcfg), ("qwen15", qcfg)):
        add_rows(timings, arch_kernel_checks(c, tag, "train", PEAKS, dev,
                                             floor_ms))
    launches["dsv2_train"], losses, _ = train_path(dcfg, dev, "dsv2_train")
    launches["dsv2_masked_train"], _, plan = train_path(
        dcfg, dev, "dsv2_masked_train", padded_losses=losses)
    add_rows(timings, masked_train_kernel_checks(dcfg, PEAKS, dev, plan,
                                                 "dsv2 "))
    for label in ("dsv2_bf16_train", "dsv2_blockwise_train",
                  "dsv2_naive_train"):
        launches[label], _, _ = train_path(dcfg, dev, label)
    launches["qwen15_train"], _, _ = train_path(qcfg, dev, "qwen15_train")
    for arch in ("deepseek_v2_lite", "qwen15_05b", "deepseek_v3_671b"):
        gpu_vs_cpu(dev, "serve", arch)
    for arch in ("deepseek_v2_lite", "qwen15_05b"):
        for label in ("train", "masked_train", "bf16_train",
                      "blockwise_train", "naive_train"):
            gpu_vs_cpu_train(dev, label, arch)
    gpu_vs_cpu_train(dev, "train", "deepseek_v3_671b")

    # the GeGLU, GELU and local:global configs (phases 14-17)
    for tag in ("sc2", "g3", "g2"):
        c = arch_config(ARCH_TAGS[tag])
        launches[f"{tag}_serve"], _, _ = serve_path(c, dev, f"{tag}_serve")
        add_rows(timings, arch_kernel_checks(c, tag, "prefill", PEAKS, dev,
                                             floor_ms))
    gcfg = arch_config("grok1_314b", GROK_SERVE_LAYERS)
    launches["grok_serve"], tokens, _ = serve_path(gcfg, dev, "grok_serve")
    launches["grok_masked_serve"], _, plans = serve_path(
        gcfg, dev, "grok_masked_serve", padded_tokens=tokens)
    add_rows(timings, masked_serve_kernel_checks(gcfg, PEAKS, dev, plans,
                                                 "grok "))
    for path in ("prefill", "decode"):
        add_rows(timings, arch_kernel_checks(gcfg, "grok", path, PEAKS, dev,
                                             floor_ms))
    for tag, n in TRAIN_LAYERS.items():
        c = arch_config(ARCH_TAGS[tag], n)
        add_rows(timings, arch_kernel_checks(c, tag, "train", PEAKS, dev,
                                             floor_ms))
        launches[f"{tag}_train"], losses, _ = train_path(c, dev,
                                                         f"{tag}_train")
        launches[f"{tag}_masked_train"], _, _ = train_path(
            c, dev, f"{tag}_masked_train", padded_losses=losses)
    for tag in ("sc2", "g3", "g2", "grok"):
        gpu_vs_cpu(dev, "serve", ARCH_TAGS[tag])
        for label in ("train", "masked_train", "bf16_train",
                      "blockwise_train", "naive_train"):
            gpu_vs_cpu_train(dev, label, ARCH_TAGS[tag])

    # the SSM, hybrid, encoder-decoder and frontend configs (phases
    # 18-21): served whole through serve_step, their kernels at the shapes
    # their paths give them (after llava's 64 GiB of weights are freed),
    # trained at NEW_TRAIN_LAYERS, and GPU-vs-CPU for the four
    for tag in ("m2", "hy", "sm", "lv"):
        c = arch_config(ARCH_TAGS[tag])
        launches[f"{tag}_serve"], _ = serve_step_path(c, dev, f"{tag}_serve")
    hy, sm, lv = (arch_config(ARCH_TAGS[t]) for t in ("hy", "sm", "lv"))
    lv_rows = lv.frontend_len + LLAVA_TOKENS                      # 3072
    for c, tag, path, T in (
            (hy, "hy", "prefill", SERVE_B * SERVE_PROMPT),
            (sm, "sm", "prefill", SERVE_B * SERVE_PROMPT),
            (sm, "sm enc", "prefill", SERVE_B * SERVE_ENC),
            (lv, "lv", "prefill", LLAVA_PREFILL_B * lv_rows),
            (hy, "hy", "train", None), (sm, "sm", "train", None),
            (lv, "lv", "train", TRAIN_SHAPES["lv"][0] * lv_rows)):
        add_rows(timings, arch_kernel_checks(c, tag, path, PEAKS, dev,
                                             floor_ms, T))
    for tag, n in NEW_TRAIN_LAYERS.items():
        c = arch_config(ARCH_TAGS[tag], n)
        launches[f"{tag}_train"], _, _ = train_path(c, dev, f"{tag}_train")
    launches["hy_bf16_train"], _, _ = train_path(
        arch_config("hymba_15b", NEW_TRAIN_LAYERS["hy"]), dev,
        "hy_bf16_train")
    for tag in ("m2", "hy", "sm", "lv"):
        gpu_vs_cpu_serve_step(dev, ARCH_TAGS[tag])
        gpu_vs_cpu_train(dev, "train", ARCH_TAGS[tag])
    for arch in ("hymba_15b", "seamless_m4t_v2"):
        gpu_vs_cpu_train(dev, "bf16_train", arch)

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
               "masked_grouped_gemm_nt_fp8": grouped_gemm_nt_fp8,
               "quantize_rowwise_linear": quantize}
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
                "bound_ms", "bound_by", "bound_share", "vs_library",
                "max_abs_err", "mismatch_frac", "bf16_mismatch_frac",
                "f32_max_rel_diff", "store_only_ms", "one_step_ms",
                "f32_out_ms", "t_phases", "padded_ms", "live_tile_share",
                "copy_ms", "launch_floor_ms", "issue", "po2_ms")}
                for r in timings[kname]]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
