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
     no other; tokens/s, ms a step and peak device memory; its losses
     TRAIN_LOSSES, and the same run with autograd through the plain
     attention loop swapped in for the flash VJP (plain_attention)
     PLAIN_TRAIN_LOSSES, the losses from before the flash VJP;
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
     qwen3_moe_235b's served tokens and fp8_flow losses are held to
     their pinned bits (TRAIN_LOSSES and PLAIN_TRAIN_LOSSES for the
     losses);
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
 20. the four trained as phase 6 in fp8_flow at full width (mamba2 whole,
     hymba and seamless whole, llava at NEW_TRAIN_LAYERS of 60 at batch 1
     with its prefix) and hymba in bf16: losses falling, 2 casts a dense
     MLP a step (the encoder's too), exactly their kernels;
 21. GPU path vs CPU path at reduced() size for the four: make_prefill
     and four decode steps' logits, and fp8_flow training as phase 7
     (seamless's fp8_flow gradients at the six-layer bar 0.998, its bf16
     and hymba's bf16 at 0.999);
 22. the fused AdamW update (csrc/adamw_update.cu, not a TPU kernel: the
     reference's optimizer is XLA) against its twin at qwen3_moe_235b's
     (128, 4096, 3072) expert leaf, the f32 state and the FP8-split state
     (e4m3 m, bf16 v, f16 master with po2 row scales), one chunk and the
     whole leaf: every byte of m, v, the master, the scales and the
     parameter equal; timed with the bound (bytes) and, for f32,
     torch._fused_adamw_ as the library yardstick;
 23. qwen3_moe_235b at full width with StatePolicy() through
     train.loop.run, guard armed: 2 layers (which the f32 state cannot
     hold) and 1 layer beside the f32 state's 1 layer on the same
     batches; ms a step, tokens/s, peak GiB, losses, 2 casts a MoE layer,
     no guard event;
 24. grok1_314b at full width, 1 layer, StatePolicy(), the same way: its
     first training on the card;
 25. the runtime on the card: qwen15_05b whole, StatePolicy(), guard
     armed, async checkpoints every 2 steps, a NaN injected into the
     entry quantizes at step 3 (flagged nonfinite, skipped, every
     parameter and state byte's SHA-256 unchanged), a restart from the
     step-4 checkpoint (restored bit for bit, losses within 1e-5 of the
     uninterrupted run's), one grad_accum=2 step, the JSONL telemetry
     read back;
 26. GPU path vs CPU path at reduced() size with StatePolicy(), as phase
     7, for qwen3_moe_235b and qwen15_05b;
 27. the activation-residency plan (train/memory.py): deepseek_v2_lite
     at depth 4 trained as phase 12 (fp8_flow, the f32 state) under each
     remat policy (none, full, fp8_resident, pair) on the same batch:
     every policy's losses 'none''s bit for bit, 14 casts a step each,
     exactly its kernels; ms a step, peak GiB, and one MoE layer's kept
     bytes (memory_allocated after its forward less before, the tensors
     by the reference's buckets: fp8_resident keeps no wide bf16) beside
     layer_saved_bytes_model;
 28. the flash-attention VJP at llava_next_34b's full-width attention (1 x
     3072 rows, 56 heads): the Function's gradients against autograd
     through the plain loop with f32 inputs (within FLASH_REL 1e-5, the
     CPU test's bar, set from the card's 7.4e-6 at this shape), and with
     bf16 inputs each way's bytes kept for the backward,
     one backward's ms and peak bytes;
 29. the depths the plan buys, trained in phase 20: mamba2_27b whole (64
     layers) under the f32 state with the default 'full', llava_next_34b
     at the deepest depth chip_depths.py found under the f32 state with
     'fp8_resident' (NEW_TRAIN_LAYERS, TRAIN_POLICY: 7 layers, its pass
     with the allocator's expandable segments, GROWN_SEGMENT_PASSES);
 30. the radix prefix cache at full width: qwen3_moe_235b at depth 4
     (one random tree for phases 30-31), W8 experts, FP8 KV, page and
     prefill chunk 8, serving prefix_trace (4 tenants' shared prefixes,
     a whole repeat, a mid-edge divergence, two unrelated prompts) with
     the cache off, on, and on over PRESSURE_PAGES pages: the same tokens
     bit for bit in all three, PREFIX_HITS hits of 16 lookups, every live
     page the cache's at refcount 1, fewer launches of every serve kernel
     with the cache, cache evictions under pressure; tokens/s, ticks,
     chunks, hit tokens, the engine's TTFT/TBT histograms, peak GiB;
 31. a 1 prefill + 1 decode fleet (DisaggRouter) on the card, the cache
     on, serving the same trace: phase 30's cache-on tokens bit for bit,
     16 migrations, pages deduped on the receiver, every migrated page
     byte-equal on both tiers, no leaked page, the wire bytes the sum of
     bytes_for; again under a transfer budget of one 4-page batch
     (deferrals, the same tokens); the codec casting-free on the card's
     own pools (TorchDispatchMode); wire MiB, pages, migration ms, peak;
 32. the serve launcher in a subprocess on the card (qwen15_05b whole,
     --prefix-cache --disagg --obs-jsonl --obs-prom) and the JSONL
     reporter over its records, each exiting 0;
 33. the stage ranges (obs/trace.py): qwen3_moe_235b's fp8_flow train step
     (1 layer) and phase 3's serve trace (depth 4) under torch.profiler:
     busy device ms per stage/* range (their sum at most the busy ms),
     phase 6's losses and phase 3's tokens bit for bit with the ranges
     open and with annotate patched out, tokens/s each way;
 34. the roofline (roofline/analysis.py tally()) of that train step, a
     bucket-64 prefill and an 8-slot decode step: FLOPs, bytes, the
     compute and memory terms on the H100 SXM, the bottleneck, the
     measured ms and the mfu; the kernels' GEMM FLOPs equal to the
     analytic count;
 35. the chunked MoE blocks (core/moe.py moe_block_overlapped) at full
     width: qwen3 (1 layer, the FP8-split state) trained monolithic and at
     n = 1, 2, 4 chunks, padded and masked (losses, ms a step, padded
     rows, 2 casts a step, drop_frac, expert-plan overflow; masked bit for
     bit padded), every kernel against its twin at the chunk shapes, and
     phase 3's trace served through the chunked blocks (its tokens);
 36. the expected_m hint at the train shapes: the padded kernels launched
     at expected_m >= C, the masked launches' bits;
 37. the expert-parallel path on an NCCL group of one rank (the card is
     one; NCCL refuses two ranks on it): qwen3 (1 layer, StatePolicy())
     trained with every dispatch and combine through all_to_all_single,
     padded and masked, monolithic and at 2 chunks (async messages),
     phase 35's group-less losses bit for bit; the collectives a step and
     their bytes beside the roofline tally's; phase 3's trace served at
     depth 4 through the prefill's all-to-alls and the decode combine's
     all-reduce, its tokens bit for bit;
 38. the DistPlan step (FP8 DP wire, ZeRO-1) on that group: qwen3 1 layer
     fp8 vs f32 wire (the reference's 5% / 1% bars), deepseek_v2_lite at
     depth 4 f32 wire == the plain f32-state step bit for bit, fp8 within
     the bars, a flipped wire byte flagged and recovered; 2 casts a MoE
     block, the dp_wire / opt_state fused quantizes, wire bytes ==
     wire_grad_bytes at a modelled world, adamw_update launches, ms, wire
     ms, peak;
 39. compressed_psum of one qwen3 expert leaf: #1 twice, the error within
     two e4m3 half-ulps of each row's amax, the first expert the plain
     e4m3 twin's bit for bit (an e5m2 control printed and refused), ms;
 40. the reference's production levers on that group: qwen3 (1 layer,
     StatePolicy()) with TP experts and FSDP under each combine, padded
     and masked, each the group-less TP run bit for bit and within 1e-3
     of phase 37's EP run, 2 casts and Dgrad-1 on #3 (#5) then #1 (no #4
     / #6); grok1_314b (1 layer) with TP experts (FSDP where its
     predicted peak fits); deepseek_v2_lite at depth 4 with the TP MLP
     and FSDP against the plain mesh step; collectives a step and their
     bytes beside the tally's, ms, peak;
 41. the streaming FP8 DP wire on that group: deepseek_v2_lite depth 4
     and qwen3 1 layer, stream == posthoc over the layered layout bit
     for bit (also with grad_accum 2 and under 'pair'), the first
     reduce-scatter before the last backward GEMM, the ledger unchanged,
     a flipped wire byte flagged and recovered; ms stream / posthoc
     layered / flat, wire ms, exposed wire ms measured beside
     grad_comm.stream_exposed_us, peak;
 42. serving across ranks and the pod axis on that group: qwen3 (depth
     4) served under make_plan (EP, W8 experts from the serving cut),
     phase 3's tokens bit for bit, and through serve_step with plan=
     (the group-less tokens); grok1_314b (depth 4) served with TP experts
     (moe_block_tp on W8), the group-less TP run's tokens bit for bit and
     logits cosine >= 0.999 against its EP run on the same weights; qwen3
     and grok with TP experts under the masked recipe (#5, #7), the
     padded runs' tokens bit for bit; #3,
     #5 and #7 at the TP decode shapes (and #3 at the production axis's
     F-slice); collectives a tick by kind and bytes, tokens/s and peak a
     run; deepseek_v2_lite (depth 4) trained on a (1, 1, 1) pod mesh,
     phase 40's (1, 1) losses bit for bit; the serve launcher --tp 1 on a
     world-1 FileStore mesh;
  9. the {"kernels": [...]} summary line (the eleven kernels, #1's
     linear mode and the AdamW update, with the new shapes' rows), then
     the result line.
Every train path's optimizer update runs through the AdamW kernel, which
is its twin bit for bit, so the losses of phases 6-21 keep their bits.
Every train path runs its config's remat policy ('full' unless
TRAIN_POLICY says otherwise): its checkpoint blocks recompute the
forward inside the backward, which records no cast.
It imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import os
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
# the passes whose step fills the card (llava_next_34b at 7 layers: 75.0
# GiB of 79.18) run with the caching allocator growing its segments in
# place (expandable_segments): with fixed segments such a step ran out on
# 3.69 GiB of fragments after earlier passes in the same process.  Only
# those passes: set for the whole process, growing segments slowed the
# set-up of every other path (each new allocation maps its pages)
GROWN_SEGMENT_PASSES = ("lv_train",)

# published dense peaks of the H100 SXM (NVIDIA data sheet): HBM bytes/s,
# fp8 and bf16 tensor-core and f32 (non-tensor) FLOP/s, kept in one place
# (repro_torch.roofline.analysis); the bounds hold only for that part,
# whose name torch reports as "NVIDIA H100 80GB HBM3"
from repro_torch.roofline.analysis import PEAKS  # noqa: E402
from repro_torch.obs.trace import STAGES  # noqa: E402


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
# the prefix cache's engine and the disaggregated fleet (phases 30-31)
# serve through the serve path's kernels; the cache, the codec and the
# router add none
PATH_KERNELS.update({"prefix_serve": PATH_KERNELS["serve"],
                     "fleet_serve": PATH_KERNELS["serve"]})
# the chunked MoE blocks (phase 35) run the kernels of the monolithic ones
PATH_KERNELS.update({"overlap_serve": PATH_KERNELS["serve"],
                     "overlap_train": PATH_KERNELS["train"],
                     "overlap_masked_train": PATH_KERNELS["masked_train"]})

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
                "naive_train": ("naive_fp8", {}),
                "overlap_serve": ("fp8_flow", {}),
                "overlap_train": ("fp8_flow", {}),
                "overlap_masked_train": ("fp8_flow", MASKED),
                "ep_serve": ("fp8_flow", {}),
                "ep_train": ("fp8_flow", {}),
                "ep_masked_train": ("fp8_flow", MASKED)}


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


def make_serve(cfg, dev, label="serve", plan=None):
    """The serve path's engine (random weights from seed 0: W8 for
    fp8_flow, bf16 for the bf16 recipe; FP8 KV; the MoE blocks chunked by
    `plan`'s moe_overlap, a DispatchPlan, or over its mesh) and its trace:
    16 greedy requests, prompts of 3-48 tokens, 16 new each."""
    from repro_torch.models.lm import init_params
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import Request

    ecfg = ServeConfig(max_batch=8, page_size=8, n_pages=128,
                       max_pages_per_req=8, token_budget=512,
                       prefill_buckets=(16, 32, 64), fp8_kv=True,
                       w8_weights=True, seed=0)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, recipe_for(label),
                      init_params(cfg, seed=0, device=dev), ecfg, device=dev,
                      plan=plan)
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


def serve_path(cfg, dev, label="serve", padded_tokens=None, plan=None):
    """The trace through the engine with the recipe of `label` (and the
    ParallelPlan `plan`: its chunked MoE blocks or its mesh); the masked
    recipe's tokens, and those of a plan, must be padded_tokens exactly.
    Returns
    (launches, tokens by request, the plans of a prefill and a decode step
    or None)."""
    from repro_torch import kernels

    masked = recipe_for(label).masked_experts
    torch.cuda.reset_peak_memory_stats()
    eng, reqs = make_serve(cfg, dev, label, plan)
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
    if masked or plan is not None:
        check(tokens == padded_tokens, f"the {label} pass generated other "
              "tokens than the padded pass")
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
                      torch.ones((1, 64), dtype=torch.int64, device=dev), 48,
                      plan=eng.plan)
        per_step["prefill_bucket64"] = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        paged_decode_step(cfg, eng.recipe, eng.params, eng.pools,
                          page_row.repeat(8, 1),
                          torch.ones((8, 1), dtype=torch.int64, device=dev),
                          torch.full((8,), 48, device=dev),
                          torch.ones((8,), dtype=torch.bool, device=dev),
                          plan=eng.plan)
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


def moe_config(cfg):
    """The MoE block's config of an arch config (models/lm._moe_stage's)."""
    from repro_torch.core.moe import MoEConfig
    return MoEConfig(n_experts=cfg.n_experts, top_k=cfg.top_k,
                     d_model=cfg.d_model, d_ff=cfg.d_ff_expert,
                     capacity_factor=cfg.capacity_factor, act=cfg.act)


def train_capacity(cfg) -> int:
    """Rows an expert on the train path: moe_block's C_exp at B*S tokens."""
    from repro_torch.core.moe import _round_up
    T = TRAIN_B * TRAIN_S
    C_send = _round_up(max(int(T * cfg.top_k * cfg.capacity_factor), 8), 8)
    return _round_up(max(C_send // cfg.n_experts, 8), 128)


def train_kernel_checks(cfg, peaks, dev, floor_ms, n_chunks=1):
    """Every kernel of the train path against its twin at the shapes one
    full-width train step gives it (T = 2048 tokens, C = 256 rows an
    expert), or with n_chunks > 1 at the shapes of one chunk of the
    overlapped block (T / n tokens a send, its own C; the entry quantize
    stays whole, the island quantize covers every chunk's rows), the
    shapes then prefixed "chunk<n> "."""
    from repro_torch.core.moe import (_chunk_geometry, _dispatch_plan,
                                      _expert_plan, _round_up)

    gen = torch.Generator(device=dev).manual_seed(2)
    D, F, E, k = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.top_k
    T = TRAIN_B * TRAIN_S                                       # 2048
    C_send = _round_up(max(int(T * k * cfg.capacity_factor), 8), 8)
    C = train_capacity(cfg)                                     # 256
    tag = ""
    if n_chunks > 1:
        tag = f"chunk{n_chunks} "
        T_send, C_send, _, C = _chunk_geometry(
            recipe_for("train"), moe_config(cfg), T, n_chunks, 1, E)
    else:
        T_send = T
    record = KernelRows(peaks, floor_ms)

    def erowq(M, K, spread=0.0):
        d, s = rowq(gen, dev, E * M, K, spread)
        return d.reshape(E, M, K), s.reshape(E, M, K // 128)

    # -- #1: the entry quantize, the backward island and dact_quant
    for shape, M, K in (("q_entry", T, D),
                        ("q_bwd_island", n_chunks * E * C, D),
                        ("dact_quant", E * C, 2 * F)):
        if tag and shape == "q_entry":
            continue                        # the whole block's, as above
        check_quantize(record, tag + shape, torch.randn(
            (M, K), generator=gen, device=dev, dtype=torch.bfloat16))

    # -- #2: the dispatch send, the expert grouping, and the backward gather
    # of the FP8 cotangent by the grouping's inverse map
    ids = torch.topk(torch.randn((T_send, E), generator=gen, device=dev), k,
                     dim=-1).indices
    rms, slot_e, _, _ = _dispatch_plan(ids, k, 1, E, C_send)
    rme, ret = _expert_plan(slot_e, E, C)
    for shape, M, row_map in (("train_send", T_send, rms),
                              ("train_group", C_send, rme),
                              ("train_bwd_inv_map", E * C, ret)):
        check_permute(record, tag + shape, *rowq(gen, dev, M, D), row_map)

    # -- #8: SwiGLU + quantize on GEMM-1's output
    check_swiglu(record, tag + "train", torch.randn(
        (E * C, 2 * F), generator=gen, device=dev, dtype=torch.bfloat16))

    # -- #9 the scaling-aware transpose at its four train launches
    # (core/linear.py): Wgrad-2 takes T(qa) and T(qg), Wgrad-1 T(qx) and
    # T(qgh)
    for shape, K in (("T(qx)", D), ("T(qa)", F), ("T(qg)", D),
                     ("T(qgh)", 2 * F)):
        d, s = erowq(C, K, spread=1.0)
        check_transpose(record, tag + shape, d, s,
                        phases=shape == "T(qx)" and not tag)
        del d, s
        torch.cuda.empty_cache()

    # -- #10 the NT grouped GEMM: Wgrad-1 and Wgrad-2, bf16 out
    for shape, M, N in (("wgrad1", D, 2 * F), ("wgrad2", F, D)):
        check_nt(record, tag + shape, *erowq(M, C), *erowq(N, C),
                 phases=not tag)

    # -- #3 GEMM-1 (and the h recompute, same shape) and GEMM-2 at C = 256;
    # -- #4 Dgrad-1 with the quantizing epilogue, w13 read transposed;
    # -- #3 Dgrad-2 with w2 read transposed; unchunked, also #3 Dgrad-1
    # with bf16 out, as TP experts run it before the gx all-reduce (phase
    # 40; moe_block_tp's C_exp is this C at T = 2048)
    gemms = (("train_gemm1", D, 2 * F, False, False),
             ("train_gemm2", F, D, False, False),
             ("dgrad1", 2 * F, D, True, True),
             ("dgrad2", D, F, True, False))
    if not tag:
        gemms += (("tp_dgrad1", 2 * F, D, True, False),)
    for shape, K, N, w_trans, quant_out in gemms:
        x, sx = erowq(C, K)
        qw = blockq(gen, dev, *((E, N, K) if w_trans else (E, K, N)))
        check_gemm(record, tag + shape, x, sx, qw, w_trans=w_trans,
                   quant_out=quant_out)
        del x, sx, qw
    return record.rows


# ---------------------------------------------------------------------------
# Phase 6: the train path at full width.
# ---------------------------------------------------------------------------
def make_train(cfg, dev, label="train", state_policy=None):
    """The train path's state (random bf16 params from seed 0, AdamW at the
    reference's defaults with lr=1e-3, the f32 state or `state_policy`),
    step function (the reference make_train_step's default schedule: 100
    warmup steps of a cosine over 100k) and its one fixed batch
    (make_batch step 0, B=2, S=1024).  With no warmup, lr 1e-3 overshoots
    at this width: the loss falls at the second step and rises from the
    third (PERF.md, section 6)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    opt = AdamWConfig(lr=1e-3, state_policy=state_policy)
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
# fixed batch), to the six decimals PERF.md keeps, with the attention
# gradients of the reference's flash VJP.  The witness that only the
# attention's backward moved them: with autograd through the plain loop
# (flash_attention_plain) swapped back in, the same path must still give
# the losses it gave before the flash VJP, PLAIN_TRAIN_LOSSES.
TRAIN_LOSSES = {"train": (12.851900, 12.591271, 11.596126, 8.346811)}
PLAIN_TRAIN_LOSSES = (12.851900, 12.590693, 11.596179, 8.347960)


@contextlib.contextmanager
def grown_segments(label):
    """The caching allocator's expandable segments for the pass `label`
    when it is one of GROWN_SEGMENT_PASSES (this process only), its cache
    emptied on the way in and out."""
    if label not in GROWN_SEGMENT_PASSES:
        yield
        return
    # the accelerator-generic setter where torch has it (it deprecates
    # torch.cuda.memory._set_allocator_settings)
    setting = getattr(torch._C, "_accelerator_setAllocatorSettings", None) \
        or torch.cuda.memory._set_allocator_settings
    torch.cuda.empty_cache()
    setting("expandable_segments:True")
    try:
        yield
    finally:
        setting("expandable_segments:False")
        torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_attention():
    """Every train path's attention differentiated by autograd through the
    plain loop (flash_attention_plain) instead of the flash VJP."""
    from repro_torch.models import layers, lm
    fn = layers.flash_attention
    layers.flash_attention = lm.flash_attention = layers.flash_attention_plain
    try:
        yield
    finally:
        layers.flash_attention = lm.flash_attention = fn


def train_path(cfg, dev, label="train", padded_losses=None, name=None,
               record=None, want_losses=None):
    """TRAIN_STEPS steps on the fixed batch with the recipe of `label`,
    from the same seed; the masked recipe's every loss must be
    padded_losses' bit for bit, and the losses `want_losses` (default
    TRAIN_LOSSES[label], where it has one) to six decimals.  The JSON line
    is keyed `name` (default `label`); `record`, a dict, gets its fields.
    Returns (launches, losses, the first step's plan or None)."""
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
    want_losses = want_losses or TRAIN_LOSSES.get(label)
    if want_losses:
        check(all(abs(a - b) <= 5e-7 for a, b in zip(losses, want_losses)),
              f"{name or label}: losses {losses}, not {want_losses} as "
              "before")
    B, S = batch["tokens"].shape
    tokens = B * S
    warm = step_s[1:]
    row = dict(
        config=f"{cfg.name} n_layers={cfg.n_layers} full width",
        recipe=recipe.name, remat_policy=cfg.remat_policy,
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
        })
    print(json.dumps({name or label: row}))
    if record is not None:
        record.update(row)
    del state, step, batch, m
    torch.cuda.empty_cache()
    # a dense config's masked recipe has no expert plan
    plan = plans[max(plans)][0] if base_label(label) == "masked_train" \
        and plans else None
    return launches, losses, plan


def masked_train_kernel_checks(cfg, peaks, dev, mm, tag="", C=None,
                               tp=False):
    """The four masked kernels at the shapes one full-width masked train
    step gives them (C = 256 rows an expert), on the dispatch layout of
    the masked train pass's own first plan: #7 GEMM-1, #5 GEMM-2, the h
    recompute and Dgrad-2 (w2 read transposed), #6 Dgrad-1 (w13 read
    transposed), #11 Wgrad-1 and Wgrad-2; each against its twin and its
    padded kernel(s), timed beside them.  With `tp`, also #5 Dgrad-1 (w13
    read transposed, bf16 out), as TP experts run it before the gx
    all-reduce (phase 40).  `tag` prefixes the rows' shapes; `C` (default
    the train capacity) is a chunk's."""
    gen = torch.Generator(device=dev).manual_seed(4)
    D, F, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    C = C or train_capacity(cfg)                                # 256
    record = KernelRows(peaks)
    print(json.dumps({"masked_plan": dict(
        path=f"{tag}train", call="step 1", **live_stats(mm, C))}))
    w13 = blockq(gen, dev, E, D, 2 * F)
    check_masked_swiglu(record, f"{tag}train_gemm1",
                        *dispatch_rows(gen, dev, mm, C, D), w13, mm)
    check_masked_gemm(record, f"{tag}train_h_recompute",
                      *dispatch_rows(gen, dev, mm, C, D), w13, mm)
    del w13
    gemms = (("train_gemm2", F, D, False, False),
             ("dgrad2", D, F, True, False),
             ("dgrad1", 2 * F, D, True, True))
    if tp:
        gemms += (("tp_dgrad1", 2 * F, D, True, False),)
    for shape, K, N, w_trans, quant_out in gemms:
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


def arch_kernel_checks(cfg, tag, path, peaks, dev, floor_ms, T=None,
                       tp=False):
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
    encoder's rows); a config without an MLP (mamba2_27b) has no row.
    With `tp` (train), the dense and shared MLPs also check #3 Dgrad-1
    with bf16 out, as the TP dense MLP runs it before the gx all-reduce
    (phase 40's mlp_tp)."""
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
        if train and tp and kind != "routed":
            gemms += (("tp_dgrad1", g * F, D, True, False),)
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
    replaced, for the call's length, by a gather of the given ids.  A
    router (known by its weight) called again, as a checkpoint block's
    recompute calls it inside the backward (train/memory.py), routes as
    its first call did and is not recorded again."""
    from repro_torch.core import moe
    orig, topk, calls = moe.router_topk, torch.topk, []
    forced = None if ids_by_call is None else iter(ids_by_call)
    first_ids = {}

    def routed_to(want, x, w_router, top_k):
        torch.topk = lambda probs, k, dim=-1: (probs.gather(-1, want), want)
        try:
            return orig(x, w_router, top_k)
        finally:
            torch.topk = topk

    def router_topk(x, w_router, top_k):
        key = w_router.data_ptr()
        if key in first_ids:                       # a recompute
            if forced is None:
                return orig(x, w_router, top_k)
            return routed_to(first_ids[key], x, w_router, top_k)
        if forced is None:
            p, ids, aux = orig(x, w_router, top_k)
        else:
            p, ids, aux = routed_to(next(forced).to(x.device), x, w_router,
                                    top_k)
        first_ids[key] = ids.detach()
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


def gpu_vs_cpu_train(dev, label="train", arch="qwen3_moe_235b",
                     split_state=False):
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
    the CPU routed (the unrouted cosines are printed beside them).  With
    split_state both sides keep the FP8-split optimizer state
    (StatePolicy()): the second step's loss reads the first's update
    through the AdamW kernel's e4m3 / f16 re-encode on the card."""
    from repro_torch.data.pipeline import DataConfig, make_batch_np
    from repro_torch.dist.opt_state import StatePolicy
    from repro_torch.models.lm import forward, init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    from repro_torch.weights import params_to

    cfg = reduced_config(arch)
    recipe = recipe_for(label)
    opt = AdamWConfig(lr=1e-3,
                      state_policy=StatePolicy() if split_state else None)
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
        config=f"{arch}.reduced()", path=label,
        opt_state="StatePolicy()" if split_state else "f32", loss=[lg, lc],
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
    "lv_train": PATH_KERNELS["qwen15_train"],
    # grok's GeGLU experts: the activation as plain passes, then #1
    "grok_train": ("quantize_rowwise", "fused_permute_pad",
                   "grouped_gemm_fp8", "grouped_gemm_fp8_quant_out",
                   "fp8_transpose", "grouped_gemm_nt_fp8")})
# every train step's optimizer update is the AdamW kernel, one launch a
# chunk of a leaf (the bf16 recipe's too)
for _path in PATH_KERNELS:
    if _path.endswith("train"):
        PATH_KERNELS[_path] += ("adamw_update",)
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
# depths trained (chip_depths.py, one fp8_flow step, f32 state, of the
# card's 79.18 GiB; PERF.md section 4): mamba2_27b whole under 'full'
# (43.59 GiB; 52 layers 73.34 and 56 out of memory under 'none');
# llava_next_34b 7 layers under 'fp8_resident', the deepest single step
# (74.98 GiB under every policy, 8 run out with 70.26 GiB of state): after
# earlier work in one process it ran out with 3.69 GiB reserved but not
# allocated (fragmentation), so it trains with grown segments
# (GROWN_SEGMENT_PASSES); hymba_15b and seamless_m4t_v2 whole; every one
# serves whole
NEW_TRAIN_LAYERS = {"m2": 64, "hy": 32, "sm": 24, "lv": 7}
# each config's remat policy where it is not the default 'full' (phase 29)
TRAIN_POLICY = {"lv": "fp8_resident"}
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


# ---------------------------------------------------------------------------
# Phases 22-26: the training runtime.  The FP8-split optimizer state on
# the fused AdamW update kernel, the guardrails, the loop, checkpoints and
# gradient accumulation.
# ---------------------------------------------------------------------------
# qwen3_moe_235b's expert leaf we13 (E, D, 2F): the largest leaf its train
# step updates
ADAMW_LEAF = (128, 4096, 3072)
# bytes an element the update moves (each input read once, each output
# written once): f32 state reads the bf16 gradient, m, v and the master
# and writes them and the bf16 parameter; the split state the same in
# e4m3 / bf16 / f16, and the two po2 scales of each 128-element row
ADAMW_BYTES = {"f32": 2 + 12 + 12 + 2, "split": 2 + 5 + 5 + 2}
ADAMW_ROW_BYTES = {"f32": 0, "split": 16}
# f32 operations an element: the clip, adamw_math's 13 and the decode and
# encode multiplies (counted alike for both modes)
ADAMW_OPS = 16


def adamw_leaf_state(dev, n, mode, gen):
    """p, g (bf16), m, v and the master of an n-element leaf from random
    draws: f32, or the split state (e4m3 m, bf16 v, f16 master)."""
    from repro_torch.dist import opt_state as ost

    def draw(scale, dtype=torch.float32):
        t = torch.empty(n, dtype=dtype, device=dev)
        step = 1 << 25
        for i in range(0, n, step):
            k = min(step, n - i)
            t[i:i + k] = torch.randn(k, generator=gen, device=dev) * scale
        return t

    p, g = draw(1.0, torch.bfloat16), draw(1e-2, torch.bfloat16)
    m, v = draw(1e-3), draw(1e-2)
    v.square_()
    if mode == "split":
        m, v = ost.encode("e4m3", m), ost.encode("bf16", v)
        return p, g, m, v, ost.encode("f16", p)
    return p, g, m, v, p.to(torch.float32)


def leaf_update(fn, cfg, lr, b1c, b2c, g, clip, m, v, w, p):
    """`fn` (the kernel's wrapper or its twin) over a leaf a chunk at a
    time, as optim.adamw.apply_updates calls it."""
    from repro_torch.device import CHUNK_ELEMS
    from repro_torch.optim.adamw import _state_chunk
    n = p.numel()
    for s in range(0, n, CHUNK_ELEMS):
        k = min(CHUNK_ELEMS, n - s)
        fn(cfg, lr, b1c, b2c, g[s:s + k], clip, _state_chunk(m, s, k),
           _state_chunk(v, s, k), _state_chunk(w, s, k), p[s:s + k])


def state_views(*leaves):
    """The bytes of state leaves (QTensors' payloads and scales) as uint8."""
    from repro_torch.core.quant import QTensor
    out = []
    for x in leaves:
        for t in ((x.data, x.scale) if isinstance(x, QTensor) else (x,)):
            out.append(t.reshape(-1).view(torch.uint8))
    return out


def clone_state(x):
    from repro_torch.core.quant import QTensor
    if isinstance(x, QTensor):
        return QTensor(x.data.clone(), x.scale.clone(), x.tile)
    return x.clone()


def adamw_kernel_checks(peaks, dev):
    """The AdamW kernel against its twin at qwen3's expert leaf, f32 and
    split state, one chunk and the whole leaf: every byte of m, v, the
    master, the scales and the parameter equal.  Timed as the other
    kernels; the f32 mode beside torch._fused_adamw_ on the same f32
    master, moments and an f32 copy of the gradient (a yardstick: its
    weight decay multiplies the parameter before the step)."""
    from repro_torch.device import CHUNK_ELEMS
    from repro_torch.kernels.adamw_update import (adamw_update_cuda,
                                                  adamw_update_plain)
    from repro_torch.optim.adamw import AdamWConfig, bias_corrections

    record = KernelRows(peaks)
    gen = torch.Generator(device=dev).manual_seed(22)
    cfg = AdamWConfig(lr=1e-3)
    lr, (b1c, b2c) = 1e-3, bias_corrections(cfg, 3)
    clip = torch.tensor(0.5, device=dev)
    N = int(np.prod(ADAMW_LEAF))
    for extent, n in (("leaf", N), ("chunk", CHUNK_ELEMS)):
        for mode in ("f32", "split"):
            p, g, m, v, w = adamw_leaf_state(dev, n, mode, gen)
            twin = [clone_state(x) for x in (p, m, v, w)]
            leaf_update(adamw_update_cuda, cfg, lr, b1c, b2c, g, clip, m,
                        v, w, p)
            leaf_update(adamw_update_plain, cfg, lr, b1c, b2c, g, clip,
                        *twin[1:], twin[0])
            torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in zip(
                state_views(p, m, v, w), state_views(*twin))]
            check(all(same), f"adamw_update {mode} {extent}: the kernel's "
                  f"bytes are not its twin's (p, m, v, master[, scales]): "
                  f"{same}")
            lib = None
            if mode == "f32":
                # the twin's buffers, now free, as the library's state
                g32 = g.to(torch.float32)
                steps = [torch.tensor(3.0, device=dev)]

                def lib():
                    torch._fused_adamw_(
                        [twin[3]], [g32], [twin[1]], [twin[2]], [], steps,
                        lr=lr, beta1=cfg.b1, beta2=cfg.b2,
                        weight_decay=cfg.weight_decay, eps=cfg.eps,
                        amsgrad=False, maximize=False)
            rows = -(-n // 128)
            record("adamw_update",
                   f"{mode} {extent} {ADAMW_LEAF if extent == 'leaf' else n}",
                   lambda: leaf_update(adamw_update_cuda, cfg, lr, b1c, b2c,
                                       g, clip, m, v, w, p),
                   lambda: leaf_update(adamw_update_plain, cfg, lr, b1c,
                                       b2c, g, clip, *twin[1:], twin[0]),
                   lib, n * ADAMW_BYTES[mode] + rows * ADAMW_ROW_BYTES[mode],
                   n * ADAMW_OPS, peaks["f32"], 0.0,
                   dict(mode=mode, elements=n, bitwise=True,
                        launches=-(-n // CHUNK_ELEMS)),
                   plain_target_ms=1.0)
            del p, g, m, v, w, twin, lib
            torch.cuda.empty_cache()
    return record.rows


def runtime_train_path(cfg, dev, label, path="train", split_state=True):
    """TRAIN_STEPS steps of `cfg` (fp8_flow, full width) through
    train.loop.run: AdamW lr 1e-3 with StatePolicy() or the f32 state,
    the reference's default schedule, guard armed, make_batch's batches of
    TRAIN_B x TRAIN_S at steps 0..; no guard event may fire, and exactly
    the kernels of `path` launch.  Returns (launches, losses, peak GiB)."""
    from repro_torch import kernels
    from repro_torch.core.recipes import get_recipe
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.opt_state import StatePolicy
    from repro_torch.obs.sink import MemorySink, Telemetry
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.train.guards import GuardPlan, GuardPolicy
    from repro_torch.train.loop import run as run_loop
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt = AdamWConfig(lr=1e-3,
                      state_policy=StatePolicy() if split_state else None)
    guard = GuardPlan()
    state = init_train_state(cfg, opt, seed=0, device=dev, guard=guard)
    step = make_train_step(cfg, get_recipe("fp8_flow"), opt, guard=guard)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gib = torch.cuda.memory_allocated() / 2**30
    sink = MemorySink()
    pol = GuardPolicy()
    kernels.reset_launches()
    state, hist = run_loop(
        step, state, DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                global_batch=TRAIN_B),
        n_steps=TRAIN_STEPS, guard_policy=pol,
        telemetry=Telemetry(sinks=(sink,)), log_fn=lambda *a: None)
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in hist]
    ledger = sink.of_kind("cast_ledger")[0]
    want = casts_per_step(cfg, "fp8_flow")
    steps = sink.of_kind("step")
    warm = [h["device_ms"] for h in hist[1:]]
    print(json.dumps({label: dict(
        config=f"{cfg.name} n_layers={cfg.n_layers} full width",
        opt_state="StatePolicy()" if split_state else "f32",
        params=sum(p.numel() for p in tree_leaves(state["params"])),
        batch=[TRAIN_B, TRAIN_S], steps=TRAIN_STEPS, losses=losses,
        grad_norms=[r["grad_norm"] for r in steps],
        guard_flags=[r["guard_flags"] for r in steps],
        quant_sites=steps[-1].get("quant_sites"),
        device_ms=[h["device_ms"] for h in hist],
        fetch_ms=[h["fetch_ms"] for h in hist], init_s=init_s,
        ms_per_step_warm=statistics.mean(warm),
        tokens_per_s_warm=TRAIN_B * TRAIN_S * 1e3 / statistics.mean(warm),
        activation_casts_per_step=ledger["activation_casts"],
        state_gib=state_gib, max_memory_allocated_gib=peak_gib,
        launches=launches)}))
    check(all(np.isfinite(losses)), f"{label}: a non-finite loss {losses}")
    check(not pol.events, f"{label}: guard events {pol.events}")
    check(ledger["activation_casts"] == want,
          f"{label}: {ledger['activation_casts']} activation casts a step, "
          f"expected {want}")
    check_launches(path, launches)
    del state, step
    torch.cuda.empty_cache()
    return launches, losses, peak_gib


def tree_sha256(tree) -> str:
    """SHA-256 over every tensor byte of a state tree, in checkpoint
    order (the host step counter is not a tensor)."""
    from repro_torch.checkpoint.checkpointing import _flatten
    h = hashlib.sha256()
    for path, x in _flatten(tree):
        if torch.is_tensor(x):
            h.update(path.encode())
            h.update(x.detach().reshape(-1).contiguous().view(torch.uint8)
                     .cpu().numpy().tobytes())
    return h.hexdigest()


RUNTIME_STEPS, NAN_STEP, CKPT_EVERY = 8, 3, 2


def runtime_phase(cfg, dev, label="runtime"):
    """The runtime on the card: `cfg` (qwen15_05b whole) with StatePolicy()
    and the guard through loop.run for RUNTIME_STEPS steps, async
    checkpoints every CKPT_EVERY steps and JSONL telemetry into a
    temporary directory, a NaN injected into the entry quantizes at
    NAN_STEP: flagged nonfinite, skipped, every tensor byte unchanged
    (SHA-256).  Then a fresh state from another seed restarts from the
    step-4 checkpoint alone: restored bit for bit, and its losses within
    1e-5 relative of the uninterrupted run's.  Then one grad_accum=2 step.
    Returns the launches of the uninterrupted run."""
    import os
    import shutil
    import tempfile

    from repro_torch import kernels
    from repro_torch.checkpoint import checkpointing
    from repro_torch.core.recipes import get_recipe
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.dist.opt_state import StatePolicy
    from repro_torch.obs.sink import JsonlSink, Telemetry
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import fault_injection as fi
    from repro_torch.train import guards
    from repro_torch.train.loop import run as run_loop
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    opt = AdamWConfig(lr=1e-3, state_policy=StatePolicy())
    guard = guards.GuardPlan()
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B)
    fplan = fi.FaultPlan((fi.Fault("nan_activation", NAN_STEP, "q_entry"),))
    quiet = dict(log_fn=lambda *a: None, log_every=1000)

    def spied(step, hashes, at):
        """`step`, hashing the state before call i in `at` and after."""
        calls = [0]

        def fn(state, batch):
            i = calls[0]
            calls[0] += 1
            if i in at:
                hashes[("before", i)] = tree_sha256(state)
            out = step(state, batch)
            if i in at:
                hashes[("after", i)] = tree_sha256(out[0])
            return out
        return fn

    with tempfile.TemporaryDirectory() as tmp:
        ckpt, crashed = os.path.join(tmp, "ckpt"), os.path.join(tmp, "crash")
        jsonl = os.path.join(tmp, "run.jsonl")
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(cfg, opt, seed=0, device=dev, guard=guard)
        step = make_train_step(cfg, get_recipe("fp8_flow"), opt, guard=guard)
        hashes = {}
        pol = guards.GuardPolicy()
        tel = Telemetry(sinks=(JsonlSink(jsonl),))
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, full = run_loop(fplan.wrap(spied(step, hashes,
                                                (NAN_STEP, 4))),
                               state, data, n_steps=RUNTIME_STEPS,
                               ckpt_dir=ckpt, ckpt_every=CKPT_EVERY,
                               guard_policy=pol, fault_plan=fplan,
                               telemetry=tel, **quiet)
        run_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        tel.close()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        saved = checkpointing.completed_steps(ckpt)
        ckpt_bytes = {s: dir_bytes(os.path.join(ckpt, f"step_{s}"))
                      for s in saved}
        records = [json.loads(line) for line in open(jsonl)]
        del state, step
        torch.cuda.empty_cache()
        # a run that crashed after its step-4 checkpoint landed
        os.makedirs(crashed)
        shutil.copytree(os.path.join(ckpt, "step_4"),
                        os.path.join(crashed, "step_4"))
        state = init_train_state(cfg, opt, seed=1, device=dev, guard=guard)
        step = make_train_step(cfg, get_recipe("fp8_flow"), opt, guard=guard)
        rhash = {}
        msgs = []
        state, resumed = run_loop(spied(step, rhash, (0,)), state, data,
                                  n_steps=RUNTIME_STEPS, ckpt_dir=crashed,
                                  ckpt_every=100, log_every=1000,
                                  log_fn=msgs.append)
        del state, step
        torch.cuda.empty_cache()
    # one grad_accum=2 step: two microbatches of TRAIN_B // 2 sequences
    state = init_train_state(cfg, opt, seed=0, device=dev)
    step = make_train_step(cfg, get_recipe("fp8_flow"), opt, grad_accum=2)
    batch = {k: v.reshape(2, TRAIN_B // 2, *v.shape[1:])
             for k, v in make_batch(data, 0, device=dev).items()}
    state, m = step(state, batch)
    accum_loss = float(m["loss"])
    del state, step, batch
    torch.cuda.empty_cache()

    losses = [h["loss"] for h in full]
    events = [(e["step"], e["event"], e["flag_names"]) for e in pol.events]
    resumed_losses = {h["step"]: h["loss"] for h in resumed}
    rel = {s: abs(resumed_losses[s] - losses[s]) / abs(losses[s])
           for s in resumed_losses}
    kinds = [r["kind"] for r in records]
    print(json.dumps({label: dict(
        config=f"{cfg.name} n_layers={cfg.n_layers} full width",
        opt_state="StatePolicy()", steps=RUNTIME_STEPS, losses=losses,
        guard_events=events, run_s=run_s,
        # steps NAN_STEP and 4 hash the state inside their device span
        device_ms=[h["device_ms"] for h in full], hashed_steps=[NAN_STEP, 4],
        fetch_ms=[h["fetch_ms"] for h in full],
        max_memory_allocated_gib=peak_gib,
        checkpoints=saved, checkpoint_bytes=ckpt_bytes,
        sha256_nan_step={k: hashes[(k, NAN_STEP)][:16]
                         for k in ("before", "after")},
        sha256_step4=hashes[("after", 4)][:16],
        sha256_restored=rhash[("before", 0)][:16],
        resumed_losses=resumed_losses, resumed_rel_diff=rel,
        grad_accum2_loss=accum_loss,
        jsonl_records={k: kinds.count(k) for k in sorted(set(kinds))},
        launches=launches)}))
    check(events == [(NAN_STEP, "skip", "nonfinite_loss|nonfinite_grad"),
                     (NAN_STEP + 1, "recovered", "none")],
          f"{label}: guard events {events}")
    check(not np.isfinite(losses[NAN_STEP]) and all(
        np.isfinite(l) for i, l in enumerate(losses) if i != NAN_STEP),
        f"{label}: losses {losses}")
    check(hashes[("before", NAN_STEP)] == hashes[("after", NAN_STEP)],
          f"{label}: the skipped step changed the state")
    check(saved == [2, 4, 6], f"{label}: checkpoints {saved}")
    check("[loop] restored checkpoint step=4" in msgs,
          f"{label}: the restart did not restore step 4: {msgs}")
    check(rhash[("before", 0)] == hashes[("after", 4)],
          f"{label}: the restored state is not the step-4 state")
    check(sorted(resumed_losses) == list(range(5, RUNTIME_STEPS)),
          f"{label}: resumed steps {sorted(resumed_losses)}")
    check(all(r <= 1e-5 for r in rel.values()),
          f"{label}: resumed losses {resumed_losses} vs {losses}")
    check(np.isfinite(accum_loss), f"{label}: grad_accum=2 loss")
    check(kinds.count("step") == RUNTIME_STEPS and "guard" in kinds
          and "cast_ledger" in kinds and kinds.count("ckpt_save") == 3,
          f"{label}: JSONL records {kinds}")
    check_launches("qwen15_train", launches)
    return launches


# ---------------------------------------------------------------------------
# Phases 27-29: the activation-residency plan and the flash-attention VJP.
# ---------------------------------------------------------------------------
REMAT_POLICIES = ("none", "full", "fp8_resident", "pair")
# the flash VJP against autograd through the plain loop, f32 inputs:
# max |vjp - plain| / max |plain| (the two sum in other orders; dk and dv
# sum 3072 x 7 products a lane at llava's shape, where the H100 reads
# 7.4e-6): the CPU test's bar
FLASH_REL = 1e-5


def layer_kept_bytes(cfg, policy, dev, B=TRAIN_B, S=TRAIN_S):
    """One layer's forward under `policy` on the card (the first MoE layer,
    or the first layer; fp8_flow; random bf16 params from seed 0 and a
    random (B, S, D) input): the bytes it leaves allocated for the
    backward (memory_allocated after less before: what autograd saved
    outside a checkpoint, the block's stash), those tensors in the
    reference's buckets (train/memory.py), and layer_saved_bytes_model."""
    from repro_torch.models.lm import first_layer, init_params
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.memory import (MemoryPlan, classify_residuals,
                                          layer_loss, layer_saved_bytes_model,
                                          saved_residuals)
    recipe = recipe_for("train")
    params = init_params(cfg, seed=0, device=dev)
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    kind, moe, p = first_layer(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = (torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
         * STUB_SCALE).to(torch.bfloat16).requires_grad_()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    res = saved_residuals(MemoryPlan(policy),
                          layer_loss(cfg, recipe, kind, moe), p, x)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - before
    out = dict(kept_bytes=kept,
               buckets=classify_residuals(res, B * S * cfg.d_model),
               model_bytes=layer_saved_bytes_model(cfg, B * S, policy))
    del res, params, p, x
    gc.collect()             # a checkpoint frame's cycle holds the layer
    torch.cuda.empty_cache()
    return out


def policy_phase(dev, arch="deepseek_v2_lite", n_layers=DSV2_TRAIN_LAYERS,
                 label="dsv2_train"):
    """Phase 27: `arch` at full width and depth n_layers trained as phase
    6 (fp8_flow, the f32 state, the fixed batch, TRAIN_STEPS steps) under
    each remat policy: every policy's losses 'none''s bit for bit, its
    casts a step, exactly its kernels; ms a step, peak GiB and one
    layer's kept bytes beside the model's, 'fp8_resident' keeping no wide
    bf16 tensor.  Returns the launches of the 'full' run (the config's
    default)."""
    base = arch_config(arch)
    layer_cfg = arch_config(arch, base.n_dense_layers + 1 if base.moe else 1)
    rows, launches, losses = {}, {}, {}
    for policy in REMAT_POLICIES:
        cfg = dataclasses.replace(arch_config(arch, n_layers),
                                  remat_policy=policy)
        row = {}
        launches[policy], losses[policy], _ = train_path(
            cfg, dev, label, name=f"{label}[{policy}]", record=row)
        rows[policy] = dict(
            ms_per_step_warm=row["ms_per_step_warm"],
            tokens_per_s_warm=row["tokens_per_s_warm"],
            max_memory_allocated_gib=row["max_memory_allocated_gib"],
            activation_casts_per_step=row["activation_casts_per_step"],
            losses=losses[policy],
            layer=layer_kept_bytes(layer_cfg, policy, dev))
    print(json.dumps({"remat_policies": dict(
        config=f"{arch} n_layers={n_layers} full width, fp8_flow, f32 state",
        batch=[TRAIN_B, TRAIN_S], by_policy=rows)}))
    for policy in REMAT_POLICIES:
        check(losses[policy] == losses["none"],
              f"{arch} under {policy}: losses {losses[policy]}, not "
              f"'none''s {losses['none']} bit for bit")
    kept = rows["fp8_resident"]["layer"]["buckets"]
    check(kept["wide_bf16"] == 0 and kept["fp8"] > 0,
          f"fp8_resident keeps a wide bf16 tensor or no e4m3: {kept}")
    return launches["full"]


def flash_vjp_phase(dev, arch="llava_next_34b"):
    """Phase 28: the flash-attention VJP at `arch`'s full-width attention
    (1 x (prefix + LLAVA_TOKENS) rows, causal, its heads): with f32
    inputs, the output and dq, dk, dv of the Function against autograd
    through the plain loop, max |vjp - plain| / max |plain| within the CPU
    test's FLASH_REL (tests/test_torch_flash_vjp.py); with bf16 inputs
    (the train path's), each way's bytes kept for the backward, and one
    backward's ms and peak bytes above what was allocated before it."""
    from repro_torch.models.layers import (flash_attention,
                                           flash_attention_plain)
    cfg = arch_config(arch)
    S = cfg.frontend_len + LLAVA_TOKENS
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(13)
    pos = torch.arange(S, device=dev)
    base = [torch.randn(shape, generator=gen, device=dev) for shape in (
        (1, S, H, hd), (1, S, KV, hd), (1, S, KV, hd), (1, S, H, hd))]

    def leaf(t, dtype):
        return t.to(dtype, copy=True).requires_grad_()
    ways = (("vjp", flash_attention), ("plain", flash_attention_plain))

    def run(fn, dtype, timed=False):
        q, k, v = (leaf(t, dtype) for t in base[:3])
        g = base[3].to(dtype)
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        out = fn(q, k, v, q_pos=pos, kv_pos=pos, causal=True)
        torch.cuda.synchronize()
        row = {"saved_bytes": torch.cuda.memory_allocated() - start
               - out.numel() * out.element_size()}
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        out.backward(g)
        t1.record()
        torch.cuda.synchronize()
        row.update(bwd_ms=t0.elapsed_time(t1),
                   bwd_peak_bytes=torch.cuda.max_memory_allocated() - before)
        return row, [out.detach(), q.grad, k.grad, v.grad]

    got = {name: run(fn, torch.float32)[1] for name, fn in ways}
    rel = {n: (float((a - b).abs().max()) / float(b.abs().max()))
           for n, a, b in zip(("out", "dq", "dk", "dv"), got["vjp"],
                              got["plain"])}
    del got
    torch.cuda.empty_cache()
    rows = {}
    for name, fn in ways:
        run(fn, torch.bfloat16)                     # warm-up
        rows[name] = run(fn, torch.bfloat16)[0]
        torch.cuda.empty_cache()
    print(json.dumps({"flash_vjp": dict(
        config=f"{arch} attention: 1 x {S} rows, {H} heads, {KV} kv heads, "
               f"head_dim {hd}, causal, block 256",
        f32_max_rel_vs_plain=rel, bf16=rows)}))
    check(all(r <= FLASH_REL for r in rel.values()),
          f"flash VJP gradients off autograd's through the plain loop: {rel}")
    check(rows["vjp"]["saved_bytes"] < rows["plain"]["saved_bytes"],
          f"the flash VJP keeps no less than autograd: {rows}")


# ---------------------------------------------------------------------------
# Phases 30-32: the prefix cache, the disaggregated fleet, the launcher.
# ---------------------------------------------------------------------------
# the engine of phases 30-31: the serve path's, with page-aligned prefill
# chunks (prefill_chunk == page_size), which make a cache hit's chunks the
# same as a miss's, so cache on and off must serve the same bits
PREFIX_ECFG = dict(max_batch=8, page_size=8, n_pages=128,
                   max_pages_per_req=8, token_budget=512,
                   prefill_buckets=(16, 32, 64), prefill_chunk=8,
                   fp8_kv=True, w8_weights=True, seed=0)
# the hits prefix_trace is built for: each tenant's 2nd and 3rd request,
# the repeat and the divergent one (the port's CPU run of the same trace
# geometry counts these: tests/test_torch_prefix_cache.py)
PREFIX_HITS = 10
# a pool small enough that the cache must give up leaves (cache_evictions
# > 0 in the CPU run of the same geometry) and still every request fits
PRESSURE_PAGES = 40
# phase 31's tight-budget run: the decode tier's token budget, cut from 512
# to about three requests.  At 512 the tier is bound by its 8 slots, which
# free one a tick (every request decodes the same 15 tokens after its
# adoption), so at most one migration is ever ready in a drain cycle and
# no transfer budget can defer one; bound by tokens, one finish can admit
# two short requests at once (3 deferrals in the CPU run of this geometry)
TIGHT_DECODE_BUDGET = 160


def prefix_trace(vocab):
    """Phase 30's trace: 16 greedy requests of 16 new tokens, prompts from
    default_rng(0).  4 tenants x 3 requests, each a 32-token tenant prefix
    (4 pages) and a 1-16-token tail (tenant 0's first tail is 8: a
    40-token prompt); one repeat of that 40-token prompt whole (a
    whole-prompt hit: the copy-on-write case); one sharing the first 16
    tokens of tenant 1's prefix and then its own 20 (a hit that splits a
    radix edge mid-way); two sharing nothing."""
    from repro_torch.serve.scheduler import Request
    r = np.random.default_rng(0)

    def toks(n):
        return [int(t) for t in r.integers(1, vocab, n)]
    tenants = [toks(32) for _ in range(4)]
    rounds = [[t + toks(8 if i == j == 0 else int(r.integers(1, 17)))
               for j, t in enumerate(tenants)] for i in range(3)]
    prompts = (rounds[0] + [toks(int(r.integers(3, 49)))] + rounds[1]
               + [list(rounds[0][0]), tenants[1][:16] + toks(20)]
               + rounds[2] + [toks(int(r.integers(3, 49)))])
    return [Request(prompt=p, max_new_tokens=16) for p in prompts]


def run_trace(runner, reqs):
    """Drive `reqs` closed-loop through an engine or a router; returns
    (tokens by request, stats, seconds, launches)."""
    from repro_torch import kernels
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = runner.run(reqs, realtime=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(len(results) == len(reqs), "not every request finished")
    tokens = [results[q.rid]["tokens"] for q in reqs]
    check(all(len(t) == q.max_new_tokens for t, q in zip(tokens, reqs)),
          "a request stopped short of max_new_tokens")
    return tokens, results.stats, dt, dict(kernels.LAUNCHES)


def check_cache_clean(eng, what):
    """After a run: the radix tree's invariants hold, every live page is
    the cache's and held by it alone (no request leaked a reference)."""
    pc = eng.prefix_cache
    pc.check_invariants(eng.alloc)
    check(eng.sched.idle(), f"{what}: the engine is not idle")
    check(eng.alloc.live_pages == pc.n_cached_pages,
          f"{what}: {eng.alloc.live_pages} live pages, "
          f"{pc.n_cached_pages} cached")
    check(all(eng.alloc.refcount(p) == 1
              for n in pc._iter_nodes() for p in n.pages),
          f"{what}: a cached page is still referenced by a request")


def hist_quantiles(tel, name):
    from repro_torch.serve.engine import _LAT_BUCKETS
    h = tel.histogram(name, edges=_LAT_BUCKETS)
    return dict(n=h.count, p50=h.quantile(0.5), p99=h.quantile(0.99),
                mean=h.mean)


def prefix_cache_phase(cfg, dev, params):
    """Phase 30: prefix_trace through the serve path's engine (W8 experts,
    FP8 KV, PREFIX_ECFG) with the cache off, on, and on over a pool of
    PRESSURE_PAGES pages.  Gates: the same tokens bit for bit in all
    three; PREFIX_HITS hits of 16 lookups; a clean cache; fewer launches
    of every serve kernel with the cache (its skipped chunks launch
    nothing); exactly the serve path's kernels; cache evictions under
    pressure.  Returns (launches of the cache run, its tokens)."""
    from repro_torch.obs.sink import Telemetry
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    t_phase = time.perf_counter()
    runs = {}
    for name, kw in (("off", {}), ("on", dict(prefix_cache=True)),
                     ("pressure", dict(prefix_cache=True,
                                       n_pages=PRESSURE_PAGES))):
        torch.cuda.reset_peak_memory_stats()
        tel = Telemetry()
        eng = ServeEngine(cfg, recipe_for("serve"), params,
                          ServeConfig(**{**PREFIX_ECFG, **kw}), device=dev,
                          telemetry=tel)
        reqs = prefix_trace(cfg.vocab)
        tokens, stats, dt, launches = run_trace(eng, reqs)
        n_tok = sum(len(t) for t in tokens)
        runs[name] = dict(tokens=tokens, stats=stats, launches=launches,
                          row=dict(
            seconds=dt, tokens_per_s=n_tok / dt, ticks=stats["ticks"],
            prefill_chunks=stats["prefill_chunks"],
            evicted=stats["evicted"],
            tokens_sha256=hashlib.sha256(
                json.dumps(tokens).encode()).hexdigest(),
            ttft_ms=hist_quantiles(tel, "serve_ttft_ms"),
            tbt_ms=hist_quantiles(tel, "serve_tbt_ms"),
            max_memory_allocated_gib=torch.cuda.max_memory_allocated()
            / 2**30,
            launches={k: n for k, n in launches.items() if n}))
        if eng.prefix_cache is not None:
            runs[name]["row"].update({k: stats[k] for k in (
                "prefix_lookups", "prefix_hits", "prefix_hit_tokens",
                "shared_pages", "cache_evictions", "cache_evicted_pages")})
            check_cache_clean(eng, f"prefix cache {name}")
        else:
            check(eng.alloc.free_pages == eng.ecfg.n_pages - 1,
                  "cache off: pages were not returned")
        del eng
        torch.cuda.empty_cache()
    print(json.dumps({"prefix_cache": dict(
        config=f"{cfg.name} n_layers={cfg.n_layers} full width, fp8_flow, "
               f"W8 experts, FP8 KV, page 8, prefill chunk 8",
        trace="16 greedy requests x 16 new tokens, closed loop (not a "
              "benchmark): 4 tenants x 3 (32-token prefix + 1-16 tail), a "
              "whole repeat, a mid-edge divergence, two unrelated",
        pressure_n_pages=PRESSURE_PAGES,
        seconds=time.perf_counter() - t_phase,
        by_run={n: r["row"] for n, r in runs.items()})}))
    on, off = runs["on"], runs["off"]
    check(on["tokens"] == off["tokens"],
          "prefix cache on: other tokens than with the cache off")
    check(runs["pressure"]["tokens"] == off["tokens"],
          "prefix cache under pool pressure: other tokens than cache off")
    check(on["stats"]["prefix_lookups"] == 16
          and on["stats"]["prefix_hits"] == PREFIX_HITS,
          f"prefix cache: {on['stats']['prefix_hits']} hits of "
          f"{on['stats']['prefix_lookups']} lookups, not {PREFIX_HITS} of 16")
    check(runs["pressure"]["stats"]["cache_evictions"] > 0,
          f"no cache eviction over {PRESSURE_PAGES} pages")
    check(on["stats"]["prefill_chunks"] < off["stats"]["prefill_chunks"],
          "the cache skipped no prefill chunk")
    check(all(on["launches"][k] < off["launches"][k]
              for k in PATH_KERNELS["serve"]),
          f"the cache run launched no fewer serve kernels: {on['launches']}"
          f" vs {off['launches']}")
    check_launches("prefix_serve", on["launches"])
    return on["launches"], on["tokens"]


def migrated_pages_equal(pe, de, reqs):
    """Every cached prompt page of the prefill tier against the decode
    tier's page for the same blocks, byte for byte (payload and exponents,
    gathered one page at a time: a bucket's padding is scratch)."""
    compared = 0
    for q in reqs:
        for s, t in zip(pe.prefix_cache.match_pages(q.prompt),
                        de.prefix_cache.match_pages(q.prompt)):
            a = pe.codec._gather(pe.pools, pe.codec._pad_ids([s]))
            b = de.codec._gather(de.pools, de.codec._pad_ids([t]))
            check(torch.equal(a, b), f"migrated page {s} -> {t} differs")
            compared += 1
    return compared


def fleet_phase(cfg, dev, params, mixed_tokens):
    """Phase 31: one prefill and one decode ServeEngine (PREFIX_ECFG, the
    cache on), both on `dev` under DisaggRouter, serving prefix_trace:
    phase 30's cache-on tokens bit for bit, 16 migrations, pages deduped
    on the receiver, the migrated pages byte-equal on both tiers, no page
    leaked, the wire bytes the sum of bytes_for over the migrations; then
    the same under a budget of one 4-page batch (deferrals, the same
    tokens, with the decode tier's token budget at TIGHT_DECODE_BUDGET);
    the codec casting-free on the card's pools.  Returns the first run's
    launches."""
    from repro_torch.obs.sink import MemorySink, Telemetry
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.router import DisaggConfig, DisaggRouter
    t_phase = time.perf_counter()

    def fleet(tel, decode_budget=PREFIX_ECFG["token_budget"]):
        return [ServeEngine(cfg, recipe_for("serve"), params, ServeConfig(
                    **{**PREFIX_ECFG, "token_budget": budget},
                    prefix_cache=True, role=role), device=dev,
                    telemetry=tel)
                for role, budget in (
                    ("prefill", PREFIX_ECFG["token_budget"]),
                    ("decode", decode_budget))]

    torch.cuda.reset_peak_memory_stats()
    sink = MemorySink()
    tel = Telemetry(sinks=(sink,))
    pe, de = fleet(tel)
    router = DisaggRouter([pe], [de], telemetry=tel)
    reqs = prefix_trace(cfg.vocab)
    tokens, stats, dt, launches = run_trace(router, reqs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    d = stats["disagg"]
    migs = sink.of_kind("migration")
    bpp = 2 * cfg.n_layers * PREFIX_ECFG["page_size"] * cfg.n_kv * (
        cfg.head_dim + 1)
    check(pe.codec.bytes_per_page == bpp,
          f"bytes_per_page {pe.codec.bytes_per_page}, not {bpp}")
    check(tokens == mixed_tokens,
          "the fleet served other tokens than the cache-on mixed engine")
    check(d["migrations"] == 16 and len(migs) == 16,
          f"{d['migrations']} migrations, not 16")
    check(d["deduped_pages"] > 0, "the receiver deduped no page")
    check(d["kv_transfer_bytes"] == sum(
        pe.codec.bytes_for(m["shipped_pages"]) for m in migs)
        == sum(m["bytes"] for m in migs),
        f"kv_transfer_bytes {d['kv_transfer_bytes']} is not the sum of "
        f"bytes_for over the migrations")
    compared = migrated_pages_equal(pe, de, reqs)
    check(compared > 0, "no migrated page compared")
    for eng, what in ((pe, "prefill tier"), (de, "decode tier")):
        check_cache_clean(eng, what)
    pe.codec.assert_casting_free(pe.pools)
    de.codec.assert_casting_free(de.pools)
    row = dict(
        seconds=dt, tokens_per_s=sum(map(len, tokens)) / dt,
        migrations=d["migrations"], shipped_pages=d["shipped_pages"],
        deduped_pages=d["deduped_pages"],
        wire_mib=d["kv_transfer_bytes"] / 2**20,
        bytes_per_page=pe.codec.bytes_per_page,
        migration_ms=dict(p50=statistics.median(m["ms"] for m in migs),
                          max=max(m["ms"] for m in migs)),
        ticks=stats["ticks"], prefix_hits=stats["prefix_hits"],
        max_memory_allocated_gib=peak, pages_compared=compared,
        casting_free_on=str(pe.pools["main_attn"]["k"]["data"].device),
        launches={k: n for k, n in launches.items() if n})
    del router, pe, de
    torch.cuda.empty_cache()

    pe, de = fleet(None, TIGHT_DECODE_BUDGET)
    budget = pe.codec.bytes_for(4)
    router = DisaggRouter([pe], [de], dcfg=DisaggConfig(
        transfer_budget_bytes=budget))
    tight, tstats, tdt, _ = run_trace(router, prefix_trace(cfg.vocab))
    td = tstats["disagg"]
    check(tight == mixed_tokens, "the fleet under a tight transfer budget "
          "served other tokens")
    check(td["budget_deferrals"] > 0,
          f"no deferral under a {budget}-byte budget")
    del router, pe, de
    torch.cuda.empty_cache()
    print(json.dumps({"disagg_fleet": dict(
        config=f"{cfg.name} n_layers={cfg.n_layers} full width: 1 prefill + "
               f"1 decode engine on one card, each its own W8 experts",
        trace="phase 30's, closed loop (not a benchmark)",
        seconds=time.perf_counter() - t_phase, run=row,
        tight_budget=dict(transfer_budget_bytes=budget,
                          decode_token_budget=TIGHT_DECODE_BUDGET,
                          seconds=tdt,
                          budget_deferrals=td["budget_deferrals"],
                          migrations=td["migrations"],
                          reserve_failures=td["reserve_failures"]))}))
    check_launches("fleet_serve", launches)
    return launches


def launcher_phase(out_dir):
    """Phase 32: the serve launcher in a subprocess on the card: qwen15_05b
    whole with the prefix cache as a 1 + 1 fleet, telemetry to JSONL and
    Prometheus; then the reporter over the JSONL.  Gates: both exit 0, the
    record kinds the fleet writes, the report's serve and disagg
    sections."""
    import os
    t_phase = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    jsonl, prom = out_dir / "serve.jsonl", out_dir / "serve.prom"
    for f in (jsonl, prom):
        if f.exists():
            f.unlink()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen15_05b", "--device", "cuda", "--prefix-cache", "--disagg",
           "--obs-jsonl", str(jsonl), "--obs-prom", str(prom)]
    serve = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=600)
    print(serve.stdout.strip())
    check(serve.returncode == 0,
          f"the launcher exited {serve.returncode}: {serve.stderr[-2000:]}")
    kinds = {json.loads(line)["kind"] for line in jsonl.read_text()
             .splitlines() if line.strip()}
    want = {"serve_tick", "request_done", "migration", "disagg_summary"}
    check(want <= kinds, f"the launcher's JSONL lacks {want - kinds}")
    check("serve_ttft_ms" in prom.read_text(),
          "the Prometheus snapshot has no serve_ttft_ms")
    report = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(jsonl)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    print(report.stdout.strip())
    check(report.returncode == 0,
          f"the reporter exited {report.returncode}: {report.stderr[-2000:]}")
    check("== serve:" in report.stdout
          and "== disaggregation:" in report.stdout,
          "the report lacks its serve or disagg section")
    print(json.dumps({"launcher": dict(
        command=" ".join(cmd[1:]), record_kinds=sorted(kinds),
        seconds=time.perf_counter() - t_phase)}))


# ---------------------------------------------------------------------------
# Phases 33-36: stage ranges, the roofline, the chunked MoE blocks and the
# expected_m hint.
# ---------------------------------------------------------------------------
# profiler ranges of the port (obs/trace.py, train/memory.py,
# models/layers.py): not kernels, so left out of the busy time
RANGE_PREFIXES = ("stage/", "remat/", "flash_", "host/", "quant_weights")


def _device_us_by_launch(prof) -> dict:
    """{correlation id: device us} of the profile's kernels, copies and
    sets (the ranges' own device-side spans left out)."""
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not e.name.startswith(RANGE_PREFIXES):
            out[e.id] = out.get(e.id, 0.0) + (e.time_range.end
                                              - e.time_range.start)
    return out


def busy_device_ms(prof) -> float:
    """The device time of a profile's kernels, copies and sets."""
    return sum(_device_us_by_launch(prof).values()) / 1e3


def range_device_ms(prof, names) -> dict:
    """Device ms of the work launched inside each named profiler range: a
    kernel (copy, set) belongs to a range when the CUDA API call that
    launched it (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...)
    ran inside the range's interval.  The launch's time is used, not the
    profiler's op tree: a kernel the port launches through ctypes inside a
    range (no aten op open) is linked to no op, and the profiler's own
    device-side span of a range (its first to its last correlated GPU
    activity) can cover a whole train step.  Ranges are matched by time
    alone: in these passes one thread launches at a time (the forward's,
    then autograd's with the recompute), and a name's intervals do not
    nest."""
    import bisect
    dev_us = _device_us_by_launch(prof)
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    launches = [(e.time_range.start, dev_us[e.id]) for e in events
                if e.device_type == cpu and e.name.startswith("cu")
                and e.id in dev_us]
    out = {}
    for name in names:
        iv = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == cpu and e.name == name)
        starts = [a for a, _ in iv]
        us = 0.0
        for t, d in launches:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and iv[i][1] >= t:
                us += d
        out[name] = us / 1e3
    return out


def stage_breakdown(prof) -> dict:
    """Busy device ms and the device ms of the kernels launched inside
    each stage/* range of a profile."""
    busy = busy_device_ms(prof)
    by_range = range_device_ms(prof, [f"stage/{s}" for s in STAGES])
    stages = {s: by_range[f"stage/{s}"] for s in STAGES}
    check(busy > 0, "the profiler recorded no device time")
    check(sum(stages.values()) <= busy * 1.001,
          f"the stages' device ms {stages} exceed the busy {busy} ms")
    return dict(busy_ms=busy, stage_ms=stages,
                stage_share=sum(stages.values()) / busy)


def profiled(fn):
    """fn() under torch.profiler (CPU + CUDA activity): (its result, the
    profile)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof


@contextlib.contextmanager
def annotate_patched_out():
    """obs.trace.annotate as a bare null context (no profiler check)."""
    from repro_torch.obs import trace
    orig = trace.annotate
    trace.annotate = lambda name: contextlib.nullcontext()
    try:
        yield
    finally:
        trace.annotate = orig


def expert_gemm_flops(cfg, C, units, layers=None) -> float:
    """`units` x 2 E C D F: an expert GEMM pass of a MoE layer at capacity
    C (GEMM-1 is 2 units, GEMM-2 one), over the config's MoE layers."""
    layers = cfg.n_layers if layers is None else layers
    return units * 2.0 * cfg.n_experts * C * cfg.d_model * cfg.d_ff_expert \
        * layers


def roofline_row(name, t, model_flops, ms, want_gemm):
    """The roofline line of a tallied call: the tally's terms on the H100
    SXM, the measured ms, the mfu; the kernels' GEMM FLOPs must be the
    analytic `want_gemm`."""
    from repro_torch.roofline import analysis
    roof = analysis.analyze_tally(t, model_flops_global=model_flops)
    kernel_gemm = t.gemm_flops - t.aten_flops
    check(kernel_gemm == want_gemm, f"roofline {name}: the kernels report "
          f"{kernel_gemm} GEMM FLOPs, the analytic count is {want_gemm}")
    row = dict(call=name, flops=roof.flops, hbm_bytes=roof.hbm_bytes,
               kernel_gemm_flops=kernel_gemm, aten_flops=t.aten_flops,
               t_compute_ms=roof.t_compute * 1e3,
               t_memory_ms=roof.t_memory * 1e3, bottleneck=roof.bottleneck,
               bound_ms=roof.step_time * 1e3, measured_ms=ms,
               bound_share=roof.step_time * 1e3 / ms,
               model_flops=model_flops,
               mfu=analysis.measured_mfu(model_flops, ms / 1e3),
               kernels={k: v for k, v in t.kernels().items()})
    print(json.dumps({"roofline": row}))
    return row


def stage_and_roofline_phase(dev, train_losses, serve_tokens):
    """Phases 33-34 on qwen3_moe_235b at full width.  Train (1 layer,
    fp8_flow, the f32 state, phase 6's batch and seed): step 1 plain, step
    2 under torch.profiler (the stage ranges open), step 3 with annotate
    patched out, step 4 plain: the losses phase 6's bit for bit; step 5
    inside the roofline tally.  Serve (depth 4, W8, phase 3's trace):
    warm-up, plain, annotate patched out, profiled: phase 3's tokens every
    time; then a bucket-64 prefill and an 8-slot decode step timed, and
    each tallied.  Busy ms per stage (their sum at most the busy ms);
    tokens/s with the ranges and with annotate patched out; FLOPs, bytes,
    the compute and memory terms, the bottleneck, the measured ms and the
    mfu of the train step, the prefill and the decode step, the kernels'
    GEMM FLOPs equal to the analytic count."""
    from repro_torch.core import casts
    from repro_torch.models.lm import paged_decode_step, paged_prefill
    from repro_torch.roofline import analysis

    t_phase = time.perf_counter()
    cfg = train_config()
    state, step, batch = make_train(cfg, dev, "train")
    box = {"state": state}
    del state
    losses, step_ms, rows = [], [], {}

    def one():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with casts.ledger():
            box["state"], m = step(box["state"], batch)
            loss = float(m["loss"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)

    one()
    _, prof = profiled(one)
    rows["train_profiled"] = stage_breakdown(prof)
    del prof
    with annotate_patched_out():
        one()
    one()
    check(losses == list(train_losses), f"train losses {losses} with the "
          f"ranges / patched out, not phase 6's {list(train_losses)}")
    with analysis.tally() as t:
        box["state"], m = step(box["state"], batch)
        torch.cuda.synchronize()
    tokens = TRAIN_B * TRAIN_S
    C = train_capacity(cfg)
    roof = {"train": roofline_row(
        "train_step", t, analysis.model_flops_train(cfg, tokens),
        step_ms[3], expert_gemm_flops(cfg, C, 11))}
    rows["train"] = dict(losses=losses, step_ms=step_ms,
                         ms_plain=step_ms[3], ms_profiled=step_ms[1],
                         ms_annotate_out=step_ms[2])
    box.clear()
    del step, batch, t, m
    torch.cuda.empty_cache()

    scfg = serve_config()
    eng, reqs = make_serve(scfg, dev)
    runs = {}

    def serve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(reqs, realtime=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        toks = [res[q.rid]["tokens"] for q in reqs]
        check(toks == serve_tokens, "a served pass of phase 33 generated "
              "other tokens than phase 3")
        return sum(len(x) for x in toks) / dt

    serve()                                           # warm-up
    runs["with_ranges"] = serve()
    with annotate_patched_out():
        runs["annotate_out"] = serve()
    runs["profiled"], prof = profiled(serve)
    rows["serve_profiled"] = stage_breakdown(prof)
    del prof
    rows["serve_tokens_per_s"] = runs

    with torch.inference_mode():
        page_row = torch.arange(1, 9, device=dev)
        pf_tokens = torch.ones((1, 64), dtype=torch.int64, device=dev)
        dec = (page_row.repeat(8, 1),
               torch.ones((8, 1), dtype=torch.int64, device=dev),
               torch.full((8,), 48, device=dev),
               torch.ones((8,), dtype=torch.bool, device=dev))
        calls = {
            "prefill_bucket64": (lambda: paged_prefill(
                scfg, eng.recipe, eng.params, eng.pools, page_row,
                pf_tokens, 48), 64, expert_gemm_flops(scfg, 128, 3)),
            "decode_step_b8": (lambda: paged_decode_step(
                scfg, eng.recipe, eng.params, eng.pools, *dec), 8,
                expert_gemm_flops(scfg, 8, 3))}
        for name, (fn, n_tok, want) in calls.items():
            fn()
            ms = call_ms(fn, n=5, reps=3)
            with analysis.tally() as t:
                fn()
                torch.cuda.synchronize()
            roof[name] = roofline_row(
                name, t, analysis.model_flops_decode(scfg, n_tok), ms, want)
    del eng
    torch.cuda.empty_cache()
    print(json.dumps({"stages": dict(
        config="qwen3_moe_235b full width: train 1 layer (fp8_flow, f32 "
               "state), serve 4 layers (W8, FP8 KV)",
        **rows, seconds=time.perf_counter() - t_phase)}))
    return rows, roof


@contextlib.contextmanager
def recorded_block_stats():
    """Each MoE block call's drop_frac and expert-plan overflow (the
    assignments that found no expert slot: their rows drop silently, as in
    the reference), kept on the device, by call."""
    from repro_torch.core import moe
    from repro_torch.models import lm
    calls = {"drop": [], "overflow": [], "assigned": []}
    origs = (lm.moe_block, lm.moe_block_overlapped, moe._expert_plan)

    def block(fn):
        def spy(*a, **kw):
            y, m = fn(*a, **kw)
            calls["drop"].append(m["drop_frac"].detach().clone())
            return y, m
        return spy

    def expert_plan(recv_expert, E_loc, C_exp):
        rme, ret = origs[2](recv_expert, E_loc, C_exp)
        calls["overflow"].append(((recv_expert >= 0) & (ret < 0)).sum())
        calls["assigned"].append((recv_expert >= 0).sum())
        return rme, ret

    lm.moe_block, lm.moe_block_overlapped = block(origs[0]), block(origs[1])
    moe._expert_plan = expert_plan
    try:
        yield calls
    finally:
        lm.moe_block, lm.moe_block_overlapped, moe._expert_plan = origs


OVERLAP_CHUNKS = (1, 2, 4)
OVERLAP_STEPS = 3


def overlap_train_run(cfg, dev, label, n):
    """OVERLAP_STEPS steps of qwen3 (1 layer, full width) with the FP8-split
    state (the chunked backward's f32 weight-gradient sums need the room
    the f32 state leaves no space for), chunked at n (None: the
    monolithic block).  Returns its row."""
    from repro_torch import kernels
    from repro_torch.core import casts
    from repro_torch.core.moe import DispatchPlan, _chunk_geometry
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.dist.opt_state import StatePolicy
    from repro_torch.models.lm import ParallelPlan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig(lr=1e-3, state_policy=StatePolicy())
    plan = None if n is None else DispatchPlan(n_chunks=n,
                                               min_chunk_tokens=1)
    recipe = recipe_for(label)
    state = init_train_state(cfg, opt, seed=0, device=dev)
    step = make_train_step(cfg, recipe, opt,
                           plan=ParallelPlan(moe_overlap=plan))
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                  global_batch=TRAIN_B), 0, device=dev)
    losses, step_ms, n_casts = [], [], []
    with recorded_block_stats() as calls, recorded_plans() as plans:
        kernels.reset_launches()
        for _ in range(OVERLAP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with casts.ledger() as led:
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            n_casts.append(led.activation_casts())
        launches = dict(kernels.LAUNCHES)
    chunks = 1 if n is None else n
    C = _chunk_geometry(recipe, moe_config(cfg), TRAIN_B * TRAIN_S, chunks,
                        1, cfg.n_experts)[3]
    # the first forward's calls: one block, `chunks` expert plans
    over = [int(v) for v in calls["overflow"][:chunks]]
    assigned = [int(v) for v in calls["assigned"][:chunks]]
    row = dict(
        n_chunks=n, recipe=recipe.name, masked=recipe.masked_experts,
        losses=losses, step_ms=step_ms,
        ms_per_step_warm=statistics.mean(step_ms[1:]),
        tokens_per_s_warm=TRAIN_B * TRAIN_S * 1e3
        / statistics.mean(step_ms[1:]),
        capacity_per_chunk=C, padded_rows=chunks * cfg.n_experts * C,
        activation_casts_per_step=n_casts,
        drop_frac=float(calls["drop"][0]),
        expert_overflow=sum(over), expert_overflow_frac=sum(over)
        / max(sum(assigned), 1),
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches)
    check(all(c == 2 for c in n_casts), f"{label} n={n}: casts {n_casts}")
    check(all(np.isfinite(losses)), f"{label} n={n}: losses {losses}")
    check_launches(label, launches)
    plan_mm = plans[min(plans)][0] if recipe.masked_experts and plans \
        else None
    del state, step, batch, m
    torch.cuda.empty_cache()
    return row, plan_mm


def overlap_phase(cfg, dev, peaks, floor_ms, serve_tokens):
    """Phase 35: the chunked MoE blocks at full width.  qwen3 (1 layer,
    the split state) trains monolithic, then chunked at n = 1, 2 and 4,
    padded and masked: losses, ms a step, padded rows, casts a step (2),
    drop_frac and the expert-plan overflow; masked bit for bit padded at
    each n; the first loss within 1e-3 of the monolithic one where no
    assignment overflows on either side.  Every kernel against its twin
    at the chunk shapes (C = 128; the masked ones on the n = 4 run's own
    plan).  qwen3 at depth 4 served with the chunked blocks (2 chunks a
    prefill and a decode step): phase 3's tokens exactly (no assignment
    can overflow at these sizes).  Returns (launches by path, timing
    rows, the losses by run: 'mono', 'padded<n>', 'masked<n>')."""
    from repro_torch.core.moe import DispatchPlan
    from repro_torch.models.lm import ParallelPlan
    t_phase = time.perf_counter()
    rows, launches, timings = {}, {}, {}
    mono, _ = overlap_train_run(cfg, dev, "overlap_train", None)
    print(json.dumps({"overlap_train_monolithic": mono}))
    for n in OVERLAP_CHUNKS:
        padded, _ = overlap_train_run(cfg, dev, "overlap_train", n)
        masked, mm = overlap_train_run(cfg, dev, "overlap_masked_train", n)
        check(masked["losses"] == padded["losses"], f"overlap n={n}: the "
              f"masked losses {masked['losses']} are not the padded ones "
              f"{padded['losses']}")
        if padded["expert_overflow"] == 0 and mono["expert_overflow"] == 0:
            check(abs(padded["losses"][0] - mono["losses"][0]) <= 1e-3,
                  f"overlap n={n}: first loss {padded['losses'][0]} vs "
                  f"monolithic {mono['losses'][0]}")
        for r in (padded, masked):
            print(json.dumps({"overlap_train": r}))
        rows[n] = dict(padded=padded, masked=masked)
        launches["overlap_train"] = padded["launches"]
        launches["overlap_masked_train"] = masked["launches"]
        if n == max(OVERLAP_CHUNKS):
            add_rows(timings, train_kernel_checks(cfg, peaks, dev, floor_ms,
                                                  n_chunks=n))
            add_rows(timings, masked_train_kernel_checks(
                cfg, peaks, dev, mm, f"chunk{n} ", C=padded[
                    "capacity_per_chunk"]))
    plan = DispatchPlan(n_chunks=2, min_chunk_tokens=16, decode_chunks=2,
                        min_decode_tokens=4)
    launches["overlap_serve"], _, _ = serve_path(
        serve_config(), dev, "overlap_serve", padded_tokens=serve_tokens,
        plan=ParallelPlan(moe_overlap=plan))
    print(json.dumps({"overlap": dict(
        config="qwen3_moe_235b full width, 1 layer, StatePolicy(), "
               f"{OVERLAP_STEPS} steps of 2 x 1024 tokens",
        monolithic=dict(ms_per_step_warm=mono["ms_per_step_warm"],
                        losses=mono["losses"],
                        expert_overflow=mono["expert_overflow"]),
        by_chunks={n: {k: dict(ms=r[k]["ms_per_step_warm"],
                               padded_rows=r[k]["padded_rows"],
                               overflow=r[k]["expert_overflow"],
                               drop_frac=r[k]["drop_frac"],
                               first_loss=r[k]["losses"][0])
                       for k in r} for n, r in rows.items()},
        serve_plan=dataclasses.asdict(plan),
        seconds=time.perf_counter() - t_phase)}))
    losses = {f"{k}{n}": r[k]["losses"] for n, r in rows.items() for k in r}
    losses["mono"] = mono["losses"]
    return launches, timings, losses


def expected_m_phase(cfg, dev, mm):
    """Phase 36: the expected_m hint at the train shapes (C = 256 rows an
    expert, the masked train pass's plan): at expected_m >= C the three
    masked wrappers launch the padded kernels (LAUNCHES) and give the
    masked launches' bits; the fused SwiGLU GEMM-1 never falls back."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(9)
    D, F, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    C = train_capacity(cfg)
    qx = qtensor_of(*dispatch_rows(gen, dev, mm, C, D))
    qw13 = blockq(gen, dev, E, D, 2 * F)
    qa = qtensor_of(*dispatch_cols(gen, dev, mm, D, C))
    qb = qtensor_of(*dispatch_cols(gen, dev, mm, 2 * F, C))
    out = {}
    for hint in (None, C):
        kw = {} if hint is None else dict(expected_m=hint)
        kernels.reset_launches()
        out[hint] = (ops.grouped_gemm_fp8_masked(qx, qw13, mm, **kw),
                     ops.grouped_gemm_fp8_masked_quant_out(qx, qw13, mm,
                                                           **kw),
                     ops.grouped_gemm_nt_fp8_masked(qa, qb, mm,
                                                    torch.bfloat16, **kw),
                     ops.grouped_gemm_swiglu_quant_masked(qx, qw13, mm,
                                                          **kw))
        torch.cuda.synchronize()
        out[f"launches_{hint}"] = {k: v for k, v in kernels.LAUNCHES.items()
                                   if v}
    m, p = out[None], out[C]
    want_masked = {"masked_grouped_gemm_fp8": 1,
                   "masked_grouped_gemm_fp8_quant_out": 1,
                   "masked_grouped_gemm_nt_fp8": 1,
                   "masked_grouped_gemm_swiglu_quant": 1}
    want_padded = {"grouped_gemm_fp8": 1, "grouped_gemm_fp8_quant_out": 1,
                   "grouped_gemm_nt_fp8": 1,
                   "masked_grouped_gemm_swiglu_quant": 1}
    check(out["launches_None"] == want_masked,
          f"expected_m unset: launches {out['launches_None']}")
    check(out[f"launches_{C}"] == want_padded,
          f"expected_m={C}: launches {out[f'launches_{C}']}")
    check(torch.equal(m[0].view(torch.int16), p[0].view(torch.int16))
          and torch.equal(m[1].data.view(torch.uint8),
                          p[1].data.view(torch.uint8))
          and torch.equal(m[1].scale, p[1].scale)
          and torch.equal(m[2].view(torch.int16), p[2].view(torch.int16))
          and torch.equal(m[3].data.view(torch.uint8),
                          p[3].data.view(torch.uint8)),
          "expected_m: the padded kernels' bits differ from the masked")
    print(json.dumps({"expected_m": dict(
        shape=f"({E},{C},{D}) x ({E},{D},{2 * F}), NT ({E},{D},{C}) x "
              f"({E},{2 * F},{C})", **live_stats(mm, C),
        launches_masked=out["launches_None"],
        launches_expected_m_C=out[f"launches_{C}"], bitwise=True)}))


# ---------------------------------------------------------------------------
# Phases 37-39: the multi-GPU training path on an NCCL group of one rank.
# This script needs one card, and NCCL refuses two ranks on one
# device, so every collective runs at world 1: a real NCCL launch at full
# width, which at one rank is a copy.  What differs between ranks is held
# on the CPU (tests/test_torch_ep.py, test_torch_dist.py,
# test_torch_dist_train.py, on gloo groups of 2 and 4).
# ---------------------------------------------------------------------------
EP_STEPS, WIRE_STEPS = OVERLAP_STEPS, 4
# the reference's production model axis ((data, model) = (16, 16)): the
# world the roofline's collective term is modelled at
MODEL_WORLD = 16
PATH_KERNELS.update({
    "ep_train": PATH_KERNELS["train"],
    "ep_masked_train": PATH_KERNELS["masked_train"],
    "ep_serve": PATH_KERNELS["serve"],
    "q3_wire_train": PATH_KERNELS["train"],
    "dsv2_wire_train": PATH_KERNELS["dsv2_train"],
    "compression": ("quantize_rowwise",)})


def nccl_mesh():
    """A world of one rank on NCCL (launch/mesh.py), met through a
    FileStore under build/."""
    from repro_torch.launch.mesh import init_mesh
    store = ROOT / "build" / "nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    t0 = time.perf_counter()
    mesh = init_mesh(1, 1, device="cuda", store=str(store), rank=0,
                     timeout_s=300)
    print(json.dumps({"nccl_mesh": dict(
        backend=torch.distributed.get_backend(), world=mesh.world,
        shape=mesh.shape, nccl_version=".".join(
            str(v) for v in torch.cuda.nccl.version()),
        socket_ifname=os.environ.get("NCCL_SOCKET_IFNAME"),
        seconds=time.perf_counter() - t0)}))
    return mesh


def ep_train_run(cfg, dev, label, n, mesh):
    """overlap_train_run's EP_STEPS steps (qwen3 1 layer, StatePolicy(),
    the same batch and schedule), the MoE blocks' all-to-alls and the
    gradient all-reduce on `mesh`'s NCCL groups, monolithic (n None) or
    chunked at n.  The collectives of each step by kind; the last step
    under roofline.tally() (its collective bytes)."""
    from repro_torch import kernels
    from repro_torch.core import casts
    from repro_torch.core.moe import DispatchPlan
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.dist import comm
    from repro_torch.dist.opt_state import StatePolicy
    from repro_torch.models.lm import ParallelPlan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline import analysis as roofline
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig(lr=1e-3, state_policy=StatePolicy())
    dp = None if n is None else DispatchPlan(n_chunks=n, min_chunk_tokens=1)
    state = init_train_state(cfg, opt, seed=0, device=dev, mesh=mesh)
    step = make_train_step(cfg, recipe_for(label), opt,
                           plan=ParallelPlan(mesh=mesh, moe_overlap=dp))
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                  global_batch=TRAIN_B), 0, device=dev)
    losses, step_ms, colls, n_casts = [], [], [], []
    kernels.reset_launches()
    for i in range(EP_STEPS):
        comm.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tally = roofline.tally() if i == EP_STEPS - 1 else \
            contextlib.nullcontext()
        with tally as t, casts.ledger() as led:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        colls.append(comm.counts())
        n_casts.append(led.activation_casts())
    launches = dict(kernels.LAUNCHES)
    buf = t.coll_buffer_bytes
    row = dict(
        n_chunks=n, recipe=recipe_for(label).name, losses=losses,
        step_ms=step_ms, ms_per_step_warm=statistics.mean(step_ms[1:-1])
        if EP_STEPS > 2 else step_ms[-1],
        collectives_per_step=colls[0], tally_step_ms=step_ms[-1],
        tally_coll_buffer_bytes=buf, tally_coll_by_kind=t.coll,
        roofline_coll_bytes_world1=t.coll_bytes(1),
        roofline_coll_bytes_modelled=t.coll_bytes(MODEL_WORLD),
        modelled_world=MODEL_WORLD,
        activation_casts_per_step=n_casts,
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches)
    check(all(c == 2 for c in n_casts), f"{label} n={n}: casts {n_casts}")
    check(colls[0]["all-to-all"]["calls"] > 0,
          f"{label} n={n}: no all-to-all in a step")
    check(buf == sum(v["bytes"] for v in colls[-1].values()),
          f"{label} n={n}: the tally's collective bytes {buf} are not the "
          f"wrappers' {colls[-1]}")
    check_launches(label, launches)
    del state, step, batch, m
    torch.cuda.empty_cache()
    return row


def ep_phase(cfg, dev, mesh, groupless, serve_tokens):
    """Phase 37: qwen3 (1 layer, full width, StatePolicy()) trained with
    every dispatch and combine through all_to_all_single on an NCCL group
    of one rank (and the gradients through its f32 all-reduce), padded
    and masked, monolithic and chunked at 2: the losses phase 35's
    group-less runs gave, bit for bit (a one-rank all-to-all is a copy);
    the collectives a step, and their bytes beside the roofline tally's.
    Then phase 3's trace served at depth 4 with the prefill's all-to-alls
    and moe_block_decode's combine all-reduce on the group: phase 3's
    tokens bit for bit."""
    from repro_torch.dist import comm
    from repro_torch.models.lm import ParallelPlan
    t_phase = time.perf_counter()
    launches, rows = {}, {}
    for label, n, want in (("ep_train", None, "mono"),
                           ("ep_masked_train", None, "mono"),
                           ("ep_train", 2, "padded2"),
                           ("ep_masked_train", 2, "masked2")):
        row = ep_train_run(cfg, dev, label, n, mesh)
        check(row["losses"] == groupless[want],
              f"{label} n={n}: losses {row['losses']} on the NCCL group, "
              f"{groupless[want]} without one")
        print(json.dumps({"ep_train": dict(label=label, **row)}))
        rows[f"{label}_{n or 'mono'}"] = row
        launches[label] = row["launches"]
    comm.reset_counts()
    launches["ep_serve"], _, _ = serve_path(
        serve_config(), dev, "ep_serve", padded_tokens=serve_tokens,
        plan=ParallelPlan(mesh=mesh))
    serve_coll = comm.counts()
    check(serve_coll["all-reduce"]["calls"] > 0
          and serve_coll["all-to-all"]["calls"] > 0,
          f"ep_serve: collectives {serve_coll}")
    print(json.dumps({"ep": dict(
        config="qwen3_moe_235b full width, 1 layer, StatePolicy(), "
               f"{EP_STEPS} steps of 2 x 1024 tokens; served at depth 4",
        world=mesh.world, backend="nccl",
        by_run={k: dict(ms=r["ms_per_step_warm"], losses=r["losses"],
                        collectives=r["collectives_per_step"],
                        coll_buffer_bytes=r["tally_coll_buffer_bytes"],
                        peak_gib=r["max_memory_allocated_gib"])
                for k, r in rows.items()},
        serve_collectives=serve_coll,
        seconds=time.perf_counter() - t_phase)}))
    return launches


def wire_train_run(cfg, dev, label, mesh, wire, policy, *, guard=False,
                   fault=None):
    """WIRE_STEPS steps of `cfg` (fp8_flow) on make_batch's batches 0..,
    the reference test's settings (lr 3e-3, 400 total steps, warmup 5):
    the DistPlan step for a `wire` on `mesh` (the state from `policy`),
    the plain group-less step for None (`policy` the AdamW state).  Each
    step's loss, ms, wire ms (CUDA events around every reduce-scatter,
    sensitive all-reduce and ZeRO-1 gather), the reduce-scatters' and the
    gathers' collective bytes (held to wire_grad_bytes and, at each
    bucket's param width, wire_param_bytes), activation casts and tags,
    adamw_update launches; `fault` (a kind) armed at step 1."""
    from repro_torch import kernels
    from repro_torch.core import casts
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.dist import comm, grad_comm
    from repro_torch.dist.opt_state import bucket_dtype
    from repro_torch.dist.plan import (DistPlan, build_layout,
                                       flatten_with_paths)
    from repro_torch.models.lm import ParallelPlan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import fault_injection as fi
    from repro_torch.train.guards import GuardPlan
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gplan = GuardPlan() if guard else None
    if wire is None:
        f32 = policy.m == policy.v == policy.master == "f32"
        opt = AdamWConfig(lr=3e-3, state_policy=None if f32 else policy)
        dist, plan, smesh = None, ParallelPlan(), None
    else:
        opt = AdamWConfig(lr=3e-3)
        dist = DistPlan(wire=wire, policy=policy)
        plan, smesh = ParallelPlan(mesh=mesh), mesh
    state = init_train_state(cfg, opt, seed=0, device=dev, dist=dist,
                             mesh=smesh, guard=gplan)
    step = make_train_step(cfg, recipe_for("train"), opt, dist=dist,
                           plan=plan, total_steps=400, warmup_steps=5,
                           guard=gplan)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B)
    rs_bytes = {k: 0 for k in comm.KINDS}
    ag_bytes = {k: 0 for k in comm.KINDS}
    events = []
    wrapped = {}
    for name in ("reduce_scatter_bucket", "reduce_sensitive",
                 "all_gather_shard"):
        orig = getattr(grad_comm, name)

        def timed(*a, _orig=orig, _name=name, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            before = comm.counts()
            e0.record()
            out = _orig(*a, **kw)
            e1.record()
            events.append((e0, e1))
            into = {"reduce_scatter_bucket": rs_bytes,
                    "all_gather_shard": ag_bytes}.get(_name)
            if into is not None:
                for k, v in comm.counts().items():
                    into[k] += v["bytes"] - before[k]["bytes"]
            return out
        wrapped[name] = orig
        setattr(grad_comm, name, timed)
    losses, step_ms, wire_ms, n_casts, flags = [], [], [], [], []
    tags, adamw = set(), []
    try:
        for i in range(WIRE_STEPS):
            batch = make_batch(data, i, device=dev)
            kernels.reset_launches()
            events.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            armed = fi.Fault(fault, i) if fault and i == 1 else None
            with casts.ledger() as led, fi.activate(armed):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            wire_ms.append(sum(a.elapsed_time(b) for a, b in events))
            n_casts.append(led.activation_casts())
            tags |= {f"{k}:{t}" for (k, t) in led.by_tag()}
            adamw.append(kernels.LAUNCHES["adamw_update"])
            if guard:
                flags.append(int(m["guard_flags"]))
            launches = dict(kernels.LAUNCHES)
    finally:
        for name, orig in wrapped.items():
            setattr(grad_comm, name, orig)
    layout = build_layout(state["params"], dist) if dist else None
    row = dict(
        wire=wire, policy=dataclasses.asdict(policy), losses=losses,
        step_ms=step_ms, ms_per_step_warm=statistics.mean(step_ms[1:]),
        wire_ms=wire_ms, wire_ms_warm=statistics.mean(wire_ms[1:]),
        activation_casts_per_step=n_casts, adamw_update_launches=adamw,
        guard_flags=flags, rs_bytes_per_step=rs_bytes,
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches, tags=sorted(tags))
    if layout is not None:
        rows = [b.rows for b in layout.buckets]
        row.update(buckets=len(rows), sensitive=len(layout.sensitive),
                   wire_rows=sum(rows))
        # what the wire's buffers would put on the interconnect in a
        # world of MODEL_WORLD replicas, against the reference's model
        sent = sum(comm.wire_factor(k, MODEL_WORLD) * v / WIRE_STEPS
                   for k, v in rs_bytes.items())
        want = sum(grad_comm.wire_grad_bytes(r * 128, MODEL_WORLD, wire)
                   for r in rows)
        row.update(wire_bytes_modelled=sent, wire_grad_bytes=want)
        # the guard adds one int32 all-reduce a bucket (its flag), which
        # the reference's model leaves out
        check(guard or abs(sent - want) <= 1e-6 * want,
              f"{label} {wire}: wire bytes {sent} vs wire_grad_bytes {want}")
        # the ZeRO-1 gather sends a bucket in its param dtype (f32 where an
        # f32 leaf shares it; the reference's model counts 2 B)
        leaves = [t for _, t in flatten_with_paths(state["params"])]
        widths = [bucket_dtype(b, leaves).itemsize for b in layout.buckets]
        gathered = comm.wire_factor("all-gather", MODEL_WORLD) * \
            ag_bytes["all-gather"] / WIRE_STEPS
        want_ag = sum(grad_comm.wire_param_bytes(r * 128, MODEL_WORLD, w)
                      for r, w in zip(rows, widths))
        row.update(gather_bytes_modelled=gathered,
                   wire_param_bytes=want_ag, f32_buckets=widths.count(4))
        check(abs(gathered - want_ag) <= 1e-6 * want_ag,
              f"{label} {wire}: gather bytes {gathered} vs wire_param_bytes "
              f"{want_ag}")
    want_casts = casts_per_step(cfg, "fp8_flow")
    check(all(c == want_casts for c in n_casts),
          f"{label} {wire}: casts {n_casts}, expected {want_casts}")
    explicit = {t.split(":")[1] for t in tags
                if t.split(":")[0] in ("quantize", "dequantize")
                and not t.split(":")[1].startswith("q_w")}
    check(explicit == {"q_entry", "q_bwd_island"},
          f"{label} {wire}: explicit cast tags {sorted(tags)}")
    if wire is not None:
        check("fused_quantize:opt_state" in tags or policy.m != "e4m3",
              f"{label}: no opt_state quantize {sorted(tags)}")
        check(wire != "fp8" or "fused_quantize:dp_wire" in tags,
              f"{label}: no dp_wire quantize {sorted(tags)}")
    check(all(a > 0 for a in adamw), f"{label}: adamw_update {adamw}")
    check(all(np.isfinite(losses)), f"{label} {wire}: losses {losses}")
    check_launches(label, launches)
    del state, step
    torch.cuda.empty_cache()
    return row


def dp_wire_phase(dev, mesh):
    """Phase 38: the DistPlan step (FP8 DP wire, ZeRO-1) on the NCCL group
    of one rank, WIRE_STEPS steps each.  qwen3_moe_235b 1 layer at full
    width, StatePolicy(): the fp8 wire against the f32 wire (the f32
    state with the owned f32 gradient does not fit one card at this
    width), each step within 5% and the mean of the last 2 within 1%.
    deepseek_v2_lite at depth 4 (dense layers, shared experts, sensitive
    leaves): the f32 wire with the f32 state equal to the plain f32-state
    step bit for bit (its norm adds the leaves in the plain step's
    order), the fp8 wire with StatePolicy() against it at the same bars,
    and payload_bitflip at step 1 flagged (WIRE_SCALE), recovered through
    the bf16 fallback with the clean run's loss after it within 1%.  The
    cast ledger unchanged by the wire (2 a MoE block / dense MLP a step,
    tags {q_entry, q_bwd_island}, dp_wire and opt_state fused); the
    reduce-scatters' bytes equal wire_grad_bytes at a modelled world; ms
    a step, wire ms, peak GiB, adamw_update launches."""
    from repro_torch.dist.opt_state import StatePolicy
    from repro_torch.train.guards import WIRE_SCALE
    t_phase = time.perf_counter()
    split, f32 = StatePolicy(), StatePolicy(m="f32", v="f32", master="f32")
    rows, launches = {}, {}

    def bars(fp8, ref, what):
        a, b = np.array(fp8["losses"]), np.array(ref["losses"])
        rel = float(np.max(np.abs(a - b) / np.abs(b)))
        last = float(abs(a[-2:].mean() - b[-2:].mean()) / b[-2:].mean())
        check(rel < 0.05 and last < 0.01,
              f"{what}: fp8 wire {a} vs {b}: max {rel}, last-2 mean {last}")
        return dict(max_step_rel=rel, last2_mean_rel=last)

    q3 = train_config()
    rows["q3_fp8"] = wire_train_run(q3, dev, "q3_wire_train", mesh, "fp8",
                                    split)
    rows["q3_f32_wire_split"] = wire_train_run(q3, dev, "q3_wire_train",
                                               mesh, "f32", split)
    q3_bars = bars(rows["q3_fp8"], rows["q3_f32_wire_split"], "qwen3")
    launches["q3_wire_train"] = rows["q3_fp8"]["launches"]
    dcfg = arch_config("deepseek_v2_lite", DSV2_TRAIN_LAYERS)
    rows["dsv2_plain_f32"] = wire_train_run(dcfg, dev, "dsv2_wire_train",
                                            mesh, None, f32)
    rows["dsv2_f32"] = wire_train_run(dcfg, dev, "dsv2_wire_train", mesh,
                                      "f32", f32)
    check(rows["dsv2_f32"]["losses"] == rows["dsv2_plain_f32"]["losses"],
          f"dsv2: f32 wire {rows['dsv2_f32']['losses']} vs plain "
          f"{rows['dsv2_plain_f32']['losses']}")
    rows["dsv2_fp8"] = wire_train_run(dcfg, dev, "dsv2_wire_train", mesh,
                                      "fp8", split, guard=True)
    dsv2_bars = bars(rows["dsv2_fp8"], rows["dsv2_f32"], "dsv2")
    rows["dsv2_fp8_bitflip"] = wire_train_run(
        dcfg, dev, "dsv2_wire_train", mesh, "fp8", split, guard=True,
        fault="payload_bitflip")
    fl = rows["dsv2_fp8_bitflip"]["guard_flags"]
    check([bool(f & WIRE_SCALE) for f in fl] ==
          [i == 1 for i in range(WIRE_STEPS)], f"bitflip: flags {fl}")
    check(not any(f & WIRE_SCALE for f in rows["dsv2_fp8"]["guard_flags"]),
          "the clean fp8 run flagged the wire")
    hit, clean = (np.array(rows[k]["losses"]) for k in
                  ("dsv2_fp8_bitflip", "dsv2_fp8"))
    check(np.all(np.abs(hit - clean) <= 0.01 * np.abs(clean)),
          f"bitflip run {hit} vs clean {clean}")
    launches["dsv2_wire_train"] = rows["dsv2_fp8"]["launches"]
    for k, r in rows.items():
        print(json.dumps({"dp_wire_run": dict(run=k, **r)}))
    print(json.dumps({"dp_wire": dict(
        world=mesh.world, backend="nccl", steps=WIRE_STEPS,
        qwen3_bars=q3_bars, dsv2_bars=dsv2_bars,
        dsv2_f32_wire_equals_plain="bit for bit",
        summary={k: dict(ms=r["ms_per_step_warm"],
                         wire_ms=r["wire_ms_warm"],
                         peak_gib=r["max_memory_allocated_gib"],
                         adamw_update=r["adamw_update_launches"][-1],
                         losses=r["losses"])
                 for k, r in rows.items()},
        seconds=time.perf_counter() - t_phase)}))
    return launches


def psum_twin_controls(x, got):
    """compressed_psum at one rank in plain PyTorch on x: quantize,
    dequantize, the one-rank sum, re-quantize, dequantize, with the e4m3
    twin of #1 and with an e5m2 cast on the same po2 scheme.  Returns
    whether each equals `got` bit for bit and each one's largest error of
    a 128-row's amax."""
    from repro_torch.core.fp8 import po2_scale
    from repro_torch.kernels.quantize import quantize_rowwise_plain

    def e5m2(rows):
        t = rows.reshape(rows.shape[0], -1, 128)
        scale = po2_scale(t.abs().amax(-1), 57344.0)
        return ((t / scale[..., None]).to(torch.float8_e5m2)
                .reshape(rows.shape), scale)

    def twin(quant):
        def rt(rows):
            d, sc = quant(rows)
            return (d.to(torch.float32).reshape(d.shape[0], -1, 128)
                    * sc[..., None]).reshape(rows.shape)
        rows = x.reshape(-1, 128)
        return rt(rt(rows)).reshape(x.shape).to(x.dtype)

    a = x.reshape(-1, 128).to(torch.float32)
    amax = a.abs().amax(1).clamp(min=1e-30)
    out = {}
    for name, quant in (("e4m3", quantize_rowwise_plain), ("e5m2", e5m2)):
        y = twin(quant)
        out[f"{name}_bitwise"] = bool(torch.equal(
            y.view(torch.int16), got.view(torch.int16)))
        err = (y.reshape(-1, 128).to(torch.float32) - a).abs().amax(1)
        out[f"{name}_max_err_of_row_amax"] = float((err / amax).max())
    return out


def compression_phase(dev, mesh):
    """Phase 39: compressed_psum (runtime/compression.py) of one qwen3
    expert leaf's gradient (128 x 4096 x 3072 bf16) over the NCCL group:
    two launches of #1 (the quantize and the re-quantize), timed with CUDA
    events.  The error is within two e4m3 half-ulps of each 128-row's
    amax (2 x 2^-4; an e4m3 po2 quantization errs by at most 1/17 of the
    amax, so two by at most 35/289).  An e5m2 wire would stay within
    that bound too at one rank (at most 1/9), so the wire's precision is
    held by the bits: the first expert's sum equals the plain e4m3 twin's
    (quantize_rowwise_plain, dequantize, sum, re-quantize) bit for bit,
    and the same twin with an e5m2 cast is printed as the control that
    this check refuses."""
    from repro_torch import kernels
    from repro_torch.runtime.compression import compressed_psum
    cfg = train_config()
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((cfg.n_experts, cfg.d_model, 2 * cfg.d_ff_expert),
                    generator=gen, device=dev).to(torch.bfloat16)
    compressed_psum(x[:1], mesh.data_group)            # warm
    ms = []
    for i in range(3):
        kernels.reset_launches()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = compressed_psum(x, mesh.data_group)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        launches = dict(kernels.LAUNCHES)
        if i < 2:
            del out
    worst = 0.0
    xr, orr = x.reshape(-1, 128), out.reshape(-1, 128)
    for r in range(0, xr.shape[0], 1 << 20):
        a = xr[r:r + (1 << 20)].to(torch.float32)
        d = (orr[r:r + (1 << 20)].to(torch.float32) - a).abs().amax(1)
        amax = a.abs().amax(1).clamp(min=1e-30)
        worst = max(worst, float((d / amax).max()))
    bound = 2 * 2 ** -4
    check(worst <= bound, f"compressed_psum: error {worst} of amax")
    check(launches["quantize_rowwise"] == 2,
          f"compressed_psum launches {launches}")
    check_launches("compression", launches)
    control = psum_twin_controls(x[:1], out[:1])
    check(mesh.world != 1 or control["e4m3_bitwise"],
          f"compressed_psum: the first expert is not the e4m3 twin's "
          f"{control}")
    check(not control["e5m2_bitwise"],
          f"compressed_psum: an e5m2 cast passes the bitwise check")
    print(json.dumps({"compression": dict(
        shape=list(x.shape), dtype="bfloat16", world=mesh.world,
        ms=ms, ms_warm=statistics.mean(ms[1:]), max_err_of_row_amax=worst,
        bound=bound, controls=control, launches=launches)}))
    del x, out
    torch.cuda.empty_cache()
    return launches


def _two_rank_child(rank, store, out):
    import traceback
    try:
        torch.cuda.set_device(0)
        torch.distributed.init_process_group(
            "nccl", store=torch.distributed.FileStore(store, 2), rank=rank,
            world_size=2)
        t = torch.ones(4, device="cuda")
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        Path(f"{out}.{rank}").write_text(f"ok {t.tolist()}")
    except BaseException:   # noqa: BLE001 -- reported to the parent
        Path(f"{out}.{rank}").write_text(traceback.format_exc()[-2000:])


def nccl_two_ranks_probe():
    """Two NCCL ranks on the one card (``--nccl-two-ranks``): what NCCL
    says.  Not a phase of the default run."""
    import torch.multiprocessing as mp
    d = ROOT / "build"
    d.mkdir(parents=True, exist_ok=True)
    store, out = d / "nccl_two_store", d / "nccl_two_out"
    for f in (store, Path(f"{out}.0"), Path(f"{out}.1")):
        if f.exists():
            f.unlink()
    ctx = mp.get_context("spawn")
    ps = [ctx.Process(target=_two_rank_child, args=(r, str(store), str(out)))
          for r in range(2)]
    for p in ps:
        p.start()
    for p in ps:
        p.join(120)
        if p.is_alive():
            p.kill()
    said = {r: Path(f"{out}.{r}").read_text()
            if Path(f"{out}.{r}").exists() else "no result"
            for r in range(2)}
    print(json.dumps({"nccl_two_ranks_one_card": dict(
        exit_codes=[p.exitcode for p in ps], ranks=said)}))


def multi_gpu_phases(dev, groupless, serve_tokens, timings=None):
    """Phases 37-42 on one NCCL group; returns their launches by path.
    Phase 42's kernel rows go into `timings` when it is given."""
    from repro_torch.launch.mesh import close_mesh
    mesh = nccl_mesh()
    try:
        launches = ep_phase(train_config(), dev, mesh, groupless,
                            serve_tokens)
        launches.update(dp_wire_phase(dev, mesh))
        launches["compression"] = compression_phase(dev, mesh)
        tp_launches, dsv2_mesh_losses = tp_fsdp_phase(dev, mesh,
                                                      groupless["mono"])
        launches.update(tp_launches)
        launches.update(stream_phase(dev, mesh))
        ranks_launches, rows = serve_ranks_phase(dev, mesh, serve_tokens,
                                                 dsv2_mesh_losses)
        launches.update(ranks_launches)
        if timings is not None:
            add_rows(timings, rows)
    finally:
        close_mesh()
    return launches


# ---------------------------------------------------------------------------
# Phases 40-41: multi-GPU training part 2 on the NCCL group of one rank:
# TP-sharded experts, the TP dense MLP and the FSDP weight gathers (the
# reference's make_plan levers), then the streaming FP8 DP wire over the
# layer-aligned layout.  What differs between ranks is held on the CPU
# (tests/test_torch_tp.py, tests/test_torch_stream.py, gloo groups of 2
# and 4).
# ---------------------------------------------------------------------------
TP_STEPS, STREAM_STEPS = OVERLAP_STEPS, 4
# TP against EP at world 1: the same C_exp and drops, the combine's sum in
# another order (TP adds a token's k rows in expert-slot order)
TP_EP_RTOL = 1e-3
# deepseek_v2_lite's TP-mode MLPs against its plain mesh step: Dgrad-1
# rounds to bf16 before its all-reduce and #1 (the #4 epilogue does not)
MLP_TP_RTOL = 1e-3
# grok1_314b's FSDP gathers at world 1: the split-state peak of its
# one-layer step (phase 24: 61.91 GiB) + the regathered weights in the
# recompute (9.66 GB) + two copies of we13's bf16 gradient in its
# reduce-scatter (12.88 GB) ~ 83 GiB
GROK_FSDP_PEAK_GIB = 61.907 + (9.66e9 + 12.88e9) / 2**30
CARD_GIB = 79.18
PATH_KERNELS.update({
    # TP experts: Dgrad-1 is #3 (or #5) then #1, never #4 / #6
    "tp_train": tuple(k for k in PATH_KERNELS["train"]
                      if k != "grouped_gemm_fp8_quant_out"),
    "tp_masked_train": tuple(k for k in PATH_KERNELS["masked_train"]
                             if k != "masked_grouped_gemm_fp8_quant_out"),
    "grok_tp_train": ("quantize_rowwise", "fused_permute_pad",
                      "grouped_gemm_fp8", "fp8_transpose",
                      "grouped_gemm_nt_fp8", "adamw_update"),
    "dsv2_mesh_train": PATH_KERNELS["dsv2_train"],
    "dsv2_mlp_tp_train": PATH_KERNELS["dsv2_train"],
    "q3_stream_train": PATH_KERNELS["train"],
    "dsv2_stream_train": PATH_KERNELS["dsv2_train"]})
PATH_RECIPES.update({"tp_train": ("fp8_flow", {}),
                     "tp_masked_train": ("fp8_flow", MASKED),
                     "mesh_train": ("fp8_flow", {}),
                     "mlp_tp_train": ("fp8_flow", {}),
                     "stream_train": ("fp8_flow", {}),
                     "q3_stream_train": ("fp8_flow", {})})


def tp_train_run(cfg, dev, label, mesh, plan_kw, n_steps=TP_STEPS,
                 state_policy="split"):
    """n_steps of `cfg` on make_batch's batch 0 (the phase 35/37 schedule:
    AdamW lr 1e-3 after a 100-step warmup) under ParallelPlan(mesh,
    **plan_kw): losses, ms a warm step (the first and the tallied last
    left out, as phase 37's), the collectives of the first step by
    kind, the last step under roofline.tally() (its collective bytes),
    casts a step, the ledger's tags, peak GiB and launches."""
    from repro_torch import kernels
    from repro_torch.core import casts
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.dist import comm
    from repro_torch.dist.opt_state import StatePolicy
    from repro_torch.models.lm import ParallelPlan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline import analysis as roofline
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig(lr=1e-3, state_policy=StatePolicy()
                      if state_policy == "split" else None)
    plan = ParallelPlan(mesh=mesh, **plan_kw)
    state = init_train_state(cfg, opt, seed=0, device=dev, plan=plan)
    step = make_train_step(cfg, recipe_for(label), opt, plan=plan)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                  global_batch=TRAIN_B), 0, device=dev)
    losses, step_ms, colls, n_casts, tags = [], [], [], [], set()
    kernels.reset_launches()
    for i in range(n_steps):
        comm.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tally = roofline.tally() if i == n_steps - 1 else \
            contextlib.nullcontext()
        with tally as t, casts.ledger() as led:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        colls.append(comm.counts())
        n_casts.append(led.activation_casts())
        tags |= {f"{k}:{tg}" for (k, tg) in led.by_tag()}
    launches = dict(kernels.LAUNCHES)
    buf = t.coll_buffer_bytes
    row = dict(
        plan={k: v for k, v in plan_kw.items()}, losses=losses,
        step_ms=step_ms, ms_per_step_warm=statistics.mean(step_ms[1:-1])
        if n_steps > 2 else step_ms[-1], tally_step_ms=step_ms[-1],
        collectives_per_step=colls[0], tally_coll_buffer_bytes=buf,
        tally_coll_by_kind=t.coll, roofline_coll_bytes_world1=t.coll_bytes(1),
        roofline_coll_bytes_modelled=t.coll_bytes(MODEL_WORLD),
        modelled_world=MODEL_WORLD, activation_casts_per_step=n_casts,
        tags=sorted(tags),
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches)
    check(all(np.isfinite(losses)), f"{label} {plan_kw}: losses {losses}")
    print(json.dumps({"tp_fsdp_run": dict(label=label, **row)}))
    check(buf == sum(v["bytes"] for v in colls[-1].values()),
          f"{label}: the tally's collective bytes {buf} are not the "
          f"wrappers' {colls[-1]}")
    check_launches(label, launches)
    del state, step, batch, m
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def expandable_segments():
    """The caching allocator's expandable segments (PyTorch's
    ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``) for the runs
    inside: freed segments give their pages back, so one large block
    fits where the default cache holds the room in fragments.  The cache
    is emptied on entry and exit."""
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")


def tp_fsdp_phase(dev, mesh, ep_losses):
    """Phase 40: the reference's production levers at full width on the
    NCCL group of one rank.  qwen3_moe_235b 1 layer, StatePolicy(), TP
    experts with FSDP: the three combines, padded and masked, each bit
    for bit the group-less TP run (a one-rank collective is a copy), the
    masked runs the padded bits; within TP_EP_RTOL of phase 37's EP run;
    2 casts, the 'dgrad_epilogue' quantize recorded and no #4 / #6
    launched (Dgrad-1 is #3 or #5, the all-reduce, then #1; each held to
    its twin at this shape by the tp_dgrad1 rows of phases 5 and 5b, the
    dense MLP's by phase 10's dsv2 rows).  grok1_314b
    1 layer, StatePolicy(), TP experts (FSDP only if its predicted peak
    fits the card), on the group bit for bit group-less.
    deepseek_v2_lite depth 4 with mlp_tp and FSDP
    against the plain mesh step (EP at world 1).  Prints the collectives
    a step and their bytes beside the tally's, ms a step and peak."""
    from repro_torch.launch.mesh import make_test_mesh
    t_phase = time.perf_counter()
    q3 = train_config()
    tp = dict(moe_mode="tp", fsdp_axis="data")
    rows, launches = {}, {}
    rows["groupless"] = tp_train_run(q3, dev, "tp_train",
                                     make_test_mesh(dev), tp)
    want = rows["groupless"]["losses"]
    for label in ("tp_train", "tp_masked_train"):
        for combine in ("psum_first", "local_first", "reduce_scatter"):
            r = tp_train_run(q3, dev, label, mesh,
                             dict(tp, moe_tp_combine=combine))
            rows[f"{label}_{combine}"] = r
            check(r["losses"] == want,
                  f"{label} {combine}: losses {r['losses']} on the NCCL "
                  f"group, {want} group-less")
            check(all(c == 2 for c in r["activation_casts_per_step"]),
                  f"{label} {combine}: casts {r}")
            check("fused_quantize:dgrad_epilogue" in r["tags"],
                  f"{label} {combine}: tags {r['tags']}")
            launches[label] = r["launches"]
    rel = [abs(a - b) / abs(b) for a, b in zip(want, ep_losses)]
    check(max(rel) <= TP_EP_RTOL,
          f"TP {want} vs phase 37's EP {ep_losses}: {rel}")
    grok = arch_config("grok1_314b", 1)
    fsdp_fits = GROK_FSDP_PEAK_GIB < CARD_GIB
    grok_kw = dict(moe_mode="tp", fsdp_axis="data" if fsdp_fits else None)
    # on the group, bit for bit the group-less run.  The plain step's f32
    # gradient means (we13's alone 12 GiB) fit beside grok's state only
    # with expandable segments: in the default cache 9.2 GiB of it lies
    # stranded in partly used segments at that point
    rows["grok_tp_groupless"] = tp_train_run(grok, dev, "grok_tp_train",
                                             make_test_mesh(dev), grok_kw)
    with expandable_segments():
        rows["grok_tp"] = tp_train_run(grok, dev, "grok_tp_train", mesh,
                                       grok_kw)
    check(rows["grok_tp"]["losses"] == rows["grok_tp_groupless"]["losses"],
          f"grok TP: losses {rows['grok_tp']['losses']} on the NCCL group, "
          f"{rows['grok_tp_groupless']['losses']} group-less")
    launches["grok_tp_train"] = rows["grok_tp"]["launches"]
    dcfg = arch_config("deepseek_v2_lite", DSV2_TRAIN_LAYERS)
    rows["dsv2_mesh"] = tp_train_run(dcfg, dev, "dsv2_mesh_train", mesh, {},
                                     state_policy="f32")
    rows["dsv2_mlp_tp"] = tp_train_run(dcfg, dev, "dsv2_mlp_tp_train", mesh,
                                       dict(mlp_tp=True, fsdp_axis="data"),
                                       state_policy="f32")
    a, b = rows["dsv2_mlp_tp"]["losses"], rows["dsv2_mesh"]["losses"]
    dsv2_rel = [abs(x - y) / abs(y) for x, y in zip(a, b)]
    check(a[0] == b[0] and max(dsv2_rel) <= MLP_TP_RTOL,
          f"dsv2 mlp_tp {a} vs the plain mesh step {b}")
    launches["dsv2_mlp_tp_train"] = rows["dsv2_mlp_tp"]["launches"]
    print(json.dumps({"tp_fsdp": dict(
        config="qwen3_moe_235b 1 layer, grok1_314b 1 layer (StatePolicy()), "
               f"deepseek_v2_lite depth {DSV2_TRAIN_LAYERS} (f32 state), "
               f"{TP_STEPS} steps of {TRAIN_B} x {TRAIN_S} tokens",
        world=mesh.world, backend="nccl",
        tp_vs_ep_rel=rel, tp_ep_rtol=TP_EP_RTOL, ep_losses=ep_losses,
        dsv2_mlp_tp_vs_mesh_rel=dsv2_rel, mlp_tp_rtol=MLP_TP_RTOL,
        grok_fsdp=dict(predicted_peak_gib=GROK_FSDP_PEAK_GIB,
                       card_gib=CARD_GIB, used=fsdp_fits,
                       reason="fits" if fsdp_fits else
                       "the predicted peak exceeds the card",
                       mesh="the NCCL group under expandable segments, "
                            "bit for bit the group-less run"),
        summary={k: dict(ms=r["ms_per_step_warm"], losses=r["losses"],
                         collectives=r["collectives_per_step"],
                         coll_buffer_bytes=r["tally_coll_buffer_bytes"],
                         peak_gib=r["max_memory_allocated_gib"])
                 for k, r in rows.items()},
        seconds=time.perf_counter() - t_phase)}))
    return launches, rows["dsv2_mesh"]["losses"]


def stream_train_run(cfg, dev, label, mesh, dist_kw, *, grad_accum=1,
                     guard=False, fault=None, remat=None):
    """STREAM_STEPS steps of `cfg` (fp8_flow, StatePolicy(), the fp8
    wire) through the DistPlan step on `mesh`, make_batch's batches 0..
    (the reference test's lr 3e-3, 400 total steps, warmup 5): losses,
    ms a step, wire ms (CUDA events around every reduce-scatter's issue
    and finish, sensitive all-reduce and gather), each bucket's wire ms
    and the compute between two issues (for the exposure model), the
    launch order (all-to-alls, grouped-GEMM wrappers), casts, tags, the
    params' SHA-256, peak GiB and launches."""
    from repro_torch import kernels
    from repro_torch.core import casts
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.dist import comm, grad_comm
    from repro_torch.dist.opt_state import StatePolicy
    from repro_torch.dist.plan import DistPlan
    from repro_torch.kernels import ops
    from repro_torch.models.lm import ParallelPlan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import fault_injection as fi
    from repro_torch.train.guards import GuardPlan
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    gplan = GuardPlan() if guard else None
    opt = AdamWConfig(lr=3e-3)
    dist = DistPlan(wire="fp8", policy=StatePolicy(), **dist_kw)
    plan = ParallelPlan(mesh=mesh)
    state = init_train_state(cfg, opt, seed=0, device=dev, dist=dist,
                             mesh=mesh, guard=gplan)
    step = make_train_step(cfg, recipe_for(label), opt, dist=dist,
                           plan=plan, total_steps=400, warmup_steps=5,
                           grad_accum=grad_accum, guard=gplan)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                      global_batch=TRAIN_B * grad_accum)
    # CUDA events around the wire's calls, the outermost only (posthoc's
    # reduce_scatter_bucket issues and finishes inside itself)
    wire_ev, issue_ev, order, patched, depth = [], [], [], [], [0]

    def wrap(mod, name, fn_of):
        orig = getattr(mod, name)
        patched.append((mod, name, orig))
        setattr(mod, name, fn_of(orig))

    def timed(orig, into):
        def call(*a, **kw):
            depth[0] += 1
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            try:
                out = orig(*a, **kw)
            finally:
                depth[0] -= 1
            e1.record()
            if depth[0] == 0:
                into.append((e0, e1))
            return out
        return call

    def logged(orig, what):
        def call(*a, **kw):
            if what != "a2a" or a[1] is not None:
                order.append(what)
            return orig(*a, **kw)
        return call
    for name in ("reduce_scatter_bucket", "reduce_sensitive",
                 "all_gather_shard"):
        wrap(grad_comm, name, lambda o: timed(o, wire_ev))
    wrap(grad_comm, "issue_reduce_scatter", lambda o: timed(o, issue_ev))
    wrap(grad_comm.InFlight, "finish", lambda o: timed(o, wire_ev))
    wrap(comm, "all_to_all", lambda o: logged(o, "a2a"))
    for name in [n for n in vars(ops) if n.startswith("grouped_gemm")]:
        wrap(ops, name, lambda o: logged(o, "gemm"))
    losses, step_ms, wire_ms, n_casts, flags, orders = [], [], [], [], [], []
    tags, bucket_ms, between_ms = set(), [], []
    try:
        for i in range(STREAM_STEPS):
            batch = make_batch(data, i, device=dev)
            if grad_accum > 1:
                batch = {k: v.reshape(grad_accum, -1, *v.shape[1:])
                         for k, v in batch.items()}
            kernels.reset_launches()
            wire_ev.clear()
            issue_ev.clear()
            order.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            end = torch.cuda.Event(enable_timing=True)
            armed = fi.Fault(fault, i) if fault and i == 1 else None
            with casts.ledger() as led, fi.activate(armed):
                state, m = step(state, batch)
                end.record()
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            wire_ms.append(sum(a.elapsed_time(b)
                               for a, b in wire_ev + issue_ev))
            # posthoc: each bucket's reduce-scatter (the first of its
            # wire calls are the buckets', in bucket order); stream: each
            # issue
            bucket_ms.append([a.elapsed_time(b) for a, b in
                              (issue_ev or wire_ev)])
            if issue_ev:
                nxt = [a for a, _ in issue_ev[1:]] + [end]
                between_ms.append([b.elapsed_time(c) for (_, b), c in
                                   zip(issue_ev, nxt)])
            n_casts.append(led.activation_casts())
            tags |= {f"{k}:{t}" for (k, t) in led.by_tag()}
            orders.append(list(order))
            if guard:
                flags.append(int(m["guard_flags"]))
        launches = dict(kernels.LAUNCHES)
    finally:
        for mod, name, orig in reversed(patched):
            setattr(mod, name, orig)
    row = dict(
        dist=dict(dist_kw), grad_accum=grad_accum, remat=cfg.remat_policy,
        losses=losses, step_ms=step_ms,
        ms_per_step_warm=statistics.mean(step_ms[1:]), wire_ms=wire_ms,
        wire_ms_warm=statistics.mean(wire_ms[1:]),
        bucket_ms_last=bucket_ms[-1], between_ms_last=between_ms[-1]
        if between_ms else None, activation_casts_per_step=n_casts,
        tags=sorted(tags), guard_flags=flags, orders=orders,
        params_sha256=tree_sha256(state["params"]),
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches)
    print(json.dumps({"stream_run": dict(
        label=label, **{f: v for f, v in row.items() if f != "orders"},
        order_len=[len(o) for o in orders])}))
    check(all(np.isfinite(losses)), f"{label} {dist_kw}: losses {losses}")
    check_launches(label, launches)
    del state, step
    torch.cuda.empty_cache()
    return row


def stream_phase(dev, mesh):
    """Phase 41: the streaming FP8 DP wire on the NCCL group of one rank,
    STREAM_STEPS steps, fp8 wire, StatePolicy().  deepseek_v2_lite depth
    4 and qwen3 1 layer: schedule='stream' against posthoc over the same
    layered layout, losses and every parameter bit for bit (SHA-256), also
    with grad_accum 2 and under 'pair' (dsv2; 'full' is the config's);
    the first reduce-scatter before the step's last grouped-GEMM launch
    (the posthoc wire's after it; dsv2, whose layers below are still to
    run); the cast ledger unchanged; a flipped
    wire byte flagged at step 1 and recovered.  Prints ms a step for
    stream, posthoc-layered and the flat posthoc layout, wire ms, the
    measured exposed wire (stream ms less posthoc-layered's compute) beside
    grad_comm.stream_exposed_us on the measured bucket and layer times,
    and peak GiB."""
    from repro_torch.dist.grad_comm import stream_exposed_us
    from repro_torch.train.guards import WIRE_SCALE
    t_phase = time.perf_counter()
    st, lay = dict(schedule="stream"), dict(layered=True)
    dcfg = arch_config("deepseek_v2_lite", DSV2_TRAIN_LAYERS)
    q3 = train_config()
    rows, launches, summary = {}, {}, {}
    for tag, cfg, label in (("dsv2", dcfg, "dsv2_stream_train"),
                            ("q3", q3, "q3_stream_train")):
        rows[f"{tag}_stream"] = stream_train_run(cfg, dev, label, mesh, st)
        rows[f"{tag}_posthoc_layered"] = stream_train_run(cfg, dev, label,
                                                          mesh, lay)
        rows[f"{tag}_posthoc_flat"] = stream_train_run(cfg, dev, label,
                                                       mesh, {})
        launches[label] = rows[f"{tag}_stream"]["launches"]
    pairs = [("dsv2_stream", "dsv2_posthoc_layered"),
             ("q3_stream", "q3_posthoc_layered")]
    rows["dsv2_stream_acc2"] = stream_train_run(
        dcfg, dev, "dsv2_stream_train", mesh, st, grad_accum=2)
    rows["dsv2_posthoc_acc2"] = stream_train_run(
        dcfg, dev, "dsv2_stream_train", mesh, lay, grad_accum=2)
    rows["dsv2_stream_pair"] = stream_train_run(
        dcfg, dev, "dsv2_stream_train", mesh, st, remat="pair")
    rows["dsv2_posthoc_pair"] = stream_train_run(
        dcfg, dev, "dsv2_stream_train", mesh, lay, remat="pair")
    pairs += [("dsv2_stream_acc2", "dsv2_posthoc_acc2"),
              ("dsv2_stream_pair", "dsv2_posthoc_pair")]
    for a, b in pairs:
        ra, rb = rows[a], rows[b]
        check(ra["losses"] == rb["losses"]
              and ra["params_sha256"] == rb["params_sha256"],
              f"{a} {ra['losses']} vs {b} {rb['losses']}: not bit for bit")
        check(ra["activation_casts_per_step"] ==
              rb["activation_casts_per_step"],
              f"{a}: casts {ra['activation_casts_per_step']} vs "
              f"{rb['activation_casts_per_step']}")
        # with one layer (qwen3) the only buckets leave after the only
        # backward; the order shows with the layers below still to run
        for o in ra["orders"] if a.startswith("dsv2") else ():
            last = len(o) - 1 - o[::-1].index("gemm")
            check(o.index("a2a") < last, f"{a}: the first reduce-scatter "
                  f"at {o.index('a2a')}, the last GEMM at {last}")
        for o in rb["orders"]:
            check(o.index("a2a") > len(o) - 1 - o[::-1].index("gemm"),
                  f"{b}: a reduce-scatter inside the backward")
    for tag, cfg in (("dsv2", dcfg), ("q3", q3)):
        want = casts_per_step(cfg, "fp8_flow")
        check(all(c == want for c in
                  rows[f"{tag}_stream"]["activation_casts_per_step"]),
              f"{tag} stream: casts, expected {want}")
    rows["dsv2_stream_guarded"] = stream_train_run(
        dcfg, dev, "dsv2_stream_train", mesh, st, guard=True)
    rows["dsv2_stream_bitflip"] = stream_train_run(
        dcfg, dev, "dsv2_stream_train", mesh, st, guard=True,
        fault="payload_bitflip")
    fl = rows["dsv2_stream_bitflip"]["guard_flags"]
    check([bool(f & WIRE_SCALE) for f in fl] ==
          [i == 1 for i in range(STREAM_STEPS)], f"stream bitflip: {fl}")
    check(not any(f & WIRE_SCALE
                  for f in rows["dsv2_stream_guarded"]["guard_flags"]),
          "the clean guarded stream flagged the wire")
    hit, clean = (np.array(rows[k]["losses"]) for k in
                  ("dsv2_stream_bitflip", "dsv2_stream_guarded"))
    check(np.all(np.abs(hit - clean) <= 0.01 * np.abs(clean)),
          f"stream bitflip {hit} vs clean {clean}")
    for tag in ("dsv2", "q3"):
        s_, p_, f_ = (rows[f"{tag}_{k}"] for k in
                      ("stream", "posthoc_layered", "posthoc_flat"))
        compute = p_["ms_per_step_warm"] - p_["wire_ms_warm"]
        # the model: each bucket's wire time (posthoc's, in bucket order)
        # drained against the compute between two streamed issues
        b_us = [1e3 * x for x in p_["bucket_ms_last"]]
        c_us = [1e3 * x for x in (s_["between_ms_last"] or [])]
        summary[tag] = dict(
            stream_ms=s_["ms_per_step_warm"],
            posthoc_layered_ms=p_["ms_per_step_warm"],
            posthoc_flat_ms=f_["ms_per_step_warm"],
            wire_ms=dict(stream=s_["wire_ms_warm"],
                         posthoc_layered=p_["wire_ms_warm"],
                         posthoc_flat=f_["wire_ms_warm"]),
            exposed_wire_ms_measured=s_["ms_per_step_warm"] - compute,
            exposed_wire_ms_modelled=stream_exposed_us(b_us, c_us) / 1e3,
            buckets=len(b_us),
            peak_gib=dict(stream=s_["max_memory_allocated_gib"],
                          posthoc_layered=p_["max_memory_allocated_gib"],
                          posthoc_flat=f_["max_memory_allocated_gib"]))
    summary["dsv2_guarded_stream_ms"] = \
        rows["dsv2_stream_guarded"]["ms_per_step_warm"]
    print(json.dumps({"stream": dict(
        config=f"deepseek_v2_lite depth {DSV2_TRAIN_LAYERS}, qwen3_moe_235b "
               f"1 layer; fp8 wire, StatePolicy(), {STREAM_STEPS} steps",
        world=mesh.world, backend="nccl",
        bit_for_bit=[f"{a} == {b}" for a, b in pairs],
        summary=summary, seconds=time.perf_counter() - t_phase)}))
    return launches


# ---------------------------------------------------------------------------
# Phase 42: serving across ranks on the NCCL group of one rank (the engine,
# serve_step and the launcher on make_plan; TP decode through moe_block_tp
# on W8 experts) and the pod axis.  What differs between ranks is held on
# the CPU (tests/test_torch_serve_ranks.py, tests/test_torch_pod.py).
# ---------------------------------------------------------------------------
PATH_KERNELS.update({
    "ranks_serve": PATH_KERNELS["serve"],
    "ranks_serve_step": PATH_KERNELS["serve"],
    # qwen3 with TP experts: the TP decode's (E, 128) groups through the
    # padded kernels, and the masked recipe's #5 and #7
    "ranks_tp_serve": PATH_KERNELS["serve"],
    "ranks_tp_masked_serve": PATH_KERNELS["masked_serve"],
    "grok_tp_masked_serve": PATH_KERNELS["grok_masked_serve"],
    # TP experts: the rows quantized and permuted into E groups of C_exp
    # (no all-to-all), the padded GEMMs, GeGLU then #1
    "grok_tp_serve": PATH_KERNELS["grok_serve"],
    "dsv2_pod_train": PATH_KERNELS["dsv2_train"]})
PATH_RECIPES.update({"ranks_serve": ("fp8_flow", {}),
                     "ranks_serve_step": ("fp8_flow", {}),
                     "ranks_tp_serve": ("fp8_flow", {}),
                     "ranks_tp_masked_serve": ("fp8_flow", MASKED),
                     "tp_serve": ("fp8_flow", {}),
                     "tp_masked_serve": ("fp8_flow", MASKED),
                     "pod_train": ("fp8_flow", {})})
# grok1_314b's TP decode at the reference's production model axis (16):
# each rank's F-slice (32768 / 16 = 2048) of every expert
TP_PRODUCTION = 16
# the TP decode block's expert groups: C_exp = round_up(8 * 2 / 8 * 1.25,
# 128) for an 8-slot decode batch
TP_DECODE_C = 128
# the fixed-batch path of phase 42: prompts and new tokens a request
STEP_B, STEP_PROMPT, STEP_NEW = 8, 16, 8


def serve_trace(cfg):
    """make_serve's 16 greedy requests (prompts of 3-48 tokens, 16 new)."""
    from repro_torch.serve.scheduler import Request
    r = np.random.default_rng(0)
    return [Request(prompt=[int(t) for t in
                            r.integers(1, cfg.vocab, int(r.integers(3, 49)))],
                    max_new_tokens=16) for _ in range(16)]


def ranks_serve_run(cfg, dev, label, params, plan):
    """serve_trace through a ServeEngine on `params` (W8, shared by the
    runs) under `plan`: the tokens, each tick's logits (the prefill's last
    row; the decode step's rows with its active mask), and a row with
    tokens/s, the collectives a tick by kind and bytes, the peak and the
    launches (counts set to 0 just before the run)."""
    from repro_torch import kernels
    from repro_torch.dist import comm
    from repro_torch.serve import engine as E
    ecfg = E.ServeConfig(max_batch=8, page_size=8, n_pages=128,
                         max_pages_per_req=8, token_budget=512,
                         prefill_buckets=(16, 32, 64), fp8_kv=True,
                         w8_weights=True, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = E.ServeEngine(cfg, recipe_for(label), params, ecfg, device=dev,
                        plan=plan)
    reqs = serve_trace(cfg)
    ticks = []
    dec0, pre0 = E.paged_decode_step, E.paged_prefill

    def dec(*a, **kw):
        lg = dec0(*a, **kw)
        ticks.append((lg[:, -1], a[7]))
        return lg

    def pre(*a, **kw):
        lg = pre0(*a, **kw)
        ticks.append((lg[:, -1], None))
        return lg

    E.paged_decode_step, E.paged_prefill = dec, pre
    try:
        kernels.reset_launches()
        comm.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.run(reqs, realtime=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, coll = dict(kernels.LAUNCHES), comm.counts()
    finally:
        E.paged_decode_step, E.paged_prefill = dec0, pre0
    tokens = [results[q.rid]["tokens"] for q in reqs]
    n_tok = sum(len(t) for t in tokens)
    check(len(results) == len(reqs) and all(len(t) == 16 for t in tokens),
          f"{label}: not every request finished its 16 tokens")
    check(all(0 <= t < cfg.vocab for ts in tokens for t in ts),
          f"{label}: a token outside the vocabulary")
    check(eng.alloc.free_pages == ecfg.n_pages - 1,
          f"{label}: pages were not returned")
    check_launches(label, launches)
    n_ticks = results.stats["ticks"]
    row = dict(
        label=label, plan=None if plan is None else dict(
            moe_mode=plan.moe_mode, combine=plan.moe_tp_combine,
            mesh=None if plan.mesh is None else plan.mesh.shape,
            groups=plan.mesh is not None and plan.mesh.has_groups),
        tokens=n_tok, seconds=dt, tokens_per_s=n_tok / dt, ticks=n_ticks,
        collectives=coll, collectives_per_tick={
            k: dict(calls=v["calls"] / n_ticks, bytes=v["bytes"] / n_ticks)
            for k, v in coll.items()},
        tokens_sha256=hashlib.sha256(json.dumps(tokens).encode())
        .hexdigest(),
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches)
    print(json.dumps({"ranks_serve_run": row}))
    del eng
    torch.cuda.empty_cache()
    return tokens, ticks, row


def ticks_cosine(a, b):
    """The logits cosine of two runs' ticks over their live rows, up to
    and including the first tick whose greedy tokens differ (later ticks
    see other inputs); returns (cosine, ticks compared, all tokens
    equal)."""
    dot = na = nb = 0.0
    n, same = 0, True
    for (la, ma), (lb, mb) in zip(a, b):
        if ma is not None:
            la, lb = la[ma], lb[mb]
        x, y = la.double(), lb.double()
        dot += float((x * y).sum())
        na += float((x * x).sum())
        nb += float((y * y).sum())
        n += 1
        if not torch.equal(la.argmax(-1), lb.argmax(-1)):
            same = False
            break
    same = same and len(a) == len(b)
    return dot / max((na * nb) ** 0.5, 1e-300), n, same


def ranks_serve_step(cfg, dev, params, plan):
    """The fixed-batch path (serve_step.make_prefill / make_serve_step)
    with and without `plan`: STEP_B prompts of STEP_PROMPT tokens fed one
    token a step, then STEP_NEW greedy tokens; the prefill's logits of the
    whole prompts.  Returns (tokens, prefill logits) a run, the plan's
    launches and collectives."""
    from repro_torch import kernels
    from repro_torch.dist import comm
    from repro_torch.models.lm import init_cache
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    gen = torch.Generator(device=dev).manual_seed(5)
    prompts = torch.randint(1, cfg.vocab, (STEP_B, STEP_PROMPT),
                            generator=gen, device=dev)
    recipe = recipe_for("ranks_serve_step")
    out = {}
    for name, pl in (("groupless", None), ("plan", plan)):
        kernels.reset_launches()
        comm.reset_counts()
        prefill = make_prefill(cfg, recipe, plan=pl)
        step = make_serve_step(cfg, recipe, plan=pl)
        cache = init_cache(cfg, STEP_B, STEP_PROMPT + STEP_NEW, device=dev)
        with torch.inference_mode():
            lg = prefill(params, {"tokens": prompts})
            tok, toks = prompts[:, :1], []
            for t in range(STEP_PROMPT + STEP_NEW - 1):
                nxt, cache = step(params, cache, tok, t)
                tok = prompts[:, t + 1:t + 2] if t + 1 < STEP_PROMPT \
                    else nxt
                if t + 1 >= STEP_PROMPT:
                    toks.append(nxt[:, 0])
        out[name] = dict(tokens=torch.stack(toks, 1).tolist(), logits=lg,
                         launches=dict(kernels.LAUNCHES),
                         collectives=comm.counts())
        del cache
    return out


def tp_decode_kernel_checks(cfg, peaks, dev, mm):
    """#3 (GEMM-1 and GEMM-2), #5 (both) and #7 (GEMM-1 with the SwiGLU
    epilogue) at the TP decode block's shapes: E groups of C_exp = 128
    rows of which the decode plan `mm` (its live rows an expert, from
    grok's TP decode steps) fills a few; each against its twin, timed
    beside its bound and torch.bmm (the masked rows beside the padded
    kernel).  First the F of this phase's world-1 runs (every expert's
    whole F, its first experts where the stack passes GEMM_CHECK_ELEMS),
    then the F-slice a rank holds at the reference's production model
    axis (TP_PRODUCTION).  grok's GeGLU runs #5 then #1 on a masked
    recipe; #7 is what a SwiGLU config's TP decode runs."""
    gen = torch.Generator(device=dev).manual_seed(42)
    D, F, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    C = TP_DECODE_C
    record = KernelRows(peaks)
    for tp in (1, TP_PRODUCTION):
        Fl = F // tp
        Eg = experts_checked(E, D * 2 * Fl)
        m = mm[:Eg].contiguous()
        tag = f"grok tp_decode tp={tp}" + (f" ({Eg} of {E} E)" if Eg < E
                                           else "")
        print(json.dumps({"masked_plan": dict(
            path="grok tp_decode", tp=tp, **live_stats(m, C))}))
        w13 = blockq(gen, dev, Eg, D, 2 * Fl)
        w2 = blockq(gen, dev, Eg, Fl, D)
        check_gemm(record, f"{tag} gemm1", *dispatch_rows(gen, dev, m, C, D),
                   w13)
        check_gemm(record, f"{tag} gemm2",
                   *dispatch_rows(gen, dev, m, C, Fl), w2)
        if tp == 1:
            check_masked_gemm(record, f"{tag} gemm1",
                              *dispatch_rows(gen, dev, m, C, D), w13, m)
            check_masked_gemm(record, f"{tag} gemm2",
                              *dispatch_rows(gen, dev, m, C, Fl), w2, m)
            check_masked_swiglu(record, f"{tag} gemm1 (SwiGLU epilogue)",
                                *dispatch_rows(gen, dev, m, C, D), w13, m)
        del w13, w2
        torch.cuda.empty_cache()
    return record.rows


def launcher_tp_run(out_dir):
    """The serve launcher with --tp 1 in a subprocess on the card: a world
    of one on a FileStore (NCCL), make_plan (deepseek_v2_lite whole: EP),
    its serving cut and W8 experts; it must exit 0 and report its mesh."""
    import os
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "deepseek_v2_lite", "--device", "cuda", "--tp", "1",
           "--requests", "8", "--max-new", "8"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    print(run.stdout.strip())
    check(run.returncode == 0,
          f"the launcher --tp 1 exited {run.returncode}: "
          f"{run.stderr[-2000:]}")
    check("mesh={'data': 1, 'model': 1} moe_mode=ep" in run.stdout,
          "the launcher --tp 1 did not serve on its (1, 1) mesh")
    return dict(command=" ".join(cmd[1:]),
                seconds=time.perf_counter() - t0)


def serve_ranks_phase(dev, mesh, serve_tokens, dsv2_mesh_losses):
    """Phase 42: serving across ranks on the NCCL group of one rank.
    qwen3_moe_235b at depth 4 through the engine under make_plan(cfg,
    mesh) (EP; its FSDP lever is a training layout and serving keeps the
    weights whole but for the experts' cut), its W8 experts from the
    serving cut: phase 3's tokens bit for bit; the fixed-batch path with
    plan= against the group-less one: the same tokens; with TP experts (a
    lever at TP = 1), masked the padded tokens.  grok1_314b at
    depth 4 with TP experts on the group (moe_block_tp on W8 experts,
    every expert's whole F at TP = 1): the group-less TP run's tokens bit
    for bit, the logits at cosine >= 0.999 against the EP run
    (moe_block_decode) on the same weights, masked the padded tokens.
    #3, #5 and #7 at the TP decode shapes.  deepseek_v2_lite depth 4 trained on a (1, 1, 1) pod
    mesh: the (1, 1) mesh run's losses bit for bit (phase 40).  The serve
    launcher with --tp 1 on a world-1 FileStore mesh.  Collectives a
    tick by kind and bytes, tokens/s and peak a run."""
    from repro_torch.core import moe
    from repro_torch.launch.mesh import init_mesh, make_test_mesh
    from repro_torch.launch.sharding import make_plan, serving_cut
    from repro_torch.models.lm import ParallelPlan, init_params
    from repro_torch.serve.w8 import quantize_params_for_serving
    t_phase = time.perf_counter()
    launches, runs = {}, {}

    def w8_cut(cfg, plan):
        p = serving_cut(init_params(cfg, seed=0, device=dev), cfg, plan)
        p = quantize_params_for_serving(p)
        torch.cuda.empty_cache()
        return p

    cfg = serve_config()
    plan = make_plan(cfg, mesh)
    check(plan.moe_mode == "ep" and plan.dp_axes == ("data",),
          f"make_plan on (1, 1): {plan}")
    params = w8_cut(cfg, plan)
    tokens, _, runs["qwen3"] = ranks_serve_run(cfg, dev, "ranks_serve",
                                               params, plan)
    launches["ranks_serve"] = runs["qwen3"]["launches"]
    check(tokens == serve_tokens, "ranks_serve: the engine under make_plan "
          "on the NCCL group generated other tokens than phase 3")
    check(runs["qwen3"]["collectives"]["all-gather"]["calls"]
          >= runs["qwen3"]["ticks"]
          and runs["qwen3"]["collectives"]["all-to-all"]["calls"] > 0,
          f"ranks_serve: collectives {runs['qwen3']['collectives']}")
    # TP experts on qwen3 (a lever at TP = 1: make_plan picks EP for 128
    # experts): the masked recipe's tokens the padded run's bit for bit
    q_tp = ParallelPlan(mesh=mesh, moe_mode="tp")
    q_tp_tokens, _, runs["qwen3_tp"] = ranks_serve_run(
        cfg, dev, "ranks_tp_serve", params, q_tp)
    q_tpm_tokens, _, runs["qwen3_tp_masked"] = ranks_serve_run(
        cfg, dev, "ranks_tp_masked_serve", params, q_tp)
    check(q_tpm_tokens == q_tp_tokens, "qwen3 TP: the masked recipe "
          "generated other tokens than the padded one")
    launches["ranks_tp_serve"] = runs["qwen3_tp"]["launches"]
    launches["ranks_tp_masked_serve"] = runs["qwen3_tp_masked"]["launches"]
    step = ranks_serve_step(cfg, dev, params, plan)
    check(step["plan"]["tokens"] == step["groupless"]["tokens"],
          "serve_step with plan= generated other tokens than without")
    check_launches("ranks_serve_step", step["plan"]["launches"])
    launches["ranks_serve_step"] = step["plan"]["launches"]
    step_row = dict(
        prefill_logits_bitwise=torch.equal(step["plan"]["logits"],
                                           step["groupless"]["logits"]),
        collectives=step["plan"]["collectives"],
        tokens_sha256=hashlib.sha256(json.dumps(
            step["plan"]["tokens"]).encode()).hexdigest())
    del params, step
    torch.cuda.empty_cache()

    gcfg = arch_config("grok1_314b", GROK_SERVE_LAYERS)
    tp_plan = ParallelPlan(mesh=mesh, moe_mode="tp")
    params = w8_cut(gcfg, tp_plan)
    decode_ids, route0 = [], moe.router_topk

    def route(x, w_router, top_k):
        p, ids, aux = route0(x, w_router, top_k)
        if x.shape[0] == 8:                 # the 8-slot decode batch
            decode_ids.append(ids)
        return p, ids, aux

    moe.router_topk = route
    try:
        tp_tokens, tp_ticks, runs["grok_tp"] = ranks_serve_run(
            gcfg, dev, "grok_tp_serve", params, tp_plan)
    finally:
        moe.router_topk = route0
    launches["grok_tp_serve"] = runs["grok_tp"]["launches"]
    check(runs["grok_tp"]["collectives"]["all-to-all"]["calls"] == 0
          and runs["grok_tp"]["collectives"]["all-reduce"]["calls"] > 0,
          f"grok_tp_serve: collectives {runs['grok_tp']['collectives']}")
    gl_tokens, gl_ticks, runs["grok_tp_groupless"] = ranks_serve_run(
        gcfg, dev, "grok_tp_serve", params,
        ParallelPlan(mesh=make_test_mesh(dev), moe_mode="tp"))
    check(tp_tokens == gl_tokens, "grok TP on the NCCL group generated "
          "other tokens than the group-less TP run")
    logits_bitwise = all(torch.equal(a[0], b[0])
                         for a, b in zip(tp_ticks, gl_ticks))
    del gl_ticks
    gm_tokens, _, runs["grok_tp_masked"] = ranks_serve_run(
        gcfg, dev, "grok_tp_masked_serve", params, tp_plan)
    check(gm_tokens == tp_tokens, "grok TP: the masked recipe generated "
          "other tokens than the padded one")
    launches["grok_tp_masked_serve"] = runs["grok_tp_masked"]["launches"]
    ep_tokens, ep_ticks, runs["grok_ep"] = ranks_serve_run(
        gcfg, dev, "grok_serve", params, None)
    tp_ep_cos, n_cmp, tp_ep_same = ticks_cosine(tp_ticks, ep_ticks)
    check(tp_ep_cos >= 0.999, f"grok TP vs EP logits cosine {tp_ep_cos}")
    del tp_ticks, ep_ticks, params
    torch.cuda.empty_cache()
    E = gcfg.n_experts
    mms = sorted((torch.bincount(ids.reshape(-1), minlength=E)
                  .to(torch.int32) for ids in decode_ids),
                 key=lambda m: int((m > 0).sum()))
    rows = tp_decode_kernel_checks(gcfg, PEAKS, dev, mms[len(mms) // 2])

    pod_mesh = init_mesh(1, 1, pod=1, device=dev, timeout_s=300)
    check(pod_mesh.axis_names == ("pod", "data", "model"),
          f"the pod mesh's axes {pod_mesh.axis_names}")
    dcfg = arch_config("deepseek_v2_lite", DSV2_TRAIN_LAYERS)
    pod_row = tp_train_run(dcfg, dev, "dsv2_pod_train", pod_mesh, {},
                           state_policy="f32")
    check(pod_row["losses"] == dsv2_mesh_losses,
          f"dsv2 on the (1, 1, 1) pod mesh: losses {pod_row['losses']}, "
          f"the (1, 1) mesh's {dsv2_mesh_losses}")
    launches["dsv2_pod_train"] = pod_row["launches"]
    launcher = launcher_tp_run(ROOT / "build" / "smoke_launcher_tp")
    print(json.dumps({"serve_ranks": dict(
        config=f"qwen3_moe_235b and grok1_314b at depth 4 (W8 experts "
               f"from the serving cut), serve_trace (16 x 16 tokens); "
               f"deepseek_v2_lite depth {DSV2_TRAIN_LAYERS} {TP_STEPS} "
               f"steps on a (1, 1, 1) pod mesh",
        world=mesh.world, backend="nccl",
        by_run={k: dict(tokens_per_s=r["tokens_per_s"], ticks=r["ticks"],
                        collectives_per_tick=r["collectives_per_tick"],
                        peak_gib=r["max_memory_allocated_gib"])
                for k, r in runs.items()},
        serve_step=step_row, grok_tp_vs_groupless_logits_bitwise=
        logits_bitwise, grok_tp_vs_ep=dict(
            cosine=tp_ep_cos, ticks_compared=n_cmp,
            tokens_equal=tp_ep_same and tp_tokens == ep_tokens),
        tp_decode_plans=[m.tolist() for m in mms[:4]],
        pod=dict(losses=pod_row["losses"], ms=pod_row["ms_per_step_warm"],
                 collectives=pod_row["collectives_per_step"],
                 peak_gib=pod_row["max_memory_allocated_gib"]),
        launcher=launcher, seconds=time.perf_counter() - t_phase)}))
    return launches, rows


def qtensor_of(d, s):
    """A row-tiled (E, C, K) QTensor of payload d and scales s."""
    from repro_torch.core.quant import QTensor
    return QTensor(d, s, (1, 1, 128))


def dir_bytes(d) -> int:
    import os
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


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
    if "--nccl-two-ranks" in sys.argv:
        nccl_two_ranks_probe()
    if "--multi-gpu" in sys.argv:
        # phases 37-42 alone, after what they compare with: phase 3's
        # tokens and phase 35's group-less losses
        _, tokens, _ = serve_path(serve_config(), dev)
        tcfg = train_config()
        groupless = {"mono": overlap_train_run(tcfg, dev, "overlap_train",
                                               None)[0]["losses"]}
        for name in ("padded", "masked"):
            label = "overlap_train" if name == "padded" else \
                "overlap_masked_train"
            groupless[f"{name}2"] = overlap_train_run(tcfg, dev, label,
                                                      2)[0]["losses"]
        multi_gpu_phases(dev, groupless, tokens)
        print("chip_smoke --multi-gpu: phases 37-42 passed")
        return 0
    cfg = serve_config()
    timings = kernel_checks(cfg, PEAKS, dev, floor_ms)
    launches = {}
    launches["serve"], tokens, _ = serve_path(cfg, dev)
    serve_tokens = tokens
    launches["masked_serve"], _, plans = serve_path(
        cfg, dev, "masked_serve", padded_tokens=tokens)
    launches["bf16_serve"], _, _ = serve_path(cfg, dev, "bf16_serve")
    add_rows(timings, masked_serve_kernel_checks(cfg, PEAKS, dev, plans))
    for label in ("serve", "masked_serve", "bf16_serve"):
        gpu_vs_cpu(dev, label)
    tcfg = train_config()
    add_rows(timings, train_kernel_checks(tcfg, PEAKS, dev, floor_ms))
    launches["train"], losses, _ = train_path(tcfg, dev)
    train_losses = losses
    with plain_attention():
        train_path(tcfg, dev, name="train_plain_attention",
                   want_losses=PLAIN_TRAIN_LOSSES)
    launches["masked_train"], _, plan = train_path(
        tcfg, dev, "masked_train", padded_losses=losses)
    train_plan = plan
    add_rows(timings, masked_train_kernel_checks(tcfg, PEAKS, dev, plan,
                                                 tp=True))
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
                                             floor_ms, tp=tag == "dsv2"))
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
        c = dataclasses.replace(arch_config(ARCH_TAGS[tag], n),
                                remat_policy=TRAIN_POLICY.get(tag, "full"))
        with grown_segments(f"{tag}_train"):
            launches[f"{tag}_train"], _, _ = train_path(c, dev,
                                                        f"{tag}_train")
    launches["hy_bf16_train"], _, _ = train_path(
        arch_config("hymba_15b", NEW_TRAIN_LAYERS["hy"]), dev,
        "hy_bf16_train")
    for tag in ("m2", "hy", "sm", "lv"):
        gpu_vs_cpu_serve_step(dev, ARCH_TAGS[tag])
        gpu_vs_cpu_train(dev, "train", ARCH_TAGS[tag])
    for arch in ("hymba_15b", "seamless_m4t_v2"):
        gpu_vs_cpu_train(dev, "bf16_train", arch)

    # the training runtime (phases 22-26): the AdamW kernel alone; qwen3
    # at 2 layers and grok at 1 on the FP8-split state, which the f32
    # state cannot hold, and qwen3's 1 layer in both states on the same
    # batches; the runtime around qwen15_05b; GPU vs CPU with the state
    add_rows(timings, adamw_kernel_checks(PEAKS, dev))
    launches["q3_split_train"], _, _ = runtime_train_path(
        arch_config("qwen3_moe_235b", 2), dev, "q3_split_train_2l")
    one = {}
    for split in (True, False):
        _, one[split], peak = runtime_train_path(
            train_config(), dev, f"q3_{'split' if split else 'f32'}_train_1l",
            split_state=split)
    print(json.dumps({"q3_state_policies_1l": dict(
        split_losses=one[True], f32_losses=one[False],
        rel_diff=[abs(a - b) / abs(b) for a, b in zip(one[True],
                                                       one[False])])}))
    launches["grok_split_train"], _, _ = runtime_train_path(
        arch_config("grok1_314b", 1), dev, "grok_split_train", "grok_train")
    launches["qwen15_runtime"] = runtime_phase(arch_config("qwen15_05b"),
                                               dev)
    for arch in ("qwen3_moe_235b", "qwen15_05b"):
        gpu_vs_cpu_train(dev, "train", arch, split_state=True)

    # the activation-residency plan and the flash VJP (phases 27-28; phase
    # 29's deeper mamba2_27b and llava_next_34b runs are phase 20's)
    launches["dsv2_remat_train"] = policy_phase(dev)
    flash_vjp_phase(dev)

    # the rest of serving (phases 30-32): one random tree for the prefix
    # cache's engines and the fleet's two tiers, then the launcher
    from repro_torch.models.lm import init_params
    cfg = serve_config()
    params = init_params(cfg, seed=0, device=dev)
    launches["prefix_serve"], cached_tokens = prefix_cache_phase(cfg, dev,
                                                                 params)
    launches["fleet_serve"] = fleet_phase(cfg, dev, params, cached_tokens)
    del params
    torch.cuda.empty_cache()
    launcher_phase(ROOT / "build" / "smoke_launcher")

    # stage ranges, the roofline, the chunked MoE blocks and the
    # expected_m hint (phases 33-36)
    stage_and_roofline_phase(dev, train_losses, serve_tokens)
    ovl_launches, ovl_timings, ovl_losses = overlap_phase(
        tcfg, dev, PEAKS, floor_ms, serve_tokens)
    launches.update(ovl_launches)
    add_rows(timings, ovl_timings)
    expected_m_phase(tcfg, dev, train_plan)

    # the multi-GPU training and serving paths on an NCCL group of one
    # rank (phases 37-42)
    launches.update(multi_gpu_phases(dev, ovl_losses, serve_tokens,
                                     timings))

    from repro_torch.kernels import (adamw_update, fp8_transpose,
                                     fused_permute_pad, fused_swiglu_quant,
                                     grouped_gemm_fp8, grouped_gemm_nt_fp8,
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
               "quantize_rowwise_linear": quantize,
               "adamw_update": adamw_update}
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
                "copy_ms", "launch_floor_ms", "issue", "po2_ms", "mode",
                "elements", "bitwise", "launches")}
                for r in timings[kname]]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
