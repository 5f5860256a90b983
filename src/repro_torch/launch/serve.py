"""Serving launcher: the continuous-batching engine over paged FP8 KV and
W8-resident expert weights, on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_moe_235b \\
      --reduced --device cuda [--recipe {fp8_flow,bf16}] [--requests 16] \\
      [--bf16-kv] [--no-w8]

The flags are the reference launcher's (``repro.launch.serve``) plus
``--device``.  The prefix cache, disaggregation and telemetry flags are
accepted and raise until those slices are ported.  ``--arch`` takes the
attention-only decoders: qwen15_05b, qwen3_moe_235b, deepseek_v2_lite,
deepseek_v3_671b, starcoder2_15b, gemma3_4b, gemma2_9b and grok1_314b.
The paged engine refuses llava_next_34b, seamless_m4t_v2, mamba2_27b and
hymba_15b before any weight is made, as the reference's does: they serve
through ``repro_torch.serve.serve_step`` (``make_prefill``,
``make_serve_step``).  Without ``--reduced`` the full
config is built: one 80 GB card holds qwen15_05b, deepseek_v2_lite (W8
experts), starcoder2_15b (40 layers, 32 GB), gemma3_4b (34 layers; every
layer local, the reference's rule for a pattern that does not divide the
depth) and gemma2_9b (42 layers) whole; qwen3_moe_235b, deepseek_v3_671b
and grok1_314b only at a cut depth (``chip_smoke.py`` serves them at 4
layers).
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core.recipes import RECIPES, get_recipe
from repro_torch.models.lm import _paged_stacks, init_params
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_moe_235b")
    ap.add_argument("--recipe", default="fp8_flow", choices=RECIPES,
                    help="bf16 or fp8_flow; blockwise and naive_fp8 "
                    "raise (the reference cannot decode them)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--n-pages", type=int, default=128)
    ap.add_argument("--max-pages", type=int, default=8)
    ap.add_argument("--token-budget", type=int, default=512)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: max prompt tokens per tick")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="not ported yet (raises)")
    ap.add_argument("--disagg", action="store_true",
                    help="not ported yet (raises)")
    ap.add_argument("--prefill-replicas", type=int, default=1)
    ap.add_argument("--decode-replicas", type=int, default=1)
    ap.add_argument("--transfer-budget", type=int, default=1 << 20,
                    metavar="BYTES")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--bf16-kv", action="store_true")
    ap.add_argument("--no-w8", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs-jsonl", default=None, metavar="PATH",
                    help="not ported yet (raises)")
    ap.add_argument("--obs-prom", default=None, metavar="PATH",
                    help="not ported yet (raises)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain twins)")
    args = ap.parse_args(argv)
    if args.disagg or args.obs_jsonl or args.obs_prom:
        raise NotImplementedError(
            "--disagg / --obs-* are not ported yet (ROADMAP.md, Queue 1)")

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    _paged_stacks(cfg)              # refuses a stack the engine cannot page
    recipe = get_recipe(args.recipe)
    params = init_params(cfg, seed=0, device=args.device)
    ecfg = ServeConfig(
        max_batch=args.max_batch, page_size=args.page_size,
        n_pages=args.n_pages, max_pages_per_req=args.max_pages,
        token_budget=args.token_budget, prefill_buckets=(16, 32, 64),
        prefill_chunk=args.prefill_chunk, fp8_kv=not args.bf16_kv,
        w8_weights=not args.no_w8, prefix_cache=args.prefix_cache,
        seed=args.seed)
    engine = ServeEngine(cfg, recipe, params, ecfg, device=args.device)
    print(f"[serve] {args.arch} recipe={recipe.name} device={args.device} "
          f"kv={'fp8' if ecfg.fp8_kv else 'bf16'} w8={ecfg.w8_weights} "
          f"pool={engine.kv_bytes() / 2**20:.1f} MiB")

    r = np.random.default_rng(args.seed)
    reqs = [Request(prompt=[int(t) for t in
                            r.integers(1, cfg.vocab, int(r.integers(3, 17)))],
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    results = engine.run(reqs, realtime=False)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v["tokens"]) for v in results.values())
    print(f"[serve] {len(results)}/{args.requests} requests, {n_tok} tokens "
          f"in {dt:.2f}s ({n_tok / dt:.1f} tok/s on {args.device}), "
          f"max concurrent {engine.max_concurrent}")
    s = results.stats
    print(f"[serve] ticks={s['ticks']} admitted={s['admitted']} "
          f"evicted={s['evicted']} finished={s['finished']} "
          f"prefill_chunks={s['prefill_chunks']} "
          f"decode_tokens={s['decode_tokens']}")


if __name__ == "__main__":
    main()
