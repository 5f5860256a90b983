"""Serving example on the PyTorch port: continuous batching over a reduced
MoE model -- paged FP8 KV cache, W8-resident expert weights, FCFS
scheduling with a token budget, a prefill chunk and the decode batch each
tick.

The port of ``examples/serve_moe.py``: one device and no mesh.

Run:  PYTHONPATH=src python examples/serve_moe_torch.py [--bf16-kv] \\
          [--temperature 0.8] [--device cuda|cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core.recipes import get_recipe
from repro_torch.models.lm import init_params
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bf16-kv", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain twins)")
    args = ap.parse_args(argv)

    cfg = get_arch("qwen3_moe_235b").reduced()
    recipe = get_recipe("fp8_flow")
    params = init_params(cfg, seed=0, device=args.device)

    ecfg = ServeConfig(max_batch=4, page_size=8, n_pages=64,
                       max_pages_per_req=8, token_budget=256,
                       prefill_buckets=(16, 32), fp8_kv=not args.bf16_kv,
                       w8_weights=True, top_k=8)
    engine = ServeEngine(cfg, recipe, params, ecfg, device=args.device)
    print(f"paged KV pool: {engine.kv_bytes()/2**20:.1f} MiB "
          f"({'fp8+po2-scales' if ecfg.fp8_kv else 'bf16'}), "
          f"{ecfg.max_batch} slots, {ecfg.n_pages} pages x "
          f"{ecfg.page_size} tokens")

    r = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in
                            r.integers(1, cfg.vocab, int(r.integers(3, 15)))],
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    results = engine.run(reqs, realtime=False)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v["tokens"]) for v in results.values())
    print(f"served {len(results)} requests ({n_tok} tokens) in {dt:.2f}s; "
          f"max concurrent batch {engine.max_concurrent}")
    for rid in sorted(results)[:4]:
        print(f"  req {rid}: {results[rid]['tokens']}")
    return results


if __name__ == "__main__":
    main()
