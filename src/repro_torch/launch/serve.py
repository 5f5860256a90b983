"""Serving launcher: the continuous-batching engine over paged FP8 KV and
W8-resident expert weights, on one device or a world of ranks.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_moe_235b \\
      --reduced --device cuda [--recipe {fp8_flow,bf16}] [--requests 16] \\
      [--bf16-kv] [--no-w8] [--prefix-cache] [--disagg \\
      [--prefill-replicas 1] [--decode-replicas 1] [--transfer-budget B]] \\
      [--obs-jsonl run.jsonl] [--obs-prom metrics.prom] [--tp N] \
      [--moe-tp-combine {psum_first,local_first,reduce_scatter}]

  # two ranks (gloo on the CPU, NCCL on cards): torchrun sets the world
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --reduced --device cpu --tp 2

The flags are the reference launcher's (``repro.launch.serve``) plus
``--device``, ``--tp`` (the model axis; ``--ep`` is its alias) and
``--moe-tp-combine`` (the reference reads it from the environment).
Every replica of a ``--disagg`` fleet runs on that one device (on each
rank).  The world comes from torchrun's variables when they are set,
else it is one rank; a mesh of (world / tp, tp) ranks is built
(``launch/mesh.py``) when the world is larger than one or ``--tp`` is
given, through a FileStore in a temporary directory at world 1.  Without
``--reduced`` the plan is the reference's ``make_plan(cfg, mesh)``
(``repro/launch/serve.py:71-77``): EP experts where E splits over the
model axis, else TP experts; with ``--reduced`` the EP plan.  Every rank
makes the world-1 weights, keeps its serving cut of the experts
(``launch.sharding.serving_cut``) and quantizes that, and serves the
same requests; ``--obs-*`` write on rank 0 only.  ``python -m repro_torch.obs.report run.jsonl`` renders what
``--obs-jsonl`` writes.  ``--arch`` takes the
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
import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core.recipes import RECIPES, get_recipe
from repro_torch.launch.mesh import close_mesh, init_mesh
from repro_torch.launch.sharding import make_plan, serving_cut
from repro_torch.models.lm import ParallelPlan, _paged_stacks, init_params
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import Request
from repro_torch.serve.w8 import quantize_params_for_serving


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
                    help="radix prefix cache: shared page-aligned prompt "
                         "prefixes are quantized+prefilled once and reused "
                         "across requests (refcounted FP8 KV pages)")
    ap.add_argument("--disagg", action="store_true",
                    help="prefill/decode disaggregation: a two-tier fleet "
                         "(prefill replicas park finished prefills; KV pages "
                         "migrate bit-for-bit to decode replicas under a "
                         "transfer-bytes budget)")
    ap.add_argument("--prefill-replicas", type=int, default=1)
    ap.add_argument("--decode-replicas", type=int, default=1)
    ap.add_argument("--transfer-budget", type=int, default=1 << 20,
                    metavar="BYTES",
                    help="KV migration wire bytes per router drain cycle")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--bf16-kv", action="store_true")
    ap.add_argument("--no-w8", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs-jsonl", default=None, metavar="PATH",
                    help="write structured serve telemetry (per-tick "
                         "records, request_done events with TTFT/TBT, "
                         "KV-pool occupancy) as JSONL for "
                         "`python -m repro_torch.obs.report`")
    ap.add_argument("--obs-prom", default=None, metavar="PATH",
                    help="write a Prometheus text-exposition snapshot of "
                         "the serve metrics registry at exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain twins)")
    ap.add_argument("--tp", "--ep", dest="tp", type=int, default=None,
                    help="ranks of the mesh's model axis (expert-parallel "
                         "or tensor-parallel experts, by the plan); given, "
                         "or at a world above one, a mesh is built")
    ap.add_argument("--moe-tp-combine", default="local_first",
                    choices=["psum_first", "local_first", "reduce_scatter"],
                    help="the TP MoE block's combine")
    args = ap.parse_args(argv)

    world = int(os.environ.get("WORLD_SIZE", 1))
    tp = args.tp or 1
    if world % tp:
        raise ValueError(f"--tp {tp} does not divide the world {world}")
    mesh = store_dir = None
    if world > 1 or args.tp is not None:
        store = None
        if "RANK" not in os.environ:
            store_dir = tempfile.mkdtemp(prefix="repro_torch_store_")
            store = os.path.join(store_dir, "store")
        mesh = init_mesh(world // tp, tp, device=args.device, store=store)
    try:
        return _run(args, mesh)
    finally:
        if mesh is not None:
            close_mesh()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)


def _run(args, mesh):
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    _paged_stacks(cfg)              # refuses a stack the engine cannot page
    recipe = get_recipe(args.recipe)
    device = args.device if mesh is None else mesh.device
    if mesh is not None and not args.reduced:
        plan = make_plan(cfg, mesh, moe_tp_combine=args.moe_tp_combine)
    else:
        plan = ParallelPlan(mesh=mesh, moe_tp_combine=args.moe_tp_combine)
    lead = mesh is None or mesh.rank == 0
    # every rank makes the world-1 weights and keeps its serving cut, W8
    # once for every replica of a fleet
    params = serving_cut(init_params(cfg, seed=0, device=device), cfg, plan)
    if not args.no_w8 and recipe.name == "fp8_flow":
        params = quantize_params_for_serving(params)
    ecfg = ServeConfig(
        max_batch=args.max_batch, page_size=args.page_size,
        n_pages=args.n_pages, max_pages_per_req=args.max_pages,
        token_budget=args.token_budget, prefill_buckets=(16, 32, 64),
        prefill_chunk=args.prefill_chunk, fp8_kv=not args.bf16_kv,
        w8_weights=not args.no_w8, prefix_cache=args.prefix_cache,
        seed=args.seed)
    from repro_torch.obs.sink import JsonlSink, Telemetry, null_telemetry
    if args.obs_jsonl is not None or args.obs_prom is not None:
        sinks = (JsonlSink(args.obs_jsonl),) if args.obs_jsonl and lead \
            else ()
        tel = Telemetry(sinks=sinks)
    else:
        tel = null_telemetry()
    if args.disagg:
        from repro_torch.serve.router import DisaggConfig, DisaggRouter
        pes = [ServeEngine(cfg, recipe, params,
                           dataclasses.replace(ecfg, role="prefill"),
                           device=device, telemetry=tel, plan=plan)
               for _ in range(args.prefill_replicas)]
        des = [ServeEngine(cfg, recipe, params,
                           dataclasses.replace(ecfg, role="decode"),
                           device=device, telemetry=tel, plan=plan)
               for _ in range(args.decode_replicas)]
        runner = DisaggRouter(
            pes, des, dcfg=DisaggConfig(
                transfer_budget_bytes=args.transfer_budget), telemetry=tel)
        engine = pes[0]
        print(f"[serve] disaggregated fleet: {len(pes)} prefill + "
              f"{len(des)} decode replicas, transfer budget "
              f"{args.transfer_budget / 2**20:.2f} MiB/cycle")
    else:
        engine = ServeEngine(cfg, recipe, params, ecfg, device=device,
                             telemetry=tel, plan=plan)
        runner = engine
    print(f"[serve] {args.arch} recipe={recipe.name} device={device} "
          f"kv={'fp8' if ecfg.fp8_kv else 'bf16'} w8={ecfg.w8_weights} "
          f"pool={engine.kv_bytes() / 2**20:.1f} MiB mesh="
          f"{None if mesh is None else mesh.shape} moe_mode={plan.moe_mode}"
          f" rank={0 if mesh is None else mesh.rank}")

    r = np.random.default_rng(args.seed)
    reqs = [Request(prompt=[int(t) for t in
                            r.integers(1, cfg.vocab, int(r.integers(3, 17)))],
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    results = runner.run(reqs, realtime=False)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v["tokens"]) for v in results.values())
    print(f"[serve] {len(results)}/{args.requests} requests, {n_tok} tokens "
          f"in {dt:.2f}s ({n_tok / dt:.1f} tok/s on {device}), "
          f"max concurrent {engine.max_concurrent}")
    s = results.stats
    print(f"[serve] ticks={s['ticks']} admitted={s['admitted']} "
          f"evicted={s['evicted']} finished={s['finished']} "
          f"prefill_chunks={s['prefill_chunks']} "
          f"decode_tokens={s['decode_tokens']}")
    if args.disagg:
        d = s["disagg"]
        print(f"[serve] disagg: migrations={d['migrations']} "
              f"wire={d['kv_transfer_bytes'] / 2**20:.2f} MiB "
              f"shipped_pages={d['shipped_pages']} "
              f"deduped_pages={d['deduped_pages']} "
              f"requeued={d['requeued_evictions']} "
              f"deferrals={d['budget_deferrals']}")
    if args.prefix_cache:
        total_prompt = sum(len(q.prompt) for q in reqs)
        print(f"[serve] prefix cache: hits={s['prefix_hits']}/"
              f"{s['prefix_lookups']} hit_tokens={s['prefix_hit_tokens']}"
              f"/{total_prompt} shared_pages={s['shared_pages']} "
              f"cache_evictions={s['cache_evictions']}")
    if args.obs_prom is not None and lead:
        tel.write_prometheus(args.obs_prom)
        print(f"[serve] wrote metrics snapshot to {args.obs_prom}")
    if args.obs_jsonl is not None and lead:
        tel.emit_registry()
        tel.close()
        print(f"[serve] wrote telemetry to {args.obs_jsonl} "
              f"(report: python -m repro_torch.obs.report {args.obs_jsonl})")
    return results


if __name__ == "__main__":
    main()
