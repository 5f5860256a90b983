"""Training launcher: the train loop of any recipe on one device or a
world of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_v2_lite \\
      --reduced --device cuda [--recipe {bf16,blockwise,naive_fp8,fp8_flow}] \\
      [--steps 20] [--seq-len 256] [--global-batch 8] [--ckpt-dir DIR] \\
      [--grad-accum N] [--guard [--guard-spike-factor F] \\
      [--guard-rollback-after K] [--guard-demote-steps N]] [--elastic] \\
      [--remat-policy {none,full,fp8_resident,pair}] \\
      [--dist-wire {off,fp8,bf16,f32}] [--dist-schedule {posthoc,stream}] \\
      [--tp N] [--moe-tp-combine {psum_first,local_first,reduce_scatter}] \\
      [--mlp-tp] [--obs-jsonl PATH] [--obs-prom PATH]

  # four ranks (gloo on the CPU, NCCL on cards): torchrun sets the world
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --reduced --device cpu --dist-wire fp8 --steps 4 --global-batch 8

The flags are the reference launcher's (``repro.launch.train``), plus
``--device`` (``cuda``: the hand-written kernels; ``cpu``: their plain
twins), ``--tp`` (the model axis; ``--ep`` is its alias),
``--moe-tp-combine`` and ``--mlp-tp`` (the reference reads the last two
from environment variables).  The world comes from torchrun's variables
when they are set, else it is one rank; a mesh of (world / tp, tp) ranks
is built (``launch/mesh.py``) whenever the world is larger than one,
``--tp`` is larger than one or a wire is asked for, through a FileStore
in a temporary directory at world 1.  Each rank trains on its share of
every global batch (``launch/sharding.py``).

- The plan: without ``--reduced``, on a mesh, the reference's production
  plan, ``launch.sharding.make_plan(cfg, mesh)`` (``repro/launch/
  train.py:141-142``): experts on E over the model axis where they split
  (EP), else F-sliced (TP, ``moe_block_tp``), and FSDP over data where the
  config says so.  With ``--reduced`` (as the reference's DP-only mesh)
  the EP plan with the two keywords' levers.
- ``--dist-wire fp8|bf16|f32``: the DistPlan step (the FP8 DP gradient
  wire and ZeRO-1; DistPlan's FP8-split state), over the data axis; it
  refuses ``--tp`` > 1, as the reference's does.  ``--dist-schedule
  stream``: the streaming wire (each layer's buckets sent from inside the
  backward, the layer-aligned layout); where
  ``dist.plan.streaming_fallback_reason`` gives a reason it prints the
  reference's WARNING and runs the post-hoc schedule on the same layout.
- ``--tp N``: the model axis of N ranks: the expert-parallel all-to-all
  (each rank holds E / N experts), or with TP experts and ``--mlp-tp``
  the F-sliced stages; gradients all-reduced in f32.
- ``--multi-pod``: the reference's pod axis (``make_production_mesh(
  multi_pod=True)``): a (pod, data, model) mesh of (2, world / (2 tp),
  tp) ranks (a world that does not divide raises).  The batch is cut over
  every rank, the replicated leaves' gradients are summed over pod x data
  (x model), FSDP stays over data; the DistPlan wire refuses the pod
  axis, as the reference's does (it needs a DP-only mesh).

The steps run through ``train.loop.run``:

- ``--ckpt-dir``: async checkpoints every 50 steps, restart from the
  newest complete one.
- ``--grad-accum N``: N microbatches a step, their gradients summed in f32.
- ``--guard``: the numerics guardrails (``train/guards.py``): the in-step
  anomaly bitmask, and the skip -> rollback -> bf16-demote ladder with a
  bf16 fallback step.
- ``--elastic``: the host-health bookkeeping of ``ElasticTrainer`` (one
  data shard on one device).
- ``--remat-policy``: the activation-residency plan (``train/memory.py``)
  in place of the config's (``full``).
- ``--obs-jsonl`` / ``--obs-prom``: structured telemetry as JSONL, and a
  Prometheus text snapshot of the registry at exit.

The optimizer is the reference launcher's ``AdamWConfig(lr=...)``: f32 state, 16 bytes a
parameter with the bf16 weights and gradients; ``AdamWConfig(
state_policy=StatePolicy())`` (the FP8-split state, ~9 bytes) is reached
through ``repro_torch.train.train_step``, as ``chip_smoke.py`` does.

``--arch`` takes every config (``repro_torch.configs.ARCH_IDS``); the
default is the paper's convergence model, deepseek_v2_lite, as in the
reference.  The batches are make_batch's tokens, as the reference
launcher's: llava_next_34b trains without its vision prefix, and
seamless_m4t_v2 (an encoder-decoder, whose batch needs an encoder input)
raises, where the reference raises KeyError.  Without ``--reduced`` the
full config is built: at 16 bytes a parameter one card trains only
qwen15_05b and hymba_15b at full depth; the depths of the cut runs are in
PERF.md section 4.
"""
import argparse
import dataclasses
import os
import shutil
import tempfile

from repro_torch.configs import get_arch
from repro_torch.core.recipes import RECIPES, get_recipe
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist.grad_comm import wire_grad_bytes
from repro_torch.dist.plan import (DistPlan, build_layout,
                                   streaming_fallback_reason)
from repro_torch.launch.mesh import close_mesh, init_mesh
from repro_torch.launch.sharding import make_plan, shard_batch
from repro_torch.models.lm import ParallelPlan
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.fault_tolerance import ElasticTrainer
from repro_torch.train.guards import GuardPlan, GuardPolicy
from repro_torch.train.loop import run as run_loop
from repro_torch.train.train_step import init_train_state, make_train_step

# the reference's multi-pod production mesh has two pods
# (repro/launch/mesh.py: make_production_mesh(multi_pod=True), (2, 16, 16))
POD = 2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek_v2_lite")
    ap.add_argument("--recipe", default="fp8_flow", choices=RECIPES)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain twins)")
    ap.add_argument("--dist-wire", default="off",
                    choices=["off", "fp8", "bf16", "f32"],
                    help="explicit DP gradient wire + ZeRO-1 (repro_torch."
                         "dist): fp8 = e4m3 payload + po2 exponents in one "
                         "uint8 message per bucket; bf16/f32 = the same "
                         "bucketed reduce-scatter with a plain payload")
    ap.add_argument("--dist-schedule", default="posthoc",
                    choices=["posthoc", "stream"],
                    help="DP wire schedule: posthoc (after the backward) or "
                         "stream (each layer's buckets from inside it)")
    ap.add_argument("--tp", "--ep", dest="tp", type=int, default=1,
                    help="ranks of the mesh's model axis (expert-parallel "
                         "or tensor-parallel, by the plan)")
    ap.add_argument("--moe-tp-combine", default="local_first",
                    choices=["psum_first", "local_first", "reduce_scatter"],
                    help="the TP MoE block's combine")
    ap.add_argument("--mlp-tp", action="store_true",
                    help="F-slice the dense MLPs and shared experts over "
                         "the model axis where (F / tp) % 128 == 0")
    ap.add_argument("--multi-pod", action="store_true",
                    help="a leading pod axis of 2 (pure data parallelism): "
                         "a (2, world / (2 tp), tp) mesh")
    ap.add_argument("--remat-policy", default=None,
                    choices=["none", "full", "fp8_resident", "pair"],
                    help="activation-residency plan (default: the config's, "
                         "full): none keeps what autograd saves; full keeps "
                         "the bf16 stage outputs and recomputes the rest of "
                         "each layer; fp8_resident keeps only the FFN's FP8 "
                         "qx/qa; pair keeps one input every two layers and "
                         "recomputes everything")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per step, gradients summed in f32")
    ap.add_argument("--guard", action="store_true",
                    help="arm the numerics guardrails (train/guards.py): "
                         "in-step anomaly bitmask + skip/rollback/demote "
                         "recovery ladder with a bf16 fallback step")
    ap.add_argument("--guard-spike-factor", type=float, default=4.0,
                    help="grad-norm spike threshold as a multiple of the "
                         "carried EMA")
    ap.add_argument("--guard-rollback-after", type=int, default=3,
                    help="consecutive anomalous steps before restoring the "
                         "last valid checkpoint")
    ap.add_argument("--guard-demote-steps", type=int, default=8,
                    help="length of the bf16 fallback window entered after "
                         "persistent anomalies")
    ap.add_argument("--obs-jsonl", default=None, metavar="PATH",
                    help="write structured telemetry (typed loop events, "
                         "per-step samples with per-site FP8 sat/flush, "
                         "cast-ledger snapshots) as JSONL")
    ap.add_argument("--obs-prom", default=None, metavar="PATH",
                    help="write a Prometheus text-exposition snapshot of "
                         "the metrics registry at exit")
    args = ap.parse_args(argv)
    dist = DistPlan(wire=args.dist_wire, schedule=args.dist_schedule) \
        if args.dist_wire != "off" else None
    world = int(os.environ.get("WORLD_SIZE", 1))
    pod = POD if args.multi_pod else None
    if world % (args.tp * (pod or 1)):
        raise ValueError(f"--tp {args.tp}" + (f" x --multi-pod's {pod} pods"
                                               if pod else "")
                         + f" does not divide the world {world}")
    mesh = store_dir = None
    if world > 1 or args.tp > 1 or dist is not None or pod:
        store = None
        if "RANK" not in os.environ:
            store_dir = tempfile.mkdtemp(prefix="repro_torch_store_")
            store = os.path.join(store_dir, "store")
        mesh = init_mesh(world // args.tp // (pod or 1), args.tp, pod=pod,
                         device=args.device, store=store)
    try:
        return _run(args, dist, mesh)
    finally:
        if mesh is not None:
            close_mesh()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)


def _run(args, dist, mesh):
    from repro_torch.obs.sink import JsonlSink, Telemetry, null_telemetry
    if args.obs_jsonl is not None or args.obs_prom is not None:
        sinks = (JsonlSink(args.obs_jsonl),) if args.obs_jsonl else ()
        tel = Telemetry(sinks=sinks)
    else:
        tel = null_telemetry()

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.remat_policy is not None:
        cfg = dataclasses.replace(cfg, remat_policy=args.remat_policy)
    if cfg.encdec:
        # the reference launcher's make_batch has no encoder input either:
        # its forward raises KeyError('enc_input') on the first step
        raise ValueError(
            f"{args.arch} is an encoder-decoder: its batch needs "
            "'enc_input' (B, S_enc, D), which make_batch does not make; "
            "train it through repro_torch.train.train_step with your own "
            "batches")
    recipe = get_recipe(args.recipe)
    opt = AdamWConfig(lr=args.lr)
    guard = GuardPlan(spike_factor=args.guard_spike_factor) \
        if args.guard else None
    dev = args.device if mesh is None else mesh.device
    print(f"[train] {args.arch} ({cfg.n_params() / 1e9:.2f}B params) "
          f"recipe={recipe.name} remat={cfg.remat_policy} "
          f"device={dev} mesh={None if mesh is None else mesh.shape}")
    if mesh is not None and not args.reduced:
        plan = make_plan(cfg, mesh, moe_tp_combine=args.moe_tp_combine,
                         mlp_tp=args.mlp_tp)
    else:
        plan = ParallelPlan(mesh=mesh, moe_tp_combine=args.moe_tp_combine,
                            mlp_tp=args.mlp_tp)
    print(f"[train] plan: moe_mode={plan.moe_mode} fsdp_axis="
          f"{plan.fsdp_axis} mlp_tp={plan.mlp_tp} combine="
          f"{plan.moe_tp_combine}")
    state = init_train_state(cfg, opt, seed=0, device=dev, guard=guard,
                             dist=dist, mesh=mesh, plan=plan)
    if dist is not None:
        layout = build_layout(state["params"], dist)
        n_dp = mesh.shape[dist.axis]
        gbytes = sum(wire_grad_bytes(b.rows * 128, n_dp, dist.wire)
                     for b in layout.buckets)
        print(f"[train] dist wire={dist.wire} schedule={dist.schedule} "
              f"zero1 over '{dist.axis}' x{n_dp}: {len(layout.buckets)} "
              f"buckets, {len(layout.sensitive)} sensitive leaves, "
              f"~{gbytes / 2**20:.2f} MiB grad bytes/step/device")
        tel.record("wire_layout", wire=dist.wire, schedule=dist.schedule,
                   n_dp=n_dp, n_buckets=len(layout.buckets),
                   n_sensitive=len(layout.sensitive),
                   n_leaves=layout.n_leaves, fp8_elems=layout.fp8_elems,
                   wire_rows=layout.wire_rows, grad_bytes_per_step=gbytes)
        if dist.schedule == "stream":
            # the reference's visible fallback: the layered layout stays,
            # so the ZeRO-1 state is the same either way
            reason = streaming_fallback_reason(cfg, layout,
                                               grad_accum=args.grad_accum)
            if reason:
                print(f"[train] WARNING: streaming wire unavailable "
                      f"({reason}); falling back to the post-hoc schedule")
                dist = dataclasses.replace(dist, schedule="posthoc")
    warmup = max(args.steps // 10, 1)
    step = make_train_step(cfg, recipe, opt, grad_accum=args.grad_accum,
                           total_steps=args.steps, warmup_steps=warmup,
                           guard=guard, dist=dist, plan=plan)
    policy = fallback = None
    if guard is not None:
        policy = GuardPolicy(rollback_after=args.guard_rollback_after,
                             demote_steps=args.guard_demote_steps)
        # graceful degradation target: the same arch and optimizer under
        # the bf16 recipe (no quantize sites), still guarded so the ladder
        # keeps observing while demoted
        if recipe.name != "bf16":
            fallback = make_train_step(
                cfg, get_recipe("bf16"), opt, grad_accum=args.grad_accum,
                total_steps=args.steps, warmup_steps=warmup, guard=guard,
                dist=dist, plan=plan)
        print(f"[train] guardrails armed: spike_factor="
              f"{args.guard_spike_factor} rollback_after="
              f"{args.guard_rollback_after} demote_steps="
              f"{args.guard_demote_steps}")
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    elastic = ElasticTrainer(n_data_shards=1) if args.elastic else None
    state, hist = run_loop(step, state, data, n_steps=args.steps,
                           grad_accum=args.grad_accum,
                           ckpt_dir=args.ckpt_dir, elastic=elastic,
                           guard_policy=policy, fallback_step=fallback,
                           telemetry=tel, log_every=1,
                           batch_fn=None if mesh is None else
                           (lambda b: shard_batch(b, mesh)))
    if not hist:
        print(f"[train] done: nothing to run (restored past step "
              f"{args.steps - 1})")
        return []
    losses = [h["loss"] for h in hist]
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    dev_ms = [h["device_ms"] for h in hist]
    fetch_ms = [h["fetch_ms"] for h in hist]
    print(f"[train] timing: device {sum(dev_ms)/len(dev_ms):.1f}ms/step, "
          f"host fetch {sum(fetch_ms)/len(fetch_ms):.1f}ms/step "
          f"({len(hist)} steps)")
    if args.obs_prom is not None:
        tel.write_prometheus(args.obs_prom)
        print(f"[train] wrote metrics snapshot to {args.obs_prom}")
    if args.obs_jsonl is not None:
        tel.emit_registry()
        tel.close()
        print(f"[train] wrote telemetry to {args.obs_jsonl}")
    return losses


if __name__ == "__main__":
    main()
