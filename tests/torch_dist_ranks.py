"""What each CPU rank of the port's multi-rank tests runs
(``torch_dist_harness.run_ranks`` spawns them).  Torch only: a spawned
rank imports this module, not the test module and its jax."""
import numpy as np
import torch

from repro_torch.core import casts, moe
from repro_torch.core.recipes import get_recipe


def recipe_of(name):
    if name == "masked":
        return get_recipe("fp8_flow", masked_experts=True,
                          swiglu_epilogue=True)
    return get_recipe(name)


def np32(t):
    return t.detach().to(torch.float32).numpy()


def ep_block(mesh, spec, arrays, cases):
    """Each case ('recipe|ep|kind|n') of the port's EP blocks on this
    rank's share: its tokens (train blocks; decode blocks see the whole
    replicated batch), its E / EP experts, the full router.  Returns, per
    case, the local output, drop fraction, gradients of the local
    sum(y**2) (the global loss is their sum), the activation casts and
    the collectives' calls by kind."""
    from repro_torch.dist import comm
    x, xd, wr, w13, w2 = arrays
    E, topk, cf = spec
    ep, m = mesh.ep, mesh.model_index
    e_loc = E // ep
    out = []
    for case in cases:
        name, _, kind, n = case.split("|")
        n = int(n)
        recipe = recipe_of(name)
        cfg = moe.MoEConfig(n_experts=E, top_k=topk, d_model=x.shape[1],
                            d_ff=w2.shape[1], capacity_factor=cf,
                            ep_group=mesh.model_group)
        decode = kind.startswith("decode")
        T = (xd if decode else x).shape[0]
        rows = slice(None) if decode else slice(m * T // ep,
                                                (m + 1) * T // ep)
        xs = torch.tensor((xd if decode else x)[rows]).to(torch.bfloat16)
        wrt = torch.tensor(wr)
        w13t = torch.tensor(w13[m * e_loc:(m + 1) * e_loc])
        w2t = torch.tensor(w2[m * e_loc:(m + 1) * e_loc])
        comm.reset_counts()
        if decode:
            blk = moe.moe_block_decode if kind == "decode" else \
                (lambda *a: moe.moe_block_decode_overlapped(*a, n_chunks=n))
            with torch.no_grad():
                y, met = blk(recipe, cfg, xs, wrt, w13t, w2t)
            out.append(dict(y=np32(y), drop=float(met["drop_frac"]),
                            coll=comm.counts()))
            continue
        for t in (xs, wrt, w13t, w2t):
            t.requires_grad_()
        with casts.ledger() as led:
            if kind == "mono":
                y, met = moe.moe_block(recipe, cfg, xs, wrt, w13t, w2t)
            else:
                y, met = moe.moe_block_overlapped(recipe, cfg, xs, wrt, w13t,
                                                  w2t, n_chunks=n)
            (y.to(torch.float32) ** 2).sum().backward()
        out.append(dict(y=np32(y), drop=float(met["drop_frac"]),
                        gx=np32(xs.grad), gwr=np32(wrt.grad),
                        gw13=np32(w13t.grad), gw2=np32(w2t.grad),
                        casts=led.activation_casts(), coll=comm.counts()))
    return out


def tp_block(mesh, spec, arrays, cases):
    """Each case ('recipe|tp|combine') of moe_block_tp on this rank: the
    whole x and router, its F-slice of every expert (w13 (E, D, 2, F) and
    w2 (E, F, D) cut on F over the model axis).  The output is replicated
    (own rows under reduce_scatter); each rank backprops the cotangent of
    the one loss sum(y**2) (the replicated output's, or its rows').
    Returns per case the output, drop fraction, gradients, activation
    casts, the collectives by kind and the ledger's tags."""
    from repro_torch.dist import comm
    x, wr, w13, w2 = arrays
    E, topk, cf = spec
    tp, m = mesh.ep, mesh.model_index
    F = w2.shape[1]
    fl = F // tp
    out = []
    for case in cases:
        name, _, combine = case.split("|")
        recipe = recipe_of(name)
        cfg = moe.MoEConfig(n_experts=E, top_k=topk, d_model=x.shape[1],
                            d_ff=fl, capacity_factor=cf)
        xs = torch.tensor(x).to(torch.bfloat16)
        wrt = torch.tensor(wr)
        w13t = torch.tensor(np.ascontiguousarray(
            w13[..., m * fl:(m + 1) * fl]))
        w2t = torch.tensor(np.ascontiguousarray(w2[:, m * fl:(m + 1) * fl]))
        for t in (xs, wrt, w13t, w2t):
            t.requires_grad_()
        comm.reset_counts()
        with casts.ledger() as led:
            y, met = moe.moe_block_tp(
                recipe, cfg, xs, wrt, w13t.reshape(E, x.shape[1], 2 * fl),
                w2t, tp_group=mesh.model_group, combine_mode=combine)
            (y.to(torch.float32) ** 2).sum().backward()
        out.append(dict(y=np32(y), drop=float(met["drop_frac"]),
                        gx=np32(xs.grad), gwr=np32(wrt.grad),
                        gw13=np32(w13t.grad), gw2=np32(w2t.grad),
                        casts=led.activation_casts(), coll=comm.counts(),
                        tags=sorted(f"{k}:{t}" for (k, t) in led.by_tag())))
    return out


def train_many(mesh, jobs):
    """``train`` for each (args, kwargs) of `jobs` in one process."""
    return [train(mesh, *a, **kw) for a, kw in jobs]


# ---------------------------------------------------------------------------
# Training on a mesh.
# ---------------------------------------------------------------------------
def tree_np(tree):
    """A state tree's tensors as numpy bytes views (bit comparisons)."""
    from repro_torch.checkpoint.checkpointing import _flatten
    out = {}
    for p, leaf in _flatten(tree):
        if torch.is_tensor(leaf):
            t = leaf.detach().contiguous()
            out[p] = t.view({1: torch.uint8, 2: torch.int16,
                             4: torch.int32}[t.element_size()]).numpy().copy()
        else:
            out[p] = leaf
    return out


def train(mesh, arch, recipe_name, wire, n_steps, *, state_policy=None,
          seq_len=64, global_batch=8, lr=3e-3, ep_cf=None, guard=False,
          faults=(), ckpt_dir=None, ckpt_every=50, full_state=False,
          n_total=None, init_grads=False, min_fp8_size=2048, plan_kw=None,
          cfg_kw=None, dist_kw=None, remat=None, grad_accum=1,
          order_log=False):
    """`n_steps` steps of `arch` (reduced) on this rank's share of the
    global batches through loop.run: the DistPlan step for a `wire`, the
    plain step for None (f32 all-reduce; EP over the mesh's model axis).
    Returns the losses, the guard flags, the drop fractions and expert
    overflows the MoE blocks saw, the activation casts of the first step,
    the ledger's tags, and the params (gathered experts) as bytes, with
    `full_state` the gathered optimizer state as bytes, and with
    `init_grads` the plain step's reduced f32 gradients of the first
    global batch at the initial params (gathered experts), of the loss
    without the router's aux term (a mean of each rank's on a mesh).
    `plan_kw`: the ParallelPlan's levers (TP experts, FSDP, the TP MLP);
    `cfg_kw`: fields of the reduced config replaced; `dist_kw`: the
    DistPlan's (schedule, layered); `remat`: the config's remat policy;
    every cut leaf is gathered for the returned params and gradients.
    `order_log`: each step's launch order, 'a2a' for an all-to-all and
    'gemm' for a grouped-GEMM kernel wrapper call, and its all-to-all
    count."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.plan import DistPlan
    from repro_torch.launch.sharding import gather_leaf, shard_batch
    from repro_torch.models.lm import ParallelPlan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import fault_injection as fi
    from repro_torch.train import guards as G
    from repro_torch.train.loop import run
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = get_arch(arch).reduced()
    if ep_cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=ep_cf)
    if cfg_kw:
        cfg = dataclasses.replace(cfg, **cfg_kw)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    pplan = ParallelPlan(mesh=mesh, **(plan_kw or {}))
    recipe = recipe_of(recipe_name)
    if wire is None:
        opt = AdamWConfig(lr=lr, state_policy=state_policy)
        dist = None
    else:
        opt = AdamWConfig(lr=lr)
        dist = DistPlan(wire=wire, policy=state_policy,
                        min_fp8_size=min_fp8_size, **(dist_kw or {}))
    gplan = G.GuardPlan() if guard else None
    state = init_train_state(cfg, opt, seed=0, device="cpu", dist=dist,
                             mesh=mesh, guard=gplan, plan=pplan)
    step = make_train_step(cfg, recipe, opt, dist=dist, plan=pplan,
                           grad_accum=grad_accum,
                           total_steps=n_total or 400, warmup_steps=5,
                           guard=gplan)
    flags, gnorms, orders = [], [], []
    events, patched = [], []
    if order_log:
        from repro_torch.dist import comm
        from repro_torch.kernels import ops

        def logged(mod, name, what):
            fn = getattr(mod, name)

            def call(*a, **kw):
                if what != "a2a" or a[1] is not None:   # a launch
                    events.append(what)
                return fn(*a, **kw)
            patched.append((mod, name, fn))
            setattr(mod, name, call)
        logged(comm, "all_to_all", "a2a")
        for name in [n for n in vars(ops) if n.startswith("grouped_gemm")]:
            logged(ops, name, "gemm")

    def flagged(st, batch, _step=step):
        events.clear()
        st, m = _step(st, batch)
        orders.append(list(events))
        gnorms.append(float(m["grad_norm"]))
        if "guard_flags" in m:
            flags.append(int(m["guard_flags"]))
        return st, m
    flagged.guard = step.guard
    flagged.shardings = getattr(step, "shardings", None)
    step = flagged
    if faults:
        step = fi.FaultPlan(tuple(fi.Fault(k, s) for k, s in faults)
                            ).wrap(step)
    res = {}
    if init_grads:
        from repro_torch.data.pipeline import make_batch
        from repro_torch.train.train_step import _local_grads, reduce_grads
        batch = shard_batch(make_batch(DataConfig(
            vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch), 0,
            device="cpu"), mesh)
        from repro_torch.models import lm
        coef, lm.AUX_LOSS_COEF = lm.AUX_LOSS_COEF, 0.0
        _, _, g = _local_grads(cfg, recipe, state["params"], batch, 1, False,
                               pplan)
        lm.AUX_LOSS_COEF = coef
        g = reduce_grads(g, mesh, cfg, pplan) if mesh.has_groups else g
        res["grads"] = {k: np32(gather_leaf(v, mesh, pplan.leaf_cuts(
            cfg, f"layers.{k}"))) for k, v in g["layers"].items()}
    drops, overflow = [], []
    d0, e0 = moe._dispatch_plan, moe._expert_plan

    def dplan(ids, k, EP, E_loc, C):
        r = d0(ids, k, EP, E_loc, C)
        drops.append(float(r[3]))
        return r

    def eplan(recv, E_loc, C):
        r = e0(recv, E_loc, C)
        overflow.append(int((recv >= 0).sum() - (r[0] >= 0).sum()))
        return r

    moe._dispatch_plan, moe._expert_plan = dplan, eplan
    policy = G.GuardPolicy() if guard else None
    logs = []
    with casts.ledger() as led:
        state, hist = run(step, state, DataConfig(
            vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch),
            n_steps=n_steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
            log_fn=logs.append, guard_policy=policy, grad_accum=grad_accum,
            batch_fn=lambda b: shard_batch(b, mesh))
    moe._dispatch_plan, moe._expert_plan = d0, e0
    for mod, name, fn in patched:
        setattr(mod, name, fn)
    params = {}
    for k, v in state["params"].items():
        if isinstance(v, dict):
            params[k] = {n: gather_leaf(t.detach(), mesh, pplan.leaf_cuts(
                cfg, f"{k}.{n}")) for n, t in v.items()}
        else:
            params[k] = v
    res.update(losses=[h["loss"] for h in hist], drops=drops, flags=flags,
               gnorms=gnorms,
               overflow=overflow, params=tree_np(params),
               casts=led.activation_casts(),
               tags=sorted(f"{k}:{t}" for (k, t) in led.by_tag()),
               logs=logs, orders=orders)
    if full_state:
        z = getattr(step, "shardings", None)
        res["opt"] = tree_np(z.full(state)["opt"] if z is not None
                             else state["opt"])
    return res


# ---------------------------------------------------------------------------
# The DP wire's pieces.
# ---------------------------------------------------------------------------
def wire_rank(mesh, grads, wires):
    """reduce_scatter_bucket of this replica's bucket (grads[rank]) for
    each wire; compressed_psum of the same rows.  Returns the owned rows,
    the sum, and the collectives' calls and bytes."""
    from repro_torch.dist import comm, grad_comm
    from repro_torch.runtime.compression import compressed_psum
    g = torch.from_numpy(grads[mesh.rank])
    n = mesh.dp
    out = {}
    for wire in wires:
        comm.reset_counts()
        out[wire] = grad_comm.reduce_scatter_bucket(
            g.clone(), mesh.data_group, n, wire).numpy()
        out[f"coll_{wire}"] = comm.counts()
    out["psum"] = compressed_psum(g.clone(), mesh.data_group).numpy()
    return out


# ---------------------------------------------------------------------------
# Serving across ranks.
# ---------------------------------------------------------------------------
def serve_config(arch, cfg_kw=None):
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, **(cfg_kw or {}))


def serve_trace(vocab, seed, n=5, new=4):
    """`n` greedy requests, prompts of 3-20 tokens, `new` tokens each."""
    from repro_torch.serve.scheduler import Request
    r = np.random.default_rng(seed)
    return [Request(prompt=[int(t) for t in r.integers(1, vocab,
                                                       int(r.integers(3, 21)))],
                    max_new_tokens=new) for _ in range(n)]


SERVE_KW = dict(max_batch=4, page_size=8, n_pages=48, max_pages_per_req=4,
                token_budget=256, prefill_buckets=(16, 32), fp8_kv=True,
                w8_weights=True)


def serve(mesh, jobs):
    """Each job (a dict) served on this rank, returning per job the
    tokens by request, the logits each tick sampled from (the prefill's
    last row, the decode step's live rows), the collectives by kind, the
    engine's stats, or the error a job raised.  Job keys: arch, cfg_kw,
    seed, plan_kw (None: no plan; else a ParallelPlan on `mesh`),
    kind ('engine', 'fleet': a 1 + 1 DisaggRouter, 'serve_step': the
    fixed-batch path), skew_rank (that rank's sampled tokens are moved by
    one), n, new, params_np (the reference's numpy tree, else the port's
    init_params(seed 0)), ecfg_kw (ServeConfig fields over SERVE_KW),
    spacing (the requests arrive that many seconds apart and the engine
    runs in real time)."""
    from repro_torch.weights import params_from_numpy
    from repro_torch.dist import comm
    from repro_torch.models.lm import ParallelPlan, init_params
    from repro_torch.serve import engine as E
    out = []
    for job in jobs:
        cfg = serve_config(job["arch"], job.get("cfg_kw"))
        recipe = recipe_of(job.get("recipe", "fp8_flow"))
        pkw = job.get("plan_kw")
        plan = None if pkw is None else ParallelPlan(mesh=mesh, **pkw)
        params = params_from_numpy(job["params_np"], device="cpu") \
            if "params_np" in job else init_params(cfg, seed=0, device="cpu")
        reqs = serve_trace(cfg.vocab, job["seed"], job.get("n", 5),
                           job.get("new", 4))
        spacing = job.get("spacing")
        for i, q in enumerate(reqs):
            q.arrival_time = i * (spacing or 0.0)
        logits = []
        decode0, prefill0, sample0 = (E.paged_decode_step, E.paged_prefill,
                                      E.sample_tokens)

        def dec(*a, **kw):
            lg = decode0(*a, **kw)
            live = a[7] if len(a) > 7 else kw["active"]
            logits.append(np32(lg[live.bool(), -1]))
            return lg

        def pre(*a, **kw):
            lg = prefill0(*a, **kw)
            logits.append(np32(lg[:, -1]))
            return lg

        def skewed(lg, temps, top_k, generator=None):
            t = sample0(lg, temps, top_k, generator)
            return (t + 1) % cfg.vocab if mesh.rank == job["skew_rank"] \
                else t
        E.paged_decode_step, E.paged_prefill = dec, pre
        if job.get("skew_rank") is not None:
            E.sample_tokens = skewed
        comm.reset_counts()
        res = dict(error=None)
        try:
            if job.get("kind", "engine") == "serve_step":
                res["tokens"] = _serve_step_tokens(cfg, recipe, params,
                                                   plan, reqs)
            else:
                runner = _runner(cfg, recipe, params, plan,
                                 job.get("kind", "engine"),
                                 job.get("ecfg_kw"))
                results = runner.run(reqs, realtime=spacing is not None)
                res["tokens"] = [results[q.rid]["tokens"] for q in reqs]
                res["stats"] = {k: v for k, v in results.stats.items()
                                if not isinstance(v, (list, dict))}
        except RuntimeError as e:
            res["error"] = str(e)
        finally:
            E.paged_decode_step, E.paged_prefill, E.sample_tokens = (
                decode0, prefill0, sample0)
        res.update(logits=logits, coll=comm.counts())
        out.append(res)
    return out


def _runner(cfg, recipe, params, plan, kind, ecfg_kw=None):
    import dataclasses
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    ecfg = ServeConfig(**dict(SERVE_KW, **(ecfg_kw or {})))
    if kind == "engine":
        return ServeEngine(cfg, recipe, params, ecfg, device="cpu",
                           plan=plan)
    from repro_torch.serve.router import DisaggRouter
    pe = ServeEngine(cfg, recipe, params,
                     dataclasses.replace(ecfg, role="prefill"),
                     device="cpu", plan=plan)
    de = ServeEngine(cfg, recipe, params,
                     dataclasses.replace(ecfg, role="decode"),
                     device="cpu", plan=plan)
    return DisaggRouter([pe], [de])


def _serve_step_tokens(cfg, recipe, params, plan, reqs):
    """The fixed-batch path on the trace's prompts cut to their shortest
    length: every prompt fed token by token through ``make_serve_step``
    (W8 experts of the serving cut), then the new tokens greedily."""
    from repro_torch.launch.sharding import serving_cut
    from repro_torch.models.lm import init_cache
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.serve.w8 import quantize_params_for_serving
    if plan is not None:
        params = serving_cut(params, cfg, plan)
    params = quantize_params_for_serving(params)
    P = min(len(q.prompt) for q in reqs)
    new = reqs[0].max_new_tokens
    B = len(reqs)
    cache = init_cache(cfg, B, P + new, device="cpu")
    step = make_serve_step(cfg, recipe, plan=plan)
    prompts = torch.tensor([q.prompt[:P] for q in reqs])
    gen = []
    with torch.inference_mode():
        tok = prompts[:, :1]
        for t in range(P + new - 1):
            nxt, cache = step(params, cache, tok, t)
            tok = prompts[:, t + 1:t + 2] if t + 1 < P else nxt
            if t + 1 >= P:
                gen.append(nxt[:, 0].tolist())
    return [list(col) for col in zip(*gen)]


def moe_stage_decode(mesh, d_ff, arrays, cases):
    """Each case ('mode|weights') of the port's decode MoE stage of
    reduced grok1_314b (d_ff_expert `d_ff`) on this rank: the stacked
    world-1 leaves cut by ``serving_cut`` and, for 'w8', quantized after
    the cut (and, as a check, quantized first and then cut: the same
    bits); the output on x_decode (B, 1, D) under the serving plan."""
    from repro_torch.core.recipes import get_recipe
    from repro_torch.launch.sharding import serving_cut
    from repro_torch.models import lm
    from repro_torch.serve.w8 import quantize_params_for_serving
    cfg = serve_config("grok1_314b", dict(d_ff_expert=d_ff))
    x, wr, w13, w2 = arrays
    xs = torch.tensor(x).to(torch.bfloat16)[:, None]
    whole = {"layers": {"w_router": torch.tensor(wr)[None],
                        "we13": torch.tensor(w13).to(torch.bfloat16)[None],
                        "we2": torch.tensor(w2).to(torch.bfloat16)[None]}}
    out = []
    for case in cases:
        mode, weights = case.split("|")
        plan = lm.ParallelPlan(mesh=mesh, moe_mode=mode).for_serving()
        params = serving_cut(whole, cfg, plan)
        same = True
        if weights == "w8":
            params = quantize_params_for_serving(params)
            first = serving_cut(quantize_params_for_serving(whole), cfg,
                                plan)
            for k in ("we13", "we2"):
                a, b = params["layers"][k], first["layers"][k]
                same &= (torch.equal(a.data.view(torch.uint8),
                                     b.data.view(torch.uint8))
                         and torch.equal(a.scale, b.scale))
        p = lm.layer_slice(params["layers"], 0)
        with torch.inference_mode():
            y, _ = lm._moe_stage(cfg, get_recipe("fp8_flow"), p, xs,
                                 decode=True, plan=plan)
        out.append(dict(y=np32(y[:, 0]), cut_then_quantize=bool(same),
                        shapes={k: tuple(p[k].shape) for k in ("we13",
                                                                "we2")}))
    return out


def launch_train(mesh, argv):
    """``launch.train.main(argv)`` on this rank of an already joined
    world (its WORLD_SIZE set as torchrun would): the losses."""
    import os
    from repro_torch.launch.train import main
    os.environ["WORLD_SIZE"] = str(mesh.world)
    return main(list(argv))
