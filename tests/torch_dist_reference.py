"""The reference's multi-device functions, run for the port's multi-rank
tests in a process of its own (``torch_dist_harness.run_reference``):

  python tests/torch_dist_reference.py TASK IN.npz OUT.npz

with XLA_FLAGS forcing the host devices.  Tasks:

  ep_blocks        the EP MoE blocks (moe_block, moe_block_overlapped,
                   moe_block_decode, moe_block_decode_overlapped) in a
                   jitted check_vma=False shard_map over a (1, EP) mesh,
                   as tests/test_torch_overlap.py runs them: the output,
                   the drop fraction and the gradients of sum(y**2) by x,
                   w_router, w13 and w2 (train blocks), each case named in
                   the input's `cases`
  tp_blocks        moe_block_tp in a jitted check_vma=False shard_map over
                   a (1, TP) mesh: x and the router replicated, w13
                   (E, D, 2, F) and w2 (E, F, D) F-sliced over 'model';
                   the output (replicated, or row-sliced under
                   reduce_scatter) and the gradients of sum(y**2), each
                   case 'recipe|tp|combine'
  moe_stage_decode the reference's decode MoE stage (``models.lm._moe_stage``,
                   decode=True) of reduced grok1_314b (d_ff_expert from the
                   input) on a (1, n) mesh, each case 'mode|weights|n':
                   mode 'tp' or 'ep', weights 'bf16' (the layer's leaves as
                   they are) or 'w8' (the reference's
                   quantize_params_for_serving of the stacked leaves); the
                   output on x_decode (B, 1, D)
  engine           the reference's ServeEngine (reduced qwen3_moe_235b, W8
                   experts, FP8 pages, the EP plan) on a (1, n) mesh over
                   the input's prompts: each request's tokens, and its
                   init_params(key(0)) tree as numpy leaves ('p:<path>:<dtype
                   name>', low-precision leaves as unsigned-int views)
  mesh_layout      jax.make_mesh's device order of the (pod, data, model)
                   and (data, model) meshes in the input's `shapes`
  reduce_scatter   grad_comm.reduce_scatter_bucket over a (n, 1) mesh, one
                   (n, rows, TILE) input a case
  compressed_psum  runtime.compression.compressed_psum over n devices
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.core import moe as jmoe
from repro.core.recipes import get_recipe


def _recipe(name):
    if name == "masked":
        return get_recipe("fp8_flow", masked_experts=True,
                          swiglu_epilogue=True)
    return get_recipe(name)


def ep_blocks(inp):
    x = jnp.asarray(inp["x"]).astype(jnp.bfloat16)
    xd = jnp.asarray(inp["x_decode"]).astype(jnp.bfloat16)
    wr, w13, w2 = (jnp.asarray(inp[k]) for k in ("wr", "w13", "w2"))
    E, topk = int(inp["spec"][0]), int(inp["spec"][1])
    cf = float(inp["spec"][2])
    D, F = x.shape[1], w2.shape[1]
    out = {}
    for i, case in enumerate(str(c) for c in inp["cases"]):
        recipe_name, ep, kind, n = case.split("|")
        ep, n = int(ep), int(n)
        recipe = _recipe(recipe_name)
        mesh = _mesh(ep)
        cfg = jmoe.MoEConfig(n_experts=E, top_k=topk, d_model=D, d_ff=F,
                             capacity_factor=cf)
        decode = kind.startswith("decode")

        def body(xl, wrl, w13l, w2l, _kind=kind, _n=n, _r=recipe):
            if _kind == "mono":
                y, m = jmoe.moe_block(_r, cfg, xl, wrl, w13l, w2l)
            elif _kind == "overlap":
                y, m = jmoe.moe_block_overlapped(_r, cfg, xl, wrl, w13l, w2l,
                                                 n_chunks=_n)
            elif _kind == "decode":
                y, m = jmoe.moe_block_decode(_r, cfg, xl, wrl, w13l, w2l)
            else:
                y, m = jmoe.moe_block_decode_overlapped(
                    _r, cfg, xl, wrl, w13l, w2l, n_chunks=_n)
            return y, m["drop_frac"][None]

        tok = P(None, None) if decode else P(("data", "model"), None)
        f = shard_map(body, mesh=mesh,
                      in_specs=(tok, P(None, None), P("model", None, None),
                                P("model", None, None)),
                      out_specs=(tok, P("model")), check_vma=False)
        if decode:
            y, drop = jax.jit(f)(xd, wr, w13, w2)
            out[f"y_{i}"] = np.asarray(y, np.float32)
            out[f"drop_{i}"] = np.asarray(drop, np.float32)
            continue

        def loss(*a, _f=f):
            y, drop = _f(*a)
            return jnp.sum(y.astype(jnp.float32) ** 2), (y, drop)

        (_, (y, drop)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True))(x, wr, w13, w2)
        out[f"y_{i}"] = np.asarray(y, np.float32)
        out[f"drop_{i}"] = np.asarray(drop, np.float32)
        for name, g in zip(("x", "wr", "w13", "w2"), grads):
            out[f"g{name}_{i}"] = np.asarray(g, np.float32)
    return out


def tp_blocks(inp):
    x = jnp.asarray(inp["x"]).astype(jnp.bfloat16)
    wr, w13, w2 = (jnp.asarray(inp[k]) for k in ("wr", "w13", "w2"))
    E, topk = int(inp["spec"][0]), int(inp["spec"][1])
    cf = float(inp["spec"][2])
    D, F = x.shape[1], w2.shape[1]
    out = {}
    for i, case in enumerate(str(c) for c in inp["cases"]):
        recipe_name, tp, combine = case.split("|")
        tp = int(tp)
        recipe = _recipe(recipe_name)
        mesh = _mesh(tp)
        cfg = jmoe.MoEConfig(n_experts=E, top_k=topk, d_model=D, d_ff=F,
                             capacity_factor=cf)

        def body(xl, wrl, w13l, w2l, _r=recipe, _c=combine):
            El, Dl, gl, Fl = w13l.shape
            y, m = jmoe.moe_block_tp(_r, cfg, xl, wrl,
                                     w13l.reshape(El, Dl, gl * Fl), w2l,
                                     tp_axis="model", combine_mode=_c)
            return y, m["drop_frac"][None]

        yspec = P("model", None) if combine == "reduce_scatter" \
            else P(None, None)
        f = shard_map(body, mesh=mesh,
                      in_specs=(P(None, None), P(None, None),
                                P(None, None, None, "model"),
                                P(None, "model", None)),
                      out_specs=(yspec, P("model")), check_vma=False)

        def loss(*a, _f=f):
            y, drop = _f(*a)
            return jnp.sum(y.astype(jnp.float32) ** 2), (y, drop)

        (_, (y, drop)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True))(x, wr, w13, w2)
        out[f"y_{i}"] = np.asarray(y, np.float32)
        out[f"drop_{i}"] = np.asarray(drop, np.float32)
        for name, g in zip(("x", "wr", "w13", "w2"), grads):
            out[f"g{name}_{i}"] = np.asarray(g, np.float32)
    return out


def moe_stage_decode(inp):
    import dataclasses
    from repro.configs import get_arch
    from repro.models import lm
    from repro.serve.w8 import quantize_params_for_serving
    cfg = dataclasses.replace(get_arch("grok1_314b").reduced(),
                              d_ff_expert=int(inp["d_ff"]))
    recipe = get_recipe("fp8_flow")
    x = jnp.asarray(inp["x_decode"]).astype(jnp.bfloat16)[:, None]
    leaves = {"w_router": jnp.asarray(inp["wr"]),
              "we13": jnp.asarray(inp["w13"]).astype(jnp.bfloat16),
              "we2": jnp.asarray(inp["w2"]).astype(jnp.bfloat16)}
    w8 = quantize_params_for_serving(
        {"layers": {k: v[None] for k, v in leaves.items()}})["layers"]
    w8 = jax.tree.map(lambda t: t[0], w8)
    out = {}
    for i, case in enumerate(str(c) for c in inp["cases"]):
        mode, weights, n = case.split("|")
        mesh = _mesh(int(n))
        plan = lm.ParallelPlan(mesh=mesh, dp_axes=("data",), moe_mode=mode)
        p = w8 if weights == "w8" else leaves
        with mesh:
            y, _ = jax.jit(lambda p, x, _plan=plan: lm._moe_stage(
                cfg, recipe, _plan, p, x, decode=True))(p, x)
        out[f"y_{i}"] = np.asarray(y[:, 0], np.float32)
    return out


def engine(inp):
    from repro.configs import get_arch
    from repro.launch.mesh import make_test_mesh
    from repro.models.lm import ParallelPlan, init_params
    from repro.serve.engine import ServeConfig, ServeEngine
    from repro.serve.scheduler import Request
    cfg = get_arch("qwen3_moe_235b").reduced()
    plan = ParallelPlan(mesh=make_test_mesh((1, int(inp["n"]))),
                        dp_axes=("data",))
    params = init_params(cfg, jax.random.key(0))
    kw = {k: int(v) for k, v in zip(("max_batch", "page_size", "n_pages",
                                     "max_pages_per_req", "token_budget",
                                     "bucket"), inp["ecfg"])}
    bucket = kw.pop("bucket")
    eng = ServeEngine(cfg, get_recipe("fp8_flow"), plan, params, ServeConfig(
        **kw, prefill_buckets=(bucket,), fp8_kv=True, w8_weights=True))
    reqs = [Request(prompt=[int(t) for t in row[:n]],
                    max_new_tokens=int(inp["new"]))
            for row, n in zip(inp["prompts"], inp["lens"])]
    res = eng.run(reqs, realtime=False)
    out = {"tokens": np.asarray([res[q.rid]["tokens"] for q in reqs])}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        a = np.asarray(leaf)
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        view = {1: np.uint8, 2: np.uint16}.get(a.dtype.itemsize) \
            if a.dtype.kind == "V" or a.dtype.itemsize < 4 else None
        out[f"p:{name}:{a.dtype.name}"] = a.view(view) if view else a
    return out


def mesh_layout(inp):
    from repro.compat import make_mesh
    out = {}
    for i, shape in enumerate(inp["shapes"]):
        shape = tuple(int(n) for n in shape if n)
        names = ("pod", "data", "model")[-len(shape):]
        m = make_mesh(shape, names)
        out[f"ids_{i}"] = np.vectorize(lambda d: d.id)(m.devices)
    return out


def _mesh(n, axes=("data", "model"), data=False):
    """The first n host devices as a (1, n) mesh, or (n, 1) for `data`."""
    from jax.sharding import Mesh
    devs = np.asarray(jax.devices()[:n])
    shape = (n, 1) if data else (1, n)
    return Mesh(devs.reshape(shape), axes)


def reduce_scatter(inp):
    from repro.dist import grad_comm
    out = {}
    for key in list(inp):
        if not key.startswith("g_"):
            continue
        _, wire, n = key.split("_")
        n = int(n)
        g = jnp.asarray(inp[key])
        mesh = _mesh(n, data=True)

        def red(gl, _wire=wire, _n=n):
            return grad_comm.reduce_scatter_bucket(gl[0], "data", _n, _wire)

        f = shard_map(red, mesh=mesh, in_specs=P("data", None, None),
                      out_specs=P("data", None), check_vma=False)
        out[f"rs_{wire}_{n}"] = np.asarray(jax.jit(f)(g))
    return out


def compressed_psum(inp):
    from repro.runtime.compression import compressed_psum as cps
    out = {}
    for key in list(inp):
        if not key.startswith("x_"):
            continue
        n = int(key.split("_")[1])
        x = jnp.asarray(inp[key])
        mesh = _mesh(n, data=True)

        def body(xl):
            return cps(xl[0], "data")[None]

        f = shard_map(body, mesh=mesh, in_specs=P("data", None, None),
                      out_specs=P("data", None, None), check_vma=False)
        out[f"psum_{n}"] = np.asarray(jax.jit(f)(x))
    return out


TASKS = {"ep_blocks": ep_blocks, "tp_blocks": tp_blocks,
         "moe_stage_decode": moe_stage_decode, "mesh_layout": mesh_layout,
         "engine": engine,
         "reduce_scatter": reduce_scatter,
         "compressed_psum": compressed_psum}


def main():
    task, src, dst = sys.argv[1:4]
    with np.load(src) as f:
        inp = {k: f[k] for k in f.files}
    np.savez(dst, **TASKS[task](inp))


if __name__ == "__main__":
    main()
