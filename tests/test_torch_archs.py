"""The port's dense layers and shared experts served against the JAX
reference on the CPU, for the three configurations that have them:
qwen15_05b (every layer dense, QKV bias, tied embedding), deepseek_v2_lite
and deepseek_v3_671b (a dense prologue, then MoE layers with shared
experts), each at reduced() size with the reference's init_params(key(0))
carried across bit for bit.

The reference runs as tests/test_torch_serve.py runs it: route A is the
engine's own path (1x1 mesh, W8 expert weights, XLA ops), route B the
local one (no mesh, bf16 weights, the Pallas kernels in interpret mode).
The two differ in decode: route A runs the decode MoE block and the
shared experts' bf16 ``_mlp_decode``, route B the prefill MoE block and
the shared experts' FP8 ``dense_mlp``.  The port serves like route A.
Bar, as there: cosine >= 0.999 and the same argmax at every
teacher-forced step against both routes, on a token seed with no router
near-tie (``NEAR_TIE``); the prefill cast ledger equals route A's."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.recipes import get_recipe as jget_recipe
from repro.models.lm import NO_PLAN, ParallelPlan
from repro.models.lm import init_params as jinit_params
from repro.serve.w8 import quantize_params_for_serving as jquantize_w8
from repro_torch.configs import get_arch
from repro_torch.core.quant import QTensor
from repro_torch.models.lm import init_params
from repro_torch.serve.w8 import quantize_params_for_serving
from repro_torch.weights import params_from_numpy
from test_torch_serve import (NEAR_TIE, PROMPT, STEPS, _cos, _np_tree,
                              _port_teacher_forced, _ref_teacher_forced)
from tests.conftest import make_mesh11

ARCHS = ["qwen15_05b", "deepseek_v2_lite", "deepseek_v3_671b"]


def _named(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """Route A, route B and the port on token seed 2 (no router near-tie
    at any step of the two DeepSeek configs; qwen15_05b has no router)."""
    jcfg = jget_arch(request.param).reduced()
    cfg = get_arch(request.param).reduced()
    jparams = jinit_params(jcfg, jax.random.key(0))
    jw8 = jquantize_w8(jparams)
    params = params_from_numpy(_np_tree(jparams), device="cpu")
    toks = [int(t) for t in np.random.default_rng(2).integers(
        1, cfg.vocab, PROMPT + STEPS)]
    mesh = make_mesh11()
    return dict(
        cfg=cfg, jcfg=jcfg, jparams=jparams, jw8=jw8, params=params,
        A=_ref_teacher_forced(jcfg, jget_recipe("fp8_flow"),
                              ParallelPlan(mesh=mesh, dp_axes=("data",)),
                              jw8, mesh, toks),
        B=_ref_teacher_forced(jcfg, jget_recipe("fp8_flow", use_pallas=True),
                              NO_PLAN, jparams, contextlib.nullcontext(),
                              toks),
        port=_port_teacher_forced(cfg, quantize_params_for_serving(params),
                                  toks))


def test_init_params_tree_matches_reference(served):
    """The port's own init_params builds the reference's tree: the same
    leaf paths (dense_layers, ws13/ws2, bq/bk/bv, no lm_head when the
    embedding is tied), shapes and dtypes."""
    ref = {p: (tuple(a.shape), np.dtype(a.dtype).name)
           for p, a in _named(_np_tree(served["jparams"])).items()}
    mine = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in _named(init_params(served["cfg"], seed=0,
                                           device="cpu")).items()}
    assert mine == ref
    cfg = served["cfg"]
    assert ("dense_layers/w13" in mine) == (cfg.moe and cfg.n_dense_layers > 0)
    assert ("layers/ws13" in mine) == (cfg.n_shared_experts > 0)
    assert ("lm_head" in mine) == (not cfg.tie_embeddings)


def _bits(t):
    """A tensor's bits as an integer tensor of its width."""
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _fields(t):
    """(tensors, tile) of a plain leaf or a QTensor (the port's, or the
    reference's holding numpy arrays)."""
    if not isinstance(t, (torch.Tensor, np.ndarray)):
        return (t.data, t.scale), tuple(t.tile)
    return (t,), None


def test_params_and_w8_trees_carry_across_bitwise(served):
    """params_from_numpy keeps every bit of the reference's init_params
    tree and of its quantize_params_for_serving tree, and the port's own
    W8 quantize of the carried params is the reference's.  Only the routed
    experts turn W8; the dense and shared MLPs stay bf16."""
    for tree in (served["jparams"], served["jw8"]):
        ref = _named(_np_tree(tree))
        got = _named(params_from_numpy(_np_tree(tree), device="cpu"))
        assert got.keys() == ref.keys()
        for path, t in got.items():
            (ts, tile), (rs, rtile) = _fields(t), _fields(ref[path])
            assert tile == rtile, path
            for a, b in zip(ts, rs):
                a = _bits(a).numpy()
                assert np.array_equal(
                    a, np.ascontiguousarray(b).view(a.dtype)), path
    mine = _named(quantize_params_for_serving(served["params"]))
    ref = _named(params_from_numpy(_np_tree(served["jw8"]), device="cpu"))
    assert mine.keys() == ref.keys()
    w8 = sorted(p for p, t in mine.items() if isinstance(t, QTensor))
    assert w8 == sorted(p for p, t in ref.items() if isinstance(t, QTensor))
    assert w8 == (["layers/we13", "layers/we2"] if served["cfg"].moe else [])
    for path, t in mine.items():
        (ts, tile), (rs, rtile) = _fields(t), _fields(ref[path])
        assert tile == rtile, path
        for a, b in zip(ts, rs):
            assert torch.equal(_bits(a), _bits(b)), path


@pytest.mark.parametrize("route", ["A", "B"])
def test_teacher_forced_logits_match_reference(served, route):
    ref, _ = served[route]
    port, _, gaps = served["port"]
    assert min(gaps) >= NEAR_TIE, gaps
    for step, (a, b) in enumerate(zip(port, ref)):
        assert np.isfinite(a).all()
        assert _cos(a, b) >= 0.999, (route, step, _cos(a, b))
        assert int(a.argmax()) == int(b.argmax()), (route, step)


def test_prefill_cast_ledger_matches_reference(served):
    """The same (kind, tag) events as route A's prefill, less the XLA
    route's unfused inner SwiGLU quantize.  The reference scans each stack
    and its trace-time ledger sees one layer a stack; the port records
    every layer.  The reduced DeepSeek stacks hold one layer each;
    qwen15_05b's one stack holds two."""
    _, ref = served["A"]
    _, port, _ = served["port"]
    cfg = served["cfg"]
    nd = cfg.n_dense_layers if cfg.moe else 0
    assert nd == 0 or (nd == 1 and cfg.n_layers == 2)
    per_stack = cfg.n_layers if nd == 0 else 1
    ref = {k: v * per_stack for k, v in ref.items()
           if not k[0].endswith("_inner")}
    assert port == ref
    # one entry quantize an FP8 MLP (a dense layer's, a shared expert's, a
    # routed block's dispatch); the bf16 dense and shared weights are
    # quantized at every prefill (W8 covers only the routed experts)
    n_moe = cfg.n_layers - nd if cfg.moe else 0
    n_dense = nd + n_moe if cfg.n_shared_experts else cfg.n_layers - n_moe
    assert port[("quantize", "q_entry")] == n_dense + n_moe
    assert port[("quantize", "q_w13")] == port[("quantize", "q_w2")] \
        == n_dense
