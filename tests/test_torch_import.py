"""repro_torch stands alone: every module (the multi-GPU ones too: the
mesh with its pod axis, the sharding, make_plan and the serving cut, the
engine and launcher across ranks, the collectives and the TP / FSDP
autograd collectives, the DP wire with its streaming schedule and its
layered plan, the FP8 psum, the TP expert block), the chip scripts and the port's examples import without jax or
the JAX package, weights cross
over with their bits, and asking for CUDA without a card raises instead
of falling back."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.recipes import get_recipe
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.weights import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
configs = {f"repro_torch.configs.{a}" for a in (
    "qwen3_moe_235b", "qwen15_05b", "deepseek_v2_lite", "deepseek_v3_671b",
    "starcoder2_15b", "gemma3_4b", "gemma2_9b", "grok1_314b",
    "llava_next_34b", "seamless_m4t_v2", "mamba2_27b", "hymba_15b")}
configs |= {"repro_torch.models.ssm", "repro_torch.serve.serve_step"}
configs |= {f"repro_torch.{m}" for m in (
    "dist.opt_state", "kernels.adamw_update", "train.guards", "train.loop",
    "runtime.fault_injection", "runtime.fault_tolerance",
    "checkpoint.checkpointing", "obs.metrics", "obs.sink",
    "dist.scale_sync", "serve.prefix_cache", "serve.transfer",
    "serve.router", "obs.report", "obs.trace", "roofline.analysis",
    "launch.mesh", "launch.sharding", "dist.comm", "dist.plan",
    "dist.grad_comm", "runtime.compression", "dist.tp", "core.moe",
    "core.linear", "models.lm", "train.train_step", "launch.train",
    "launch.serve", "serve.engine", "serve.w8")}
assert configs <= set(names), sorted(configs - set(names))
import chip_depths, chip_profile, chip_smoke
sys.path.insert(0, "examples")
import quickstart_torch, serve_moe_torch, train_moe_torch
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def test_params_from_numpy_keeps_bf16_and_e4m3_bits():
    r = np.random.default_rng(0)
    bf = r.normal(size=(4, 8)).astype(ml_dtypes.bfloat16)
    f8 = r.integers(0, 256, size=(4, 128), dtype=np.uint8)
    f8[0, :4] = [0x7F, 0xFF, 0x80, 0x7E]               # NaNs, -0, 448
    f8 = f8.view(ml_dtypes.float8_e4m3fn)

    class Q:                                           # a reference QTensor
        data, scale, tile = f8, np.ones((4, 1), np.float32), (1, 128)

    out = params_from_numpy({"w": bf, "layers": {"we2": Q()}}, device="cpu")
    assert out["w"].dtype == torch.bfloat16
    assert np.array_equal(out["w"].view(torch.uint16).numpy(),
                          bf.view(np.uint16))
    q = out["layers"]["we2"]
    assert q.data.dtype == torch.float8_e4m3fn and q.tile == (1, 128)
    assert np.array_equal(q.data.view(torch.uint8).numpy(), f8.view(np.uint8))


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("qwen3_moe_235b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, get_recipe("fp8_flow"), {}, ServeConfig())
    with pytest.raises(NotImplementedError):
        ServeEngine(cfg, get_recipe("naive_fp8"), {}, ServeConfig())
    for role in ("prefill", "decode"):        # the cache and the tiers too
        with pytest.raises(RuntimeError, match="cuda"):
            ServeEngine(cfg, get_recipe("fp8_flow"), {},
                        ServeConfig(prefix_cache=True, role=role))
