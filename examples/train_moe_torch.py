"""End-to-end driver on the PyTorch port: train a ~100M-parameter MoE
(DeepSeek-V2-Lite family, reduced) with the FP8-Flow recipe --
checkpointing, restart, LR schedule, metrics included.

The port of ``examples/train_moe.py``: one device and no mesh; the steps
run through ``repro_torch.train.loop.run``.

Run:  PYTHONPATH=src python examples/train_moe_torch.py [--steps 300] \\
          [--recipe fp8_flow] [--device cuda|cpu] [--ckpt-dir DIR]
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_arch
from repro_torch.core.recipes import RECIPES, get_recipe
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import run as run_loop
from repro_torch.train.train_step import init_train_state, make_train_step


def model_config(small: bool = False):
    """~100M-param MoE: v2-lite family, widened reduced config (`small`:
    the reduced config itself, for a quick run)."""
    cfg = get_arch("deepseek_v2_lite").reduced()
    if small:
        return cfg
    return dataclasses.replace(
        cfg, n_layers=6, d_model=768, n_heads=12, head_dim=64, d_ff=2048,
        n_experts=16, top_k=2, d_ff_expert=768, n_shared_experts=1,
        n_dense_layers=1, vocab=16384)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--recipe", default="fp8_flow", choices=RECIPES)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_moe_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain twins)")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--small", action="store_true",
                    help="the reduced config, for a quick run")
    args = ap.parse_args(argv)

    cfg = model_config(args.small)
    print(f"model: {cfg.n_params()/1e6:.1f}M params "
          f"({cfg.active_params()/1e6:.1f}M active), recipe={args.recipe}")
    opt = AdamWConfig(lr=1e-3)
    recipe = get_recipe(args.recipe)
    step = make_train_step(cfg, recipe, opt, total_steps=args.steps,
                           warmup_steps=20)
    state = init_train_state(cfg, opt, seed=0, device=args.device)
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    state, hist = run_loop(step, state, data, n_steps=args.steps,
                           ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                           log_every=20)
    print(f"final loss: {hist[-1]['loss']:.4f} "
          f"(start {hist[0]['loss']:.4f})")
    return hist


if __name__ == "__main__":
    main()
