"""Training launcher: the train step of any recipe on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_v2_lite \\
      --reduced --device cuda [--recipe {bf16,blockwise,naive_fp8,fp8_flow}] \\
      [--steps 20] [--seq-len 256] [--global-batch 8]

The flags are the reference launcher's (``repro.launch.train``) that the
single-device port runs, plus ``--device`` (``cuda``: the hand-written
kernels; ``cpu``: their plain twins).  Checkpointing, the DP wire,
guardrails, rematerialization policies, gradient accumulation and
telemetry are not ported yet (ROADMAP.md, Queue 1, items 6-9).
``--arch`` takes every config (``repro_torch.configs.ARCH_IDS``); the
default is the paper's convergence model, deepseek_v2_lite, as in the
reference.  The batches are make_batch's tokens, as the reference
launcher's: llava_next_34b trains without its vision prefix, and
seamless_m4t_v2 (an encoder-decoder, whose batch needs an encoder input)
raises, where the reference raises KeyError.  Without ``--reduced`` the
full config is built: of these, one card trains only qwen15_05b and
hymba_15b at full depth (AdamW holds 16 bytes a parameter).  At full
width and a cut depth one 80 GB card trains deepseek_v2_lite (4 layers),
starcoder2_15b (4), gemma3_4b (12: two whole local:global groups),
gemma2_9b (8), mamba2_27b, seamless_m4t_v2 and llava_next_34b at the
depths ``chip_smoke.py`` records (PERF.md section 4); one layer of
qwen3_moe_235b; no layer of deepseek_v3_671b or grok1_314b (one grok
layer's state is 79 GB: it waits for the FP8-split optimizer state or
multi-GPU, ROADMAP.md Queue 1).
"""
import argparse
import time

from repro_torch.configs import get_arch
from repro_torch.core.recipes import RECIPES, get_recipe
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek_v2_lite")
    ap.add_argument("--recipe", default="fp8_flow", choices=RECIPES)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain twins)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
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
    state = init_train_state(cfg, opt, seed=0, device=args.device)
    step_fn = make_train_step(cfg, recipe, opt, total_steps=args.steps,
                              warmup_steps=max(args.steps // 10, 1))
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    print(f"[train] {args.arch} ({cfg.n_params() / 1e9:.2f}B params) "
          f"recipe={recipe.name} device={args.device}")
    losses = []
    for step in range(args.steps):
        batch = make_batch(data, step, device=args.device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])        # one host sync a step
        dt = time.perf_counter() - t0
        losses.append(loss)
        print(f"[train] step {step} loss {loss:.4f} grad_norm "
              f"{float(metrics['grad_norm']):.4f} {dt * 1e3:.0f} ms")
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
