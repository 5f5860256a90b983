"""The fixed-batch serving step: one decode token against a resident dense
KV / SSM cache, and the prefill forward.

Counterpart of ``repro.serve.serve_step``.  This is the serve entry of
the architectures the paged engine refuses, in both packages: the SSM
(mamba2_27b), hybrid (hymba_15b), encoder-decoder (seamless_m4t_v2) and
vision-frontend (llava_next_34b) stacks; it serves the attention-only
decoders too.  Sampling routes through ``engine.sample_tokens`` (greedy
where temp <= 0, else temperature and optional top-k), and ``pos`` is a
scalar (every request at one position) or a (B,) tensor.  The prefill
fills no cache, as the reference's does not: a prompt is fed through the
serve step token by token.

``plan=`` (a ``models.lm.ParallelPlan``, the reference's argument at
``repro/serve/serve_step.py:18`` and ``:46``, a keyword here) runs the
step in the serving layout on its mesh: every rank holds the whole batch
and cache and its serving cut of the weights
(``launch.sharding.serving_cut``), the MoE stages cut the rows as the
reference does, and every rank gets the same tokens.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.recipes import Recipe
from repro_torch.models.lm import decode_step, forward
from repro_torch.serve.engine import sample_tokens


def make_serve_step(cfg: ArchConfig, recipe: Recipe, top_k: int = 0, *,
                    plan=None):
    """Returns serve_step(params, cache, tokens, pos[, temps, generator]).

    tokens (B, 1) int; pos a scalar or (B,) positions; temps optional (B,)
    f32 sampling temperatures (None or <= 0: greedy); generator a
    torch.Generator for the sampled rows.  Returns (next tokens (B, 1),
    the cache, updated in place by ``decode_step``)."""

    def serve_step(params, cache, tokens, pos, temps=None, generator=None):
        if temps is not None and generator is None:
            # a fixed default generator would make every step's draw
            # perfectly correlated: degenerate "temperature" sampling
            raise ValueError("stochastic sampling (temps) needs a "
                             "torch.Generator threaded through the loop")
        logits, cache = decode_step(cfg, recipe, params, cache, tokens, pos,
                                    plan=plan)
        if temps is None:
            temps = torch.zeros((tokens.shape[0],), dtype=torch.float32,
                                device=logits.device)
        next_tok = sample_tokens(logits[:, -1, :], temps, top_k, generator)
        return next_tok[:, None], cache

    return serve_step


def make_prefill(cfg: ArchConfig, recipe: Recipe, *, plan=None):
    """Returns prefill(params, batch) -> the last position's logits (B, V):
    the training forward without the loss, on ``forward``'s batch (the
    tokens, and a frontend's 'prefix' or an encoder-decoder's
    'enc_input')."""

    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = forward(cfg, recipe, params, batch, compute_loss=False,
                            plan=None if plan is None else
                            plan.for_serving())
        return logits[:, -1, :]

    return prefill
