"""Architecture configuration schema + shape grid.

A copy of ``repro.configs.base`` (the port imports nothing of the JAX
package).  One ``ArchConfig`` per ported architecture lives in
``configs/<id>.py``; ``reduced()`` derives the CPU smoke-test variant.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int                      # dense-MLP hidden (per gate half if gated)
    vocab: int
    act: str = "swiglu"            # 'swiglu' | 'geglu' | 'gelu' | 'relu'
    norm: str = "rmsnorm"          # 'rmsnorm' | 'layernorm'
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    # layer-kind pattern, cycled over depth: 'global' | 'local' | 'ssm' | 'hybrid'
    pattern: Tuple[str, ...] = ("global",)
    window: int = 4096
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0      # DeepSeek-style always-on experts
    n_dense_layers: int = 0        # dense-MLP prologue layers (DeepSeek)
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / hymba) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # --- encoder-decoder / frontends ---
    encdec: bool = False
    n_enc_layers: int = 0
    frontend: str = "none"         # 'none' | 'audio' | 'vision'
    frontend_len: int = 0          # stub prefix length (patch/frame embeds)
    tie_embeddings: bool = False
    # --- parallelism / memory plan ---
    fsdp: bool = False             # shard param dim0 over 'data' too
    attn_tp: bool = True           # TP attention (requires n_heads % tp == 0)
    grad_accum: int = 1            # microbatching (memory fit at train_4k)
    # activation-residency policy (train/memory.py MemoryPlan): 'none' |
    # 'full' | 'fp8_resident' | 'pair' (a bool normalizes to 'full'/'none')
    remat_policy: str = "full"
    # long_500k applicability (sub-quadratic rule, DESIGN.md §6)
    subquadratic: bool = False

    def __post_init__(self):
        if isinstance(self.remat_policy, bool):   # legacy remat=True/False
            object.__setattr__(self, "remat_policy",
                               "full" if self.remat_policy else "none")

    @property
    def remat(self) -> bool:
        """Legacy read alias: whether ANY rematerialization is active."""
        return self.remat_policy != "none"

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def gate_factor(self) -> int:
        return 2 if self.act in ("swiglu", "geglu") else 1

    def n_params(self) -> int:
        """Approximate parameter count (embedding + layers)."""
        D, hd = self.d_model, self.head_dim
        emb = self.vocab_padded * D * (1 if self.tie_embeddings else 2)
        per_attn = D * (self.n_heads + 2 * self.n_kv) * hd + self.n_heads * hd * D
        g = self.gate_factor
        per_dense = D * self.d_ff * g + self.d_ff * D
        per_moe = (self.n_experts * (D * self.d_ff_expert * g +
                                     self.d_ff_expert * D) + D * self.n_experts)
        if self.n_shared_experts:
            per_moe += (D * self.n_shared_experts * self.d_ff_expert * g +
                        self.n_shared_experts * self.d_ff_expert * D)
        per_ssm = 0
        if self.ssm_state:
            di, ng, hs = self.d_inner, 1, self.ssm_heads
            per_ssm = (D * (2 * di + 2 * ng * self.ssm_state + hs)
                       + di * D + self.ssm_conv * (di + 2 * self.ssm_state))
        n = emb
        kinds = [self.pattern[i % len(self.pattern)] for i in range(self.n_layers)]
        for i, kind in enumerate(kinds):
            if kind == "ssm":
                n += per_ssm
                continue
            n += per_attn if kind in ("global", "local") else per_attn + per_ssm
            if self.moe and i >= self.n_dense_layers:
                n += per_moe
            elif self.d_ff:
                n += per_dense
        if self.encdec:
            n += self.n_enc_layers * (per_attn + per_dense)
            n += self.n_layers * per_attn  # decoder cross-attention
        return n

    def active_params(self) -> int:
        """Activated parameters per token (MoE top-k accounting)."""
        if not self.moe:
            return self.n_params()
        full = self.n_params()
        D, g = self.d_model, self.gate_factor
        per_e = D * self.d_ff_expert * g + self.d_ff_expert * D
        n_moe_layers = self.n_layers - self.n_dense_layers
        inactive = n_moe_layers * (self.n_experts - self.top_k) * per_e
        return full - inactive

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant: same family, tiny dims."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            n_dense_layers=min(self.n_dense_layers, 1),
            d_model=256,
            n_heads=4, n_kv=min(self.n_kv, 2) if self.n_kv < self.n_heads else 4,
            head_dim=64,
            d_ff=256 if self.d_ff else 0,
            d_ff_expert=128 if self.moe else 0,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            vocab=512,
            window=64,
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            frontend_len=8 if self.frontend != "none" else 0,
            fsdp=False, grad_accum=1,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig):
    """The shape cells defined for this arch (DESIGN.md §6 skip rules)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out
