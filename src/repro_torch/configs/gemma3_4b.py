"""Gemma3-4B [unverified]: 5 local : 1 global pattern, window 1024, GeGLU,
qk-norm, head_dim 256 decoupled from d_model, 262k vocab, 128k context.
Sub-quadratic (sliding-window dominant) -> long_500k applies."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_4b", n_layers=34, d_model=2560, n_heads=8, n_kv=4,
    head_dim=256, d_ff=10240, vocab=262144, act="geglu", qk_norm=True,
    rope_theta=1e6, pattern=("local", "local", "local", "local", "local",
                             "global"),
    window=1024, tie_embeddings=True, subquadratic=True, fsdp=True,
    attn_tp=False,  # 8 heads < 16-wide model axis
    grad_accum=1,
)
