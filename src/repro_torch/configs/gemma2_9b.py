"""Gemma2-9B [arXiv:2408.00118]: alternating local:global (window 4096),
attn logit softcap 50, final softcap 30, GeGLU. Sliding-window dominant ->
long_500k applies (global layers read the full cache; reported as the
dominant memory term)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2_9b", n_layers=42, d_model=3584, n_heads=16, n_kv=8,
    head_dim=256, d_ff=14336, vocab=256000, act="geglu",
    pattern=("local", "global"), window=4096,
    attn_softcap=50.0, final_softcap=30.0, rope_theta=1e4,
    tie_embeddings=True, subquadratic=True, fsdp=True, grad_accum=1,
)
