"""Mamba2-2.7B [arXiv:2405.21060]: pure SSD (state-space duality), 64 mixer
layers, no attention, no MLP, d_state=128, headdim=64.  Attention-free ->
long_500k applies (O(1) state decode)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2_27b", n_layers=64, d_model=2560, n_heads=0, n_kv=0,
    head_dim=0, d_ff=0, vocab=50280, pattern=("ssm",),
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    rope_theta=0.0, tie_embeddings=True, subquadratic=True, attn_tp=False,
    grad_accum=1,
)
