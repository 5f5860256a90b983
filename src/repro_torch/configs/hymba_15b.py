"""Hymba-1.5B [arXiv:2411.13676]: parallel attention + mamba heads in every
layer (fused hybrid head), GQA 25H/5KV, SwiGLU MLP.  Meta-tokens are
omitted (noted in DESIGN.md).  Hybrid -> long_500k applies."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba_15b", n_layers=32, d_model=1600, n_heads=25, n_kv=5,
    head_dim=64, d_ff=5504, vocab=32001, act="swiglu", pattern=("hybrid",),
    ssm_state=16, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    rope_theta=1e4, tie_embeddings=True, subquadratic=True,
    attn_tp=False,  # 25 heads not divisible by the model axis
    grad_accum=1,
)
