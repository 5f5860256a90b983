"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]: dense MHA (kv==heads), QKV bias,
SwiGLU, RMSNorm, huge vocab (151936)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen15_05b", n_layers=24, d_model=1024, n_heads=16, n_kv=16,
    head_dim=64, d_ff=2816, vocab=151936, act="swiglu", qkv_bias=True,
    rope_theta=1e6, tie_embeddings=True, grad_accum=1,
)
