"""StarCoder2-15B [arXiv:2402.19173]: dense GQA, RoPE, GELU MLP, LayerNorm
with biases, sliding-window 4k is NOT used at 15B scale (full attention)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2_15b", n_layers=40, d_model=6144, n_heads=48, n_kv=4,
    head_dim=128, d_ff=24576, vocab=49152, act="gelu", norm="layernorm",
    qkv_bias=True, rope_theta=1e5, pattern=("global",),
    fsdp=True, grad_accum=1,
)
