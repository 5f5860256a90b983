"""LLaVA-NeXT-34B [hf:llava-hf, unverified]: Yi/NH2-34B text backbone with
anyres vision tiling; the vision tower + projector are a stub supplying
precomputed patch embeddings (2880 = 5 tiles x 576)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava_next_34b", n_layers=60, d_model=7168, n_heads=56, n_kv=8,
    head_dim=128, d_ff=20480, vocab=64000, act="swiglu",
    rope_theta=5e6, frontend="vision", frontend_len=2880,
    attn_tp=False,  # 56 % 16 != 0
    fsdp=True, grad_accum=1,
)
