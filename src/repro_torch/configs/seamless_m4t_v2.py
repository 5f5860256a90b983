"""SeamlessM4T-large-v2 [arXiv:2308.11596]: encoder-decoder backbone (the
speech frontend is a stub providing precomputed frame embeddings), MHA,
ReLU FFN, vocab 256206 (padded to 256256)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless_m4t_v2", n_layers=24, d_model=1024, n_heads=16, n_kv=16,
    head_dim=64, d_ff=8192, vocab=256206, act="relu", norm="layernorm",
    rope_theta=0.0,  # learned/sinusoidal in the original; stub uses none
    encdec=True, n_enc_layers=24, frontend="audio", frontend_len=0, fsdp=True,
    grad_accum=1,
)
