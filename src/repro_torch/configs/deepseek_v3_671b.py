"""DeepSeek-V3 671B (the paper's efficiency-evaluation model, Tables 2/3):
61 layers, 256 routed experts top-8 + 1 shared, 3 dense prologue layers.
MLA simplified to GQA 128H/16KV (DESIGN.md §7)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_v3_671b", n_layers=61, d_model=7168, n_heads=128, n_kv=16,
    head_dim=128, d_ff=18432, vocab=129280, act="swiglu",
    rope_theta=1e4, moe=True, n_experts=256, top_k=8, d_ff_expert=2048,
    n_shared_experts=1, n_dense_layers=3, fsdp=True, grad_accum=1,
)
