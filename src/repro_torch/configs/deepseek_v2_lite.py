"""DeepSeek-V2-Lite 16B (the paper's convergence-validation model, Fig. 6):
27 layers, 64 routed experts top-6 + 2 shared, first layer dense.
MLA is simplified to GQA (the paper's contribution is MoE-side; DESIGN.md
§7).  Dense d_ff 10944 -> 10880 (128-aligned)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_v2_lite", n_layers=27, d_model=2048, n_heads=16, n_kv=16,
    head_dim=128, d_ff=10880, vocab=102400, act="swiglu",
    rope_theta=1e4, moe=True, n_experts=64, top_k=6, d_ff_expert=1408,
    n_shared_experts=2, n_dense_layers=1, grad_accum=1,
)
