"""olmoe-1b-7b — fine-grained sparse MoE [arXiv:2409.02060].

16L, d_model=2048, 16 heads (kv=16), d_ff=1024 per expert, 64 experts top-8,
vocab=50304.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
    kv_banks=8,
))
