"""mixtral-8x7b — sparse MoE decoder with SWA [arXiv:2401.04088].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336 per expert, 8 experts
top-2, sliding window 4096, vocab=32000. SWA makes decode state O(window):
the server keeps it in the ring cache, not the page pool.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=32000,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    kv_banks=8,
))
