"""yi-6b — llama-arch dense GQA decoder [arXiv:2403.04652].

32L, d_model=4096, 32 heads (GQA kv=4), d_ff=11008, vocab=64000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5_000_000.0,
    kv_banks=8,
))
