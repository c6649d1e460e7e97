"""qwen2.5-3b — dense GQA decoder with QKV bias [hf:Qwen/Qwen2.5 family].

36L, d_model=2048, 16 heads (GQA kv=2), d_ff=11008, vocab=151936 (large,
tied) — the big vocab makes it a coded-embedding arch.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv=2,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    coded_embedding=True,
    kv_banks=8,
))
