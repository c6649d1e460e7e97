"""granite-20b (code) — llama-arch dense decoder, MQA (kv=1) [arXiv:2405.04324].

52L, d_model=6144, 48 heads (kv=1), d_ff=24576 (=4d, plain GELU MLP — the
non-gated form matches the 20B parameter count), vocab=49152.
kv=1: all 48 query heads read the one kv head (G = 48 in decode
attention).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv=1,
    d_ff=24576,
    vocab=49152,
    mlp_gated=False,
    act="gelu",
    norm="layernorm",
    qkv_bias=True,
    kv_banks=8,
))
