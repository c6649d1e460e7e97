"""mamba2-2.7b — attention-free SSD (state-space duality) [arXiv:2405.21060].

64L, d_model=2560, ssm_state=128, expand=2 (d_inner=5120, 80 heads of
headdim 64), vocab=50280, no MLP (d_ff=0). O(1) decode state: a conv tail
and an f32 (H, P, N) state per layer; the vocab embedding uses the coded
layout.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    coded_embedding=True,
))
