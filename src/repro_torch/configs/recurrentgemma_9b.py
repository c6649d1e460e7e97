"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention 1:2
[arXiv:2402.19427].

38L with repeating (rec, rec, local-attn) pattern (26 recurrent + 12 local
attention layers), d_model=4096, 16 heads (kv=1 MQA) on the attention
layers, d_ff=12288, local window 2048, vocab=256000 with the coded
embedding. O(1) recurrent state + a windowed attention ring.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    act="gelu",
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    coded_embedding=True,
    kv_banks=4,
))
