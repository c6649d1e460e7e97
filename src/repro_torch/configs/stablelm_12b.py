"""stablelm-12b — dense GQA decoder [hf:stabilityai/stablelm family].

40L, d_model=5120, 32 heads (GQA kv=8), d_ff=13824, vocab=100352 (coded
embedding candidate).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv=8,
    d_ff=13824,
    vocab=100352,
    coded_embedding=True,
    kv_banks=8,
))
