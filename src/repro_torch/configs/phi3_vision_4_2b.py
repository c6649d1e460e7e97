"""phi-3-vision-4.2b — phi3-mini backbone + CLIP vision stub
[hf:microsoft/Phi-3-vision-128k-instruct].

32L, d_model=3072, 32 heads (kv=32 MHA), d_ff=8192, vocab=32064. The CLIP
frontend is a STUB: input_specs() provides precomputed patch embeddings
(B, 576, 3072) that occupy the sequence prefix.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32064,
    frontend="vision_stub",
    n_patches=576,
    kv_banks=8,
))
