"""whisper-tiny — encoder-decoder audio transformer [arXiv:2212.04356].

4L encoder + 4L decoder, d_model=384, 6 heads (kv=6), d_ff=1536,
vocab=51865. The conv audio frontend is a stub: callers give precomputed
frame embeddings (B, 1500, 384). LayerNorm, GELU, ungated MLP, QKV bias;
learned positions in the decoder, sinusoidal ones in the encoder.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_ff=1536,
    vocab=51865,
    mlp_gated=False,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    pos="learned",
    enc_layers=4,
    enc_frames=1500,
    frontend="audio_stub",
    kv_banks=4,
))
